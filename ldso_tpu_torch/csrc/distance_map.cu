// Chamfer distance map for activation spacing, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `distance_transform_pallas` (body `_dist_kernel`)
// in ldso_tpu/ops/pallas_kernels.py, the rebuild of
// CoarseDistanceMap::growDistBFS (CoarseTracker.cc:724-812). It computes
// exactly the function of ldso_tpu_torch/ops/distance_map.py
// (distance_transform_ref): max_k - 1 min-plus relaxation sweeps over the
// (H, W) occupancy map, the 4-neighbourhood on every sweep and the
// diagonals added on odd sweeps, with sources only at interior pixels.
// Output: float32, 0 at occupied cells, k where first reached at sweep k,
// 1000.0 where unreachable.
//
// What bounds it: latency, not bytes or operations. The map is tiny
// (240 x 320 at 640 x 480 input, ~77 KB as bytes) and every sweep depends
// on the one before, so the work is a chain of short, barrier-separated
// stencil passes that can only run on one SM.
//
// Design: ONE block of 1024 threads keeps the whole map resident in
// dynamic shared memory as uint8 (255 = unreached), so no sweep touches
// device memory; sweeps are separated by __syncthreads(). Device memory is
// read once (the occupancy bytes) and written once (float32 widening, with
// 1000.0 for the sentinel). The update runs in place: only unreached cells
// (255) change, and a cell set to k in sweep k is not < k, so it cannot
// act as a source within the same sweep -- a reader sees either 255 or k,
// and both leave its own result unchanged. Hence in-place and
// double-buffered updates give identical maps. A map larger than a block's
// shared memory is refused by the Python wrapper.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr uint8_t kUnreached = 255;

__device__ __forceinline__ bool is_source(const uint8_t* d, int sy, int sx,
                                          int H, int W, int k) {
  // source pixel must be interior (the reference skips border frontier
  // pixels) and already reached before this sweep
  return sy >= 1 && sy <= H - 2 && sx >= 1 && sx <= W - 2 &&
         d[sy * W + sx] < k;
}

__global__ void __launch_bounds__(kThreads)
dist_kernel(const uint8_t* __restrict__ occ, float* __restrict__ out,
            int H, int W, int max_k) {
  extern __shared__ uint8_t d[];
  const int n = H * W;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    d[p] = occ[p] ? 0 : kUnreached;
  }
  __syncthreads();

  for (int k = 1; k < max_k; ++k) {
    const bool diag = (k & 1) != 0;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      if (d[p] != kUnreached) continue;
      const int y = p / W;
      const int x = p - y * W;
      bool hit = is_source(d, y, x - 1, H, W, k) ||
                 is_source(d, y, x + 1, H, W, k) ||
                 is_source(d, y - 1, x, H, W, k) ||
                 is_source(d, y + 1, x, H, W, k);
      if (!hit && diag) {
        hit = is_source(d, y - 1, x - 1, H, W, k) ||
              is_source(d, y - 1, x + 1, H, W, k) ||
              is_source(d, y + 1, x - 1, H, W, k) ||
              is_source(d, y + 1, x + 1, H, W, k);
      }
      if (hit) d[p] = static_cast<uint8_t>(k);
    }
    __syncthreads();
  }

  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const uint8_t v = d[p];
    out[p] = v == kUnreached ? 1000.0f : static_cast<float>(v);
  }
}

}  // namespace

extern "C" {

// Largest dynamic shared memory one block may opt into on `device`, in
// bytes (or a negative CUDA error code).
int ldso_distance_transform_max_smem(int device) {
  int bytes = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// occ: (H, W) uint8 (nonzero = occupied), out: (H, W) float32, both
// contiguous on the current device; launches on `stream` and returns the
// launch's cudaError_t (0 on success). 1 <= max_k <= 255 and H * W bytes
// must fit one block's shared memory; the wrapper checks both.
int ldso_distance_transform(const void* occ, void* out, int H, int W,
                            int max_k, void* stream) {
  const size_t smem = static_cast<size_t>(H) * static_cast<size_t>(W);
  cudaError_t err = cudaFuncSetAttribute(
      dist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dist_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(occ), static_cast<float*>(out), H, W,
      max_k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
