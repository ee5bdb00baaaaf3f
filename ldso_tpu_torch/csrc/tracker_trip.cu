// One trip of the coarse tracker's LM (warp, residual, 8x8 reduce),
// hand-written for Hopper (sm_90a).
//
// Replaces the fused XLA region that the JAX package evaluates once per LM
// trip: `_calc_res` followed by `_calc_gs` in ldso_tpu/frontend/tracker.py
// (:168-292; calcRes and calcGSSSE, CoarseTracker.cc:440-632). It has no
// `pallas_call`. It computes the function of the port's plain version,
// ldso_tpu_torch/frontend/tracker.tracker_trip_ref, for S sequences of B
// poses each, against one pyramid level:
//   * the warp p' = R K^-1 [x y 1] + t idepth, (u, v) = p'.xy / p'.z,
//     (Ku, Kv) = (fx u + cx, fy v + cy), new idepth = idepth / p'.z;
//   * ok = valid & Ku > 2 & Kv > 2 & Ku < w-3 & Kv < h-3 & new idepth > 0;
//   * (I, dx, dy) sampled bilinearly with ops/interp.bilinear's weight
//     factorisation and its W-1.001 clamp; ok &= isfinite(I);
//   * r = I - (a_rel color + b_rel), the Huber weight hw, saturation at
//     `cutoff` with max_energy = 2 huber cutoff - huber^2;
//   * stats = [E, numTerms, flowT, 0, flowRT, numSat / max(numTerms, 1)],
//     the flow sums (level 0 only) over every ok point, / (2 (n + 0.1));
//   * over the good points (ok and not saturated) the 8-column Jacobian J,
//     H = sum hw J J^T and b = sum hw J r, each / max(#good, 1) and scaled
//     by SCALE_XI_ROT, SCALE_XI_TRANS, SCALE_A, SCALE_B.
// A point that is not ok (or, for H and b, not good) adds nothing: it is
// skipped, never multiplied by 0, so a NaN it carries stays out. (The plain
// version forms H as (J w)^T J, so a masked point whose gradient is NaN
// turns its H NaN; the JAX package does the same.)
//
// What bounds it on this card: bytes, and at these sizes latency. The
// inputs are N points of 16 bytes and their mask byte, a few bytes of pose
// per member, and one (h, w, 3) float32 level that the gathers touch
// sparsely (3.7 MB at level 0 of 640x480, which stays in the 50 MB L2
// across the 316 trips of a track); the work is about 300 float
// operations per good point. The outputs are 78 floats per member. What
// is left is the two launches and the tree reductions.
//
// What the design does about it:
//  * Two passes with no float atomics, so every launch gives the same bits.
//    Pass 1 is a fixed grid of (chunk, member, sequence) blocks; each
//    block takes kChunk points, and each thread keeps the 50 sums of its
//    points in registers (H's upper triangle, b, E, the three counts, two
//    flow sums), then the block reduces them by warp shuffles and one
//    fixed-order pass over its warps and writes one partial slot. Pass 2,
//    one block per member, adds the chunks' slots in chunk order, divides,
//    scales, mirrors H and writes stats, H and b.
//  * A thread reads a point once (4 floats and the mask byte) and returns
//    at once for a masked or out-of-bounds one, before any gather: the
//    level's three channels are gathered at four taps only for in-bounds
//    points.
//  * No shared memory beyond the reduction's 8 x 50 floats, no allocation,
//    no synchronisation with the host: the wrapper allocates the partials
//    and the outputs with torch.empty, so a CUDA graph can capture it.
// Tensor cores, TMA and cp.async do not apply yet: the 8x8 outer products
// are 36 FMAs per point, and fusing the LM step around the reduction is a
// later redesign.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPointsPerThread = 2;
constexpr int kChunk = kThreads * kPointsPerThread;   // points per block
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 64;
// the sums of one partial slot
constexpr int kH = 0;         // 36: H's upper triangle, row-major
constexpr int kB = 36;        // 8
constexpr int kE = 44;
constexpr int kNum = 45;      // ok points
constexpr int kSat = 46;      // ok and saturated
constexpr int kGood = 47;     // ok and not saturated
constexpr int kFlowT = 48;
constexpr int kFlowRT = 49;
constexpr int kAcc = 50;
constexpr int kParams = 22;

struct Params {
  float fx, fy, cx, cy;
  float Ki[9];        // K^-1 of the level, row-major
  float huber;
  float scale[8];
};

// index of H[i][j], i <= j, in the row-major upper triangle
__host__ __device__ constexpr int tri(int i, int j) {
  return i * 8 - i * (i - 1) / 2 + (j - i);
}

__device__ __forceinline__ float sq(float x) { return x * x; }

__global__ void __launch_bounds__(kThreads)
trip_partials(const float* __restrict__ points, const uint8_t* __restrict__ valid,
              const float* __restrict__ dI, const float* __restrict__ T,
              const float* __restrict__ rel, const float* __restrict__ cutoff,
              const float* __restrict__ ref_aff, float* __restrict__ partial,
              int B, int N, int w, int h, int n_chunks, Params p,
              int compute_flow) {
  const int chunk = blockIdx.x;
  const int m = blockIdx.y;
  const int s = blockIdx.z;
  const int sb = s * B + m;

  // the member's pose, R K^-1, affine and cutoff (each thread its own copy:
  // a few broadcast loads)
  const float* Tm = T + static_cast<size_t>(sb) * 16;
  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i * 3 + j] = Tm[i * 4 + j];
    t[i] = Tm[i * 4 + 3];
  }
  float RKi[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      RKi[i * 3 + j] = R[i * 3 + 0] * p.Ki[0 * 3 + j] +
                       R[i * 3 + 1] * p.Ki[1 * 3 + j] +
                       R[i * 3 + 2] * p.Ki[2 * 3 + j];
    }
  }
  const float a_rel = rel[sb * 2 + 0];
  const float b_rel = rel[sb * 2 + 1];
  const float b0 = ref_aff[s * 2 + 1];
  const float cut = cutoff[sb];
  const float huber = p.huber;
  const float max_energy = 2.0f * huber * cut - huber * huber;
  const float wlim = static_cast<float>(w - 1.001);
  const float hlim = static_cast<float>(h - 1.001);
  const float umax = static_cast<float>(w - 3);
  const float vmax = static_cast<float>(h - 3);

  const float* P = points + static_cast<size_t>(s) * N * 4;
  const uint8_t* V = valid + static_cast<size_t>(s) * N;
  const float* img = dI + static_cast<size_t>(s) * h * w * 3;

  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;

#pragma unroll
  for (int q = 0; q < kPointsPerThread; ++q) {
    const int i = chunk * kChunk + q * kThreads + threadIdx.x;
    if (i >= N || V[i] == 0) continue;
    const float x = P[i * 4 + 0];
    const float y = P[i * 4 + 1];
    const float idep = P[i * 4 + 2];
    const float color = P[i * 4 + 3];

    const float tx = t[0] * idep, ty = t[1] * idep, tz = t[2] * idep;
    const float r0 = RKi[0] * x + RKi[1] * y + RKi[2];
    const float r1 = RKi[3] * x + RKi[4] * y + RKi[5];
    const float r2 = RKi[6] * x + RKi[7] * y + RKi[8];
    const float p0 = r0 + tx, p1 = r1 + ty, p2 = r2 + tz;
    const float u = p0 / p2;
    const float v = p1 / p2;
    const float Ku = p.fx * u + p.cx;
    const float Kv = p.fy * v + p.cy;
    const float nid = idep / p2;
    if (!(Ku > 2.0f && Kv > 2.0f && Ku < umax && Kv < vmax && nid > 0.0f)) {
      continue;
    }

    // bilinear (I, dx, dy): the taps of ops/interp.bilinear
    const float xc = fminf(fmaxf(Ku, 0.0f), wlim);
    const float yc = fminf(fmaxf(Kv, 0.0f), hlim);
    const float x0 = floorf(xc), y0 = floorf(yc);
    const float fx_ = xc - x0, fy_ = yc - y0;
    const float* t00 = img + (static_cast<size_t>(y0) * w + static_cast<size_t>(x0)) * 3;
    const float* t01 = t00 + 3;
    const float* t10 = t00 + static_cast<size_t>(w) * 3;
    const float* t11 = t10 + 3;
    const float dxdy = fx_ * fy_;
    const float w11 = dxdy, w10 = fy_ - dxdy, w01 = fx_ - dxdy;
    const float w00 = 1.0f - fx_ - fy_ + dxdy;
    const float I = w11 * t11[0] + w10 * t10[0] + w01 * t01[0] + w00 * t00[0];
    if (!isfinite(I)) continue;
    const float gx = w11 * t11[1] + w10 * t10[1] + w01 * t01[1] + w00 * t00[1];
    const float gy = w11 * t11[2] + w10 * t10[2] + w01 * t01[2] + w00 * t00[2];

    const float res = I - (a_rel * color + b_rel);
    const float abs_r = fabsf(res);
    const float hw = abs_r < huber ? 1.0f : huber / fmaxf(abs_r, 1e-12f);
    const bool sat = abs_r > cut;
    acc[kE] += sat ? max_energy : hw * res * res * (2.0f - hw);
    acc[kNum] += 1.0f;

    if (compute_flow) {
      // pure translation both ways, and the rotation with -t
      const float k0 = p.Ki[0] * x + p.Ki[1] * y + p.Ki[2];
      const float k1 = p.Ki[3] * x + p.Ki[4] * y + p.Ki[5];
      const float k2 = p.Ki[6] * x + p.Ki[7] * y + p.Ki[8];
      const float KuT = p.fx * (k0 + tx) / (k2 + tz) + p.cx;
      const float KvT = p.fy * (k1 + ty) / (k2 + tz) + p.cy;
      const float KuT2 = p.fx * (k0 - tx) / (k2 - tz) + p.cx;
      const float KvT2 = p.fy * (k1 - ty) / (k2 - tz) + p.cy;
      const float Ku3 = p.fx * (r0 - tx) / (r2 - tz) + p.cx;
      const float Kv3 = p.fy * (r1 - ty) / (r2 - tz) + p.cy;
      acc[kFlowT] += sq(KuT - x) + sq(KvT - y) + sq(KuT2 - x) + sq(KvT2 - y);
      acc[kFlowRT] += sq(Ku - x) + sq(Kv - y) + sq(Ku3 - x) + sq(Kv3 - y);
    }
    if (sat) {
      acc[kSat] += 1.0f;
      continue;
    }
    acc[kGood] += 1.0f;

    const float dxf = gx * p.fx;
    const float dyf = gy * p.fy;
    float J[8];
    J[0] = nid * dxf;
    J[1] = nid * dyf;
    J[2] = -nid * (u * dxf + v * dyf);
    J[3] = -(u * v * dxf + (1.0f + v * v) * dyf);
    J[4] = u * v * dyf + (1.0f + u * u) * dxf;
    J[5] = u * dyf - v * dxf;
    J[6] = a_rel * (b0 - color);
    J[7] = -1.0f;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float Jw = J[a] * hw;
#pragma unroll
      for (int c = a; c < 8; ++c) acc[kH + tri(a, c)] += Jw * J[c];
      acc[kB + a] += Jw * res;
    }
  }

  // block sum in a fixed order: a shuffle tree per warp, then the warps
  // in index order
  __shared__ float red[kWarps][kAcc];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    float x = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_down_sync(0xffffffffu, x, off);
    }
    if (lane == 0) red[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < kAcc) {
    float x = red[0][threadIdx.x];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) x += red[wi][threadIdx.x];
    partial[(static_cast<size_t>(sb) * n_chunks + chunk) * kAcc + threadIdx.x] = x;
  }
}

__global__ void __launch_bounds__(kFinishThreads)
trip_finish(const float* __restrict__ partial, float* __restrict__ stats,
            float* __restrict__ H, float* __restrict__ b, int n_chunks,
            Params p, int compute_flow) {
  const int sb = blockIdx.x;
  __shared__ float tot[kAcc];
  if (threadIdx.x < kAcc) {
    const float* src = partial + static_cast<size_t>(sb) * n_chunks * kAcc;
    float x = src[threadIdx.x];
    for (int c = 1; c < n_chunks; ++c) x += src[c * kAcc + threadIdx.x];
    tot[threadIdx.x] = x;
  }
  __syncthreads();
  const float n = fmaxf(tot[kGood], 1.0f);
  const int i = threadIdx.x >> 3, j = threadIdx.x & 7;
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  H[sb * 64 + threadIdx.x] = tot[kH + tri(lo, hi)] / n * p.scale[i] * p.scale[j];
  if (threadIdx.x < 8) {
    b[sb * 8 + threadIdx.x] = tot[kB + threadIdx.x] / n * p.scale[threadIdx.x];
  }
  if (threadIdx.x == 0) {
    const float num = tot[kNum];
    const float n_flow = 2.0f * (num + 0.1f);
    float* st = stats + sb * 6;
    st[0] = tot[kE];
    st[1] = num;
    st[2] = compute_flow ? tot[kFlowT] / n_flow : 0.0f;
    st[3] = 0.0f;
    st[4] = compute_flow ? tot[kFlowRT] / n_flow : 0.0f;
    st[5] = tot[kSat] / fmaxf(num, 1.0f);
  }
}

}  // namespace

extern "C" {

// points (S, N, 4) f32 [u, v, idepth, color], valid (S, N) uint8,
// dI (S, h, w, 3) f32, T (S, B, 4, 4) f32, rel (S, B, 2) f32 [a, b],
// cutoff (S, B) f32, ref_aff (S, 2) f32, all contiguous on the current
// device; partial: S * B * n_chunks * 50 floats of scratch, n_chunks =
// ceil(N / 512); outputs stats (S, B, 6), H (S, B, 8, 8), b (S, B, 8) f32.
// params (host): fx, fy, cx, cy, K^-1 (9, row-major), huber, the 8 scales.
// Launches both passes on `stream` and returns the first launch error
// (cudaError_t, 0 on success).
int ldso_tracker_trip(const void* points, const void* valid, const void* dI,
                      const void* T, const void* rel, const void* cutoff,
                      const void* ref_aff, void* partial, void* stats,
                      void* H, void* b, int S, int B, int N, int w, int h,
                      int n_chunks, const float* params, int compute_flow,
                      void* stream) {
  if (S < 1 || S > 65535 || B < 1 || B > 65535 || N < 1 || w < 7 || h < 7 ||
      n_chunks != (N + kChunk - 1) / kChunk || params == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  static_assert(sizeof(Params) == kParams * sizeof(float), "Params layout");
  std::memcpy(&p, params, sizeof(Params));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  trip_partials<<<dim3(n_chunks, B, S), kThreads, 0, st>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(dI), static_cast<const float*>(T),
      static_cast<const float*>(rel), static_cast<const float*>(cutoff),
      static_cast<const float*>(ref_aff), static_cast<float*>(partial), B, N,
      w, h, n_chunks, p, compute_flow);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  trip_finish<<<S * B, kFinishThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(stats),
      static_cast<float*>(H), static_cast<float*>(b), n_chunks, p,
      compute_flow);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
