// K2: the frame's photometric front, hand-written for Hopper (sm_90a): the
// image pyramid with its gradients (one launch builds every level) and the
// dataset readers' rectification (one launch a frame).
//
// Replaces the JAX package's fused preprocessing program
// (ldso_tpu/ops/preprocess.py): `make_pyramid` (:124, over
// `_make_pyramid_impl` :79-89, `_downsample2` :70-76 and `_grad_and_abs`
// :41-67) and `preprocess_frame` (:132-182: the response LUT, the inverse
// vignette and the bilinear remap). It has no `pallas_call`: XLA fused it
// into one program. The port's plain versions are
// ldso_tpu_torch/ops/preprocess.make_pyramid_ref and rectify_ref, some
// 143 small aten kernels a 4-level pyramid on the card.
//
// Function of `pyramid` (FrameHessian::makeImages, FrameHessian.cc:44-113):
// level 0 is the frame as float32 intensities (uint8 as is, uint16 8.8
// fixed point times 1/256, float32 as is); level l is the 2x2 mean of level
// l - 1, (a00 + a01) + (a10 + a11) times 0.25, the last odd row and column
// dropped; at every level, per pixel, the central differences
// dx = 0.5 (I[x+1] - I[x-1]) and dy alike, 0 on the level's border and
// where |d| > 255, and absSquaredGrad fma(dx, dx, dy * dy), times gw * gw
// with gw = b_grad[clamp(round half to even (I), 5, 250)] when a b_grad
// table is given. Outputs: per level dI (H, W, 3) = (I, dx, dy) and
// abs_grad (H, W), float32, FramePyramid's layout.
//
// Function of `rectify` (Undistort.cc:358-470 and
// PhotometricUndistorter::processFrame, Undistort.cc:190-233): per output
// pixel, the raw image's four bilinear taps at (remap_x, remap_y) clamped
// to [0, w - 1.001] x [0, h - 1.001], each tap G[raw] for integer raw with
// a response table (raw as float otherwise) times the inverse vignette
// when there is one, blended as fxy v11 + (fy - fxy) v10 + (fx - fxy) v01
// + (1 - fx - fy + fxy) v00; 0 where remap_x < 0.
//
// The order of every operation is the plain versions', and this file is
// built with --fmad=false: the only contracted multiply-add is the
// `__fmaf_rn` of absSquaredGrad, where the plain version (and the JAX
// package's XLA:CPU) rounds once. On the same inputs kernel and plain
// version give the same bits. The box sum's order only matters for float
// frames: for uint8 ones every level is exact in float32.
//
// What bounds it on this card: bytes. At 640x480 with 4 levels the frame
// is read once (307,200 bytes as uint8) and every level's dI and abs_grad
// written once (16 bytes a pixel, 6.53 MB): 2.04 us at 3.35 TB/s. The
// arithmetic is some 20 operations a pixel.
//
// The design: one block per 32x32 tile of level 0 (a tile side that is a
// multiple of 2^(L-1), so that every level's tile is whole), 256 threads.
// The block loads its tile and a halo of 2^(L-1) pixels around it (0 off
// the image) into shared memory once, forms each coarser level's tile and
// halo there from the one above it (level l's halo is 2^(L-1-l) >= 1
// pixel, what its differences need), then writes each level's interior:
// the frame is read once plus the halos (2.25x at 4 levels, through L2),
// every output written once, nothing summed across blocks. 12 KB of shared
// memory at 4 levels; at 6 the halo needs 48 KB and more, which the launch
// opts in to. `rectify` is one thread per output pixel; its reads are
// gathers of the raw image (L2-resident at a camera's size).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kTile = 32;          // level-0 tile side, at most 6 levels
constexpr int kDefaultSmem = 48 * 1024;

constexpr int kU8 = 0;
constexpr int kF32 = 1;
constexpr int kU16 = 2;
constexpr int kI32 = 3;

struct PyrArgs {
  const void* img;
  const float* bgrad;        // nullptr: no b_grad reweighting
  float* dI[kMaxLevels];
  float* ag[kMaxLevels];
  int H[kMaxLevels], W[kMaxLevels];
  int levels, dtype, tile, halo;
};

__device__ __forceinline__ float intensity(const PyrArgs& a, int i) {
  if (a.dtype == kU8) return static_cast<float>(
      static_cast<const uint8_t*>(a.img)[i]);
  if (a.dtype == kU16) return static_cast<float>(
      static_cast<const uint16_t*>(a.img)[i]) * 0.00390625f;
  return static_cast<const float*>(a.img)[i];
}

// level l's region side in shared memory: its tile and halo
__device__ __forceinline__ int side(const PyrArgs& a, int l) {
  return (a.tile + 2 * a.halo) >> l;
}

__global__ void __launch_bounds__(kThreads) pyramid_kernel(const PyrArgs a) {
  extern __shared__ float sm[];
  const int ty0 = blockIdx.y * a.tile, tx0 = blockIdx.x * a.tile;
  float* lv[kMaxLevels];
  lv[0] = sm;
  for (int l = 1; l < a.levels; ++l) {
    const int s = side(a, l - 1);
    lv[l] = lv[l - 1] + s * s;
  }

  // level 0: the tile and its halo, 0 off the image
  {
    const int s = side(a, 0);
    const int oy = ty0 - a.halo, ox = tx0 - a.halo;
    for (int i = threadIdx.x; i < s * s; i += kThreads) {
      const int y = oy + i / s, x = ox + i % s;
      lv[0][i] = (y >= 0 && y < a.H[0] && x >= 0 && x < a.W[0])
                     ? intensity(a, y * a.W[0] + x)
                     : 0.0f;
    }
  }
  __syncthreads();
  // the coarser levels' regions from the level above: origins and sides
  // halve exactly, so pixel (r, c) of level l is the mean of (2r .. 2r + 1,
  // 2c .. 2c + 1) of level l - 1, all on the image where it is
  for (int l = 1; l < a.levels; ++l) {
    const int s = side(a, l), sp = side(a, l - 1);
    const int oy = (ty0 - a.halo) / (1 << l), ox = (tx0 - a.halo) / (1 << l);
    const float* up = lv[l - 1];
    for (int i = threadIdx.x; i < s * s; i += kThreads) {
      const int r = i / s, c = i % s;
      const int y = oy + r, x = ox + c;
      float v = 0.0f;
      if (y >= 0 && y < a.H[l] && x >= 0 && x < a.W[l]) {
        const float* q = up + 2 * r * sp + 2 * c;
        v = ((q[0] + q[1]) + (q[sp] + q[sp + 1])) * 0.25f;
      }
      lv[l][i] = v;
    }
    __syncthreads();
  }

  // every level's interior: differences, absSquaredGrad, the writes
  for (int l = 0; l < a.levels; ++l) {
    const int t = a.tile >> l, hl = a.halo >> l, s = side(a, l);
    const int y0 = ty0 >> l, x0 = tx0 >> l;
    const int H = a.H[l], W = a.W[l];
    float* dI = a.dI[l];
    float* ag = a.ag[l];
    for (int i = threadIdx.x; i < t * t; i += kThreads) {
      const int r = i / t, c = i % t;
      const int y = y0 + r, x = x0 + c;
      if (y >= H || x >= W) continue;
      const float* p = lv[l] + (r + hl) * s + (c + hl);
      const float I = p[0];
      float dx = 0.0f, dy = 0.0f;
      if (x > 0 && x < W - 1 && y > 0 && y < H - 1) {
        dx = 0.5f * (p[1] - p[-1]);
        dy = 0.5f * (p[s] - p[-s]);
      }
      if (fabsf(dx) > 255.0f) dx = 0.0f;
      if (fabsf(dy) > 255.0f) dy = 0.0f;
      float g = __fmaf_rn(dx, dx, dy * dy);
      if (a.bgrad != nullptr) {
        const float ri = rintf(I);
        const int k = (ri < 5.0f || isnan(ri)) ? 5
                      : (ri > 250.0f ? 250 : static_cast<int>(ri));
        const float gw = __ldg(a.bgrad + k);
        g = g * (gw * gw);
      }
      const int o = y * W + x;
      dI[3 * o] = I;
      dI[3 * o + 1] = dx;
      dI[3 * o + 2] = dy;
      ag[o] = g;
    }
  }
}

struct RectArgs {
  const void* raw;
  const float* G;            // nullptr: no response table
  const float* vig;          // nullptr: no vignette
  const float* rx;
  const float* ry;
  float* out;
  int dtype, n_g, h_org, w_org, n;
  float x_hi, y_hi;
};

// the photometrically corrected raw value at flat index i
__device__ __forceinline__ float linear(const RectArgs& a, int i) {
  float v;
  if (a.dtype == kF32) {
    v = static_cast<const float*>(a.raw)[i];
  } else {
    int k = a.dtype == kU8 ? static_cast<int>(
                                 static_cast<const uint8_t*>(a.raw)[i])
                           : static_cast<const int32_t*>(a.raw)[i];
    if (a.G != nullptr) {
      k = min(max(k, 0), a.n_g - 1);
      v = __ldg(a.G + k);
    } else {
      v = static_cast<float>(k);
    }
  }
  if (a.vig != nullptr) v = v * __ldg(a.vig + i);
  return v;
}

__global__ void __launch_bounds__(kThreads) rectify_kernel(const RectArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const float x = a.rx[i];
  if (!(x >= 0.0f)) {
    a.out[i] = 0.0f;
    return;
  }
  const float xs = fminf(fmaxf(x, 0.0f), a.x_hi);
  const float ys = fminf(fmaxf(a.ry[i], 0.0f), a.y_hi);
  const float x0 = floorf(xs), y0 = floorf(ys);
  const float fx = xs - x0, fy = ys - y0;
  const int idx = static_cast<int>(y0) * a.w_org + static_cast<int>(x0);
  const float v00 = linear(a, idx), v01 = linear(a, idx + 1);
  const float v10 = linear(a, idx + a.w_org);
  const float v11 = linear(a, idx + a.w_org + 1);
  const float fxy = fx * fy;
  float s = fxy * v11 + (fy - fxy) * v10;
  s = s + (fx - fxy) * v01;
  a.out[i] = s + (1.0f - fx - fy + fxy) * v00;
}

}  // namespace

extern "C" {

// The dynamic shared memory of a pyramid launch over `levels` levels:
// each level's region (the tile and its 2^(levels-1) halo, halved per
// level) as float32; 0 for a level count the kernel does not take.
int ldso_pyramid_smem(int levels) {
  if (levels < 1 || levels > 6) return 0;
  const int halo = 1 << (levels - 1);
  int floats = 0;
  for (int l = 0; l < levels; ++l) {
    const int s = (kTile + 2 * halo) >> l;
    floats += s * s;
  }
  return floats * static_cast<int>(sizeof(float));
}

// ptrs: img, b_grad (or null), then dI and abs_grad of each level; ints:
// levels, dtype (0 uint8, 1 float32, 2 uint16), then H and W of each
// level. One launch on `stream`; returns its error (0 on success).
int ldso_pyramid(void* const* ptrs, const int* ints, void* stream) {
  PyrArgs a;
  a.levels = ints[0];
  a.dtype = ints[1];
  const int smem = ldso_pyramid_smem(a.levels);
  if (smem == 0 || ptrs[0] == nullptr ||
      (a.dtype != kU8 && a.dtype != kF32 && a.dtype != kU16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.img = ptrs[0];
  a.bgrad = static_cast<const float*>(ptrs[1]);
  for (int l = 0; l < a.levels; ++l) {
    a.dI[l] = static_cast<float*>(ptrs[2 + 2 * l]);
    a.ag[l] = static_cast<float*>(ptrs[3 + 2 * l]);
    a.H[l] = ints[2 + 2 * l];
    a.W[l] = ints[3 + 2 * l];
    if (a.dI[l] == nullptr || a.ag[l] == nullptr || a.H[l] < 1 ||
        a.W[l] < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  a.halo = 1 << (a.levels - 1);
  a.tile = kTile;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.W[0] + kTile - 1) / kTile, (a.H[0] + kTile - 1) / kTile);
  pyramid_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: raw, G (or null), vignette (or null), remap_x, remap_y, out; ints:
// dtype (0 uint8, 1 float32, 3 int32), the table's length, h_org, w_org,
// the output's pixel count; floats: w_org - 1.001, h_org - 1.001 as
// float32. One launch on `stream`; returns its error (0 on success).
int ldso_rectify(void* const* ptrs, const int* ints, const float* floats,
                 void* stream) {
  RectArgs a;
  a.raw = ptrs[0];
  a.G = static_cast<const float*>(ptrs[1]);
  a.vig = static_cast<const float*>(ptrs[2]);
  a.rx = static_cast<const float*>(ptrs[3]);
  a.ry = static_cast<const float*>(ptrs[4]);
  a.out = static_cast<float*>(ptrs[5]);
  a.dtype = ints[0];
  a.n_g = ints[1];
  a.h_org = ints[2];
  a.w_org = ints[3];
  a.n = ints[4];
  a.x_hi = floats[0];
  a.y_hi = floats[1];
  if (a.raw == nullptr || a.rx == nullptr || a.ry == nullptr ||
      a.out == nullptr || a.n < 1 || a.h_org < 2 || a.w_org < 2 ||
      (a.dtype != kU8 && a.dtype != kF32 && a.dtype != kI32) ||
      (a.G != nullptr && (a.dtype == kF32 || a.n_g < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rectify_kernel<<<(a.n + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
