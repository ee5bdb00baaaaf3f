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
// arithmetic is some 20 operations a pixel. The rectify at 640x480 onto
// 600x440 reads the two maps and writes the output (12 bytes a pixel) and
// reads the raw frame once: 1.40 us.
//
// The pyramid's design (the second; the first, a block per 32x32 tile of
// level 0 that built every level in shared memory and wrote each pixel as
// four scalar stores, ran at 22% of the bound). One launch of two kinds
// of blocks of 256 threads:
//   * level-0 blocks, the bulk of the bytes (75% of them at 4 levels): a
//     quad of four pixels of a row a thread, read from the frame (one
//     32-bit word of a uint8 frame, 8 bytes of a uint16 one, a float4 of
//     a float one per row where the four are on the image and aligned;
//     three rows and the pixel either side) and written at once, with no
//     barrier. A warp's 32 quads are 128 consecutive pixels, so it stages
//     their (I, dx, dy) in shared memory and writes the 1,536 bytes as 96
//     consecutive float4 (the stores of the first design, three 4-byte
//     stores a pixel at a 12-byte stride, cost twice the time); each
//     thread writes its absSquaredGrad as one float4.
//   * coarse blocks, one per kTileX x kTileY (64x32) tile of level 0
//     (every side a multiple of 2^(L-1), so that every level's tile is
//     whole; the plan is ldso_pyramid_plan's): levels 1 .. L-1. The
//     block forms level 1's tile and halo (2^(L-2) pixels) from the
//     frame, then per level, behind one barrier, writes the level (a
//     quad a thread, through the warp's staging where the level's tile
//     rows are at least 32 pixels wide) and forms the next level's
//     region in shared memory.
// A template per level count makes every region's side and offset a
// compile-time constant, so the index math is shifts and multiplies.
// Nothing is summed across blocks. The coarse blocks come first in the
// grid, so their chain of barriers starts while the level-0 blocks run.
// The rectify is the first design's (one thread a pixel; its reads are
// gathers of the raw image, L2-resident at a camera's size): the designs
// tried beside it (two and four pixels a thread with vector loads and
// stores, the response table staged in shared memory, gathers without
// the early return of an invalid pixel) were all slower on the card
// (PERF.md section 6).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxPyrLevels = 6;     // cuda_kernels.PYRAMID_MAX_LEVELS
// the coarse tile of level 0 (64x32: whole tiles of every level count up
// to kMaxPyrLevels; a 32x16 one measured the same at 4 levels) and the
// threads of a pyramid block, coarse or level 0
constexpr int kTileX = 64, kTileY = 32;
constexpr int kPyrThreads = 256;
static_assert(kTileX % (1 << (kMaxPyrLevels - 1)) == 0 &&
                  kTileY % (1 << (kMaxPyrLevels - 1)) == 0,
              "every level's tile must be whole");
constexpr int kRectThreads = 256;    // rectify: one pixel a thread

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
  int dtype;
  bool vec_in;               // the frame's base 16-byte aligned
  bool vec_out[kMaxLevels];  // level l's dI and abs_grad 16-byte aligned
};

// The coarse blocks' geometry: L levels, a kTileX x kTileY tile of level
// 0 and a halo of 2^(L-1) pixels around it; level l's region (l >= 1)
// in shared memory is the tile and halo halved l times, the regions one
// after another from level 1 on (level 0's is never stored).
template <int L>
struct Geo {
  static constexpr int kHalo = 1 << (L - 1);
  static constexpr int kThreads = kPyrThreads;
  __host__ __device__ static constexpr int rx(int l) {
    return (kTileX + 2 * kHalo) >> l;
  }
  __host__ __device__ static constexpr int ry(int l) {
    return (kTileY + 2 * kHalo) >> l;
  }
  __host__ __device__ static constexpr int off(int l) {
    return l <= 1 ? 0 : off(l - 1) + rx(l - 1) * ry(l - 1);
  }
};

__device__ __forceinline__ float intensity(const PyrArgs& a, int i) {
  if (a.dtype == kU8) return static_cast<float>(
      __ldg(static_cast<const uint8_t*>(a.img) + i));
  if (a.dtype == kU16) return static_cast<float>(
      __ldg(static_cast<const uint16_t*>(a.img) + i)) * 0.00390625f;
  return __ldg(static_cast<const float*>(a.img) + i);
}

// Four pixels of the frame from (y, x) on: one vector load where the four
// are on the image and aligned, else one at a time with 0 off the image.
__device__ __forceinline__ float4 quad_in(const PyrArgs& a, int y, int x) {
  const int H = a.H[0], W = a.W[0];
  const bool row_in = y >= 0 && y < H;
  const int o = y * W + x;
  if (row_in && x >= 0 && x + 3 < W && a.vec_in && (o & 3) == 0) {
    if (a.dtype == kU8) {
      const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(
          static_cast<const uint8_t*>(a.img) + o));
      return make_float4(static_cast<float>(w & 0xffu),
                         static_cast<float>((w >> 8) & 0xffu),
                         static_cast<float>((w >> 16) & 0xffu),
                         static_cast<float>(w >> 24));
    }
    if (a.dtype == kU16) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(
          static_cast<const uint16_t*>(a.img) + o));
      return make_float4(static_cast<float>(w.x & 0xffffu) * 0.00390625f,
                         static_cast<float>(w.x >> 16) * 0.00390625f,
                         static_cast<float>(w.y & 0xffffu) * 0.00390625f,
                         static_cast<float>(w.y >> 16) * 0.00390625f);
    }
    return __ldg(reinterpret_cast<const float4*>(
        static_cast<const float*>(a.img) + o));
  }
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = (row_in && x + k >= 0 && x + k < W) ? intensity(a, o + k) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The differences and absSquaredGrad of four pixels of an H x W level
// from (y, x) on: c[0..5] the row at x - 1 .. x + 4, u[0..3] and d[0..3]
// the rows above and below at x .. x + 3.
__device__ __forceinline__ void quad_grad(const PyrArgs& a, int y, int x,
                                          int H, int W, const float* c,
                                          const float* u, const float* d,
                                          float* dx, float* dy, float* g) {
  const bool rows_in = y > 0 && y < H - 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float ddx = 0.0f, ddy = 0.0f;
    if (rows_in && x + k > 0 && x + k < W - 1) {
      ddx = 0.5f * (c[k + 2] - c[k]);
      ddy = 0.5f * (d[k] - u[k]);
    }
    if (fabsf(ddx) > 255.0f) ddx = 0.0f;
    if (fabsf(ddy) > 255.0f) ddy = 0.0f;
    float gg = __fmaf_rn(ddx, ddx, ddy * ddy);
    if (a.bgrad != nullptr) {
      const float ri = rintf(c[k + 1]);
      const int t = (ri < 5.0f || isnan(ri)) ? 5
                    : (ri > 250.0f ? 250 : static_cast<int>(ri));
      const float gw = __ldg(a.bgrad + t);
      gg = gg * (gw * gw);
    }
    dx[k] = ddx;
    dy[k] = ddy;
    g[k] = gg;
  }
}

// The writes of four pixels of level m from (y, x) on, one at a time
// (the pixels on the level only).
__device__ __forceinline__ void quad_scalar_out(const PyrArgs& a, int m,
                                                int o, int x, const float* c,
                                                const float* dx,
                                                const float* dy,
                                                const float* g) {
  const int W = a.W[m];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (x + k >= W) break;
    a.dI[m][3 * (o + k)] = c[k + 1];
    a.dI[m][3 * (o + k) + 1] = dx[k];
    a.dI[m][3 * (o + k) + 2] = dy[k];
    a.ag[m][o + k] = g[k];
  }
}

// One quad of level m per lane of a warp (every lane calls it): a quad
// that is whole on the level and 16-byte aligned (`ok`) has its (I, dx,
// dy) staged in the warp's 96 float4 of `st` and written by the warp so
// that neighbouring lanes write neighbouring float4 (its absSquaredGrad
// one float4 by its lane); any other live quad is written a pixel at a
// time by its lane.
__device__ __forceinline__ void warp_quad_out(const PyrArgs& a, int m,
                                              float4* st, bool live, int o,
                                              int x, const float* c,
                                              const float* dx,
                                              const float* dy,
                                              const float* g) {
  const int lane = threadIdx.x & 31;
  const bool ok = live && x + 3 < a.W[m] && a.vec_out[m] && (o & 3) == 0;
  if (ok) {
    st[3 * lane] = make_float4(c[1], dx[0], dy[0], c[2]);
    st[3 * lane + 1] = make_float4(dx[1], dy[1], c[3], dx[2]);
    st[3 * lane + 2] = make_float4(dy[2], c[4], dx[3], dy[3]);
    *reinterpret_cast<float4*>(a.ag[m] + o) =
        make_float4(g[0], g[1], g[2], g[3]);
  } else if (live) {
    quad_scalar_out(a, m, o, x, c, dx, dy, g);
  }
  __syncwarp();
  float4* dI4 = reinterpret_cast<float4*>(a.dI[m]);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int k = 32 * j + lane, src = k / 3;
    const int os = __shfl_sync(0xffffffffu, o, src);
    const bool oks = __shfl_sync(0xffffffffu, ok, src);
    if (oks) dI4[3 * (os >> 2) + (k - 3 * src)] = st[k];
  }
  __syncwarp();
}

// A level-0 block: one quad of four pixels of a row a thread, read from
// the frame (three rows, the middle one a pixel wider on each side) and
// written at once (warp_quad_out: where W is a multiple of 4, a warp's 32
// quads are 128 consecutive pixels and it writes their 1,536 bytes of dI
// as 96 consecutive float4); no barrier but the warp's own.
template <int T>
__device__ __forceinline__ void level0_block(const PyrArgs& a, float4* st,
                                             int b) {
  const int H = a.H[0], W = a.W[0];
  const int qw = (W + 3) / 4;
  const int q = b * T + threadIdx.x;
  const int y = q / qw, x = (q - y * qw) * 4;
  const bool live = y < H;
  float c[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float u[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
    const float4 mid = quad_in(a, y, x);
    if (y > 0 && y < H - 1) {
      const float4 up = quad_in(a, y - 1, x), dn = quad_in(a, y + 1, x);
      u[0] = up.x, u[1] = up.y, u[2] = up.z, u[3] = up.w;
      d[0] = dn.x, d[1] = dn.y, d[2] = dn.z, d[3] = dn.w;
    }
    c[0] = x > 0 ? intensity(a, y * W + x - 1) : 0.0f;
    c[1] = mid.x, c[2] = mid.y, c[3] = mid.z, c[4] = mid.w;
    c[5] = x + 4 < W ? intensity(a, y * W + x + 4) : 0.0f;
  }
  float dx[4], dy[4], g[4];
  quad_grad(a, y, x, H, W, c, u, d, dx, dy, g);
  warp_quad_out(a, 0, st, live, y * W + x, x, c, dx, dy, g);
}

// A coarse block's level-1 region, formed from the frame: pixel (r, c)
// the mean of level 0's (2r .. 2r + 1, 2c .. 2c + 1), 0 off level 1; two
// pixels an item, from a quad of each of the two rows.
template <int L>
__device__ __forceinline__ void level1_region(const PyrArgs& a, float* dst,
                                              int tx0, int ty0) {
  using G = Geo<L>;
  constexpr int RX = G::rx(1), RY = G::ry(1);
  constexpr int NP = (RX + 1) / 2, N = RY * NP;
  constexpr int IT = (N + G::kThreads - 1) / G::kThreads;
  const int oy = (ty0 - G::kHalo) / 2, ox = (tx0 - G::kHalo) / 2;
  const int H = a.H[1], W = a.W[1];
#pragma unroll
  for (int j = 0; j < IT; ++j) {
    const int i = threadIdx.x + j * G::kThreads;
    if (N % G::kThreads != 0 && i >= N) break;
    const int r = i / NP, cc = (i - r * NP) * 2;
    const int y = oy + r, x = ox + cc;
    const bool row = y >= 0 && y < H;
    const bool on0 = row && x >= 0 && x < W;
    const bool on1 = row && x + 1 >= 0 && x + 1 < W;
    float v0 = 0.0f, v1 = 0.0f;
    if (on0 || on1) {
      const float4 p = quad_in(a, 2 * y, 2 * x);
      const float4 q = quad_in(a, 2 * y + 1, 2 * x);
      if (on0) v0 = ((p.x + p.y) + (q.x + q.y)) * 0.25f;
      if (on1) v1 = ((p.z + p.w) + (q.z + q.w)) * 0.25f;
    }
    dst[r * RX + cc] = v0;
    if (cc + 1 < RX) dst[r * RX + cc + 1] = v1;
  }
}

// Level l's region (l >= 2) from level l - 1's in shared memory: origins
// and sides halve exactly, so pixel (r, c) of level l is the mean of (2r
// .. 2r + 1, 2c .. 2c + 1) of level l - 1, all on the image where it is.
template <int L, int l>
__device__ __forceinline__ void downsample(const PyrArgs& a, float* sm,
                                           int tx0, int ty0) {
  using G = Geo<L>;
  constexpr int RX = G::rx(l), RY = G::ry(l);
  constexpr int SP = G::rx(l - 1), N = RX * RY;
  constexpr int IT = (N + G::kThreads - 1) / G::kThreads;
  const float* up = sm + G::off(l - 1);
  float* dst = sm + G::off(l);
  const int oy = (ty0 - G::kHalo) / (1 << l), ox = (tx0 - G::kHalo) / (1 << l);
  const int H = a.H[l], W = a.W[l];
#pragma unroll
  for (int j = 0; j < IT; ++j) {
    const int i = threadIdx.x + j * G::kThreads;
    if (N % G::kThreads != 0 && i >= N) break;
    const int r = i / RX, c = i - r * RX;
    const int y = oy + r, x = ox + c;
    float v = 0.0f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float* q = up + 2 * r * SP + 2 * c;
      v = ((q[0] + q[1]) + (q[SP] + q[SP + 1])) * 0.25f;
    }
    dst[i] = v;
  }
}

// A coarse block's level m (m >= 1) from its region: four pixels of a row
// an item where the level's tile rows hold whole quads (through
// warp_quad_out where its rows are at least 32 pixels wide, else each
// quad's own float4 stores), else one.
template <int L, int m>
__device__ __forceinline__ void outputs(const PyrArgs& a, const float* sm,
                                        float4* st, int tx0, int ty0) {
  using G = Geo<L>;
  constexpr int TW = kTileX >> m, TH = kTileY >> m, RX = G::rx(m);
  constexpr int HL = G::kHalo >> m;
  constexpr int V = TW % 4 == 0 ? 4 : 1;
  constexpr int NQ = TW / V, N = TH * NQ;
  constexpr int IT = (N + G::kThreads - 1) / G::kThreads;
  const float* lv = sm + G::off(m);
  const int y0 = ty0 >> m, x0 = tx0 >> m;
  const int H = a.H[m], W = a.W[m];
#pragma unroll
  for (int j = 0; j < IT; ++j) {
    const int i = threadIdx.x + j * G::kThreads;
    if constexpr (V == 4) {
      // the whole warp past the items leaves together
      if ((i & ~31) >= N) break;
      const int r = i / NQ, c0 = (i - r * NQ) * V;
      const int y = y0 + r, x = x0 + c0;
      const bool live = i < N && y < H && x < W;
      float c[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float u[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (i < N) {
        const float* p = lv + (r + HL) * RX + (c0 + HL);
#pragma unroll
        for (int k = 0; k < 6; ++k) c[k] = p[k - 1];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          u[k] = p[k - RX];
          d[k] = p[k + RX];
        }
      }
      float dx[4], dy[4], g[4];
      quad_grad(a, y, x, H, W, c, u, d, dx, dy, g);
      const int o = y * W + x;
      if constexpr (TW >= 32) {
        warp_quad_out(a, m, st, live, o, x, c, dx, dy, g);
      } else if (live) {
        if (x + 3 < W && a.vec_out[m] && (o & 3) == 0) {
          float4* d4 = reinterpret_cast<float4*>(a.dI[m] + 3 * o);
          d4[0] = make_float4(c[1], dx[0], dy[0], c[2]);
          d4[1] = make_float4(dx[1], dy[1], c[3], dx[2]);
          d4[2] = make_float4(dy[2], c[4], dx[3], dy[3]);
          *reinterpret_cast<float4*>(a.ag[m] + o) =
              make_float4(g[0], g[1], g[2], g[3]);
        } else {
          quad_scalar_out(a, m, o, x, c, dx, dy, g);
        }
      }
    } else {
      if (N % G::kThreads != 0 && i >= N) break;
      const int r = i / NQ, c0 = (i - r * NQ) * V;
      const int y = y0 + r, x = x0 + c0;
      if (y >= H || x >= W) continue;
      const float* p = lv + (r + HL) * RX + (c0 + HL);
      const float I = p[0];
      float dx = 0.0f, dy = 0.0f;
      if (x > 0 && x < W - 1 && y > 0 && y < H - 1) {
        dx = 0.5f * (p[1] - p[-1]);
        dy = 0.5f * (p[RX] - p[-RX]);
      }
      if (fabsf(dx) > 255.0f) dx = 0.0f;
      if (fabsf(dy) > 255.0f) dy = 0.0f;
      float g = __fmaf_rn(dx, dx, dy * dy);
      if (a.bgrad != nullptr) {
        const float ri = rintf(I);
        const int t = (ri < 5.0f || isnan(ri)) ? 5
                      : (ri > 250.0f ? 250 : static_cast<int>(ri));
        const float gw = __ldg(a.bgrad + t);
        g = g * (gw * gw);
      }
      const int o = y * W + x;
      a.dI[m][3 * o] = I;
      a.dI[m][3 * o + 1] = dx;
      a.dI[m][3 * o + 2] = dy;
      a.ag[m][o] = g;
    }
  }
}

// Step l of a coarse block: level l - 1's outputs, then level l's region;
// one barrier before the next step reads it.
template <int L, int l>
__device__ __forceinline__ void level_step(const PyrArgs& a, float* sm,
                                           float4* st, int tx0, int ty0) {
  outputs<L, l - 1>(a, sm, st, tx0, ty0);
  if constexpr (l < L) {
    downsample<L, l>(a, sm, tx0, ty0);
    __syncthreads();
    level_step<L, l + 1>(a, sm, st, tx0, ty0);
  }
}

// The launch's first `coarse` blocks build levels 1 .. L-1 of a tile of
// level 0 each (level 1 from the frame, the rest in shared
// memory); the others write level 0, a quad of four pixels a thread.
template <int L>
__global__ void __launch_bounds__(Geo<L>::kThreads)
    pyramid_kernel(const PyrArgs a, int coarse) {
  constexpr int T = Geo<L>::kThreads;
  extern __shared__ __align__(16) float sm[];
  // each warp's staging of its quads' dI (warp_quad_out)
  __shared__ float4 stage[T / 32][96];
  float4* st = stage[threadIdx.x >> 5];
  if (static_cast<int>(blockIdx.x) >= coarse) {
    level0_block<T>(a, st, blockIdx.x - coarse);
    return;
  }
  if constexpr (L > 1) {
    const int tiles_x = (a.W[0] + kTileX - 1) / kTileX;
    const int ty0 = (blockIdx.x / tiles_x) * kTileY;
    const int tx0 =
        (blockIdx.x - (blockIdx.x / tiles_x) * tiles_x) * kTileX;
    level1_region<L>(a, sm, tx0, ty0);
    __syncthreads();
    level_step<L, 2>(a, sm, st, tx0, ty0);
  }
}

using PyrKernel = void (*)(PyrArgs, int);

// the coarse blocks' dynamic shared memory: the regions of levels
// 1 .. L-1, as float32
template <int L>
constexpr int kPyrSmem = Geo<L>::off(L) * static_cast<int>(sizeof(float));
// no opt-in above the default 48 KB: the most levels' regions and the
// warps' staging fit under it
static_assert(kPyrSmem<kMaxPyrLevels> + (kPyrThreads / 32) * 96 * 16 <=
                  48 * 1024,
              "the pyramid's shared memory needs no opt-in");

PyrKernel pick(int levels, int* smem) {
  switch (levels) {
    case 1: *smem = kPyrSmem<1>; return pyramid_kernel<1>;
    case 2: *smem = kPyrSmem<2>; return pyramid_kernel<2>;
    case 3: *smem = kPyrSmem<3>; return pyramid_kernel<3>;
    case 4: *smem = kPyrSmem<4>; return pyramid_kernel<4>;
    case 5: *smem = kPyrSmem<5>; return pyramid_kernel<5>;
    case 6: *smem = kPyrSmem<6>; return pyramid_kernel<6>;
    default: return nullptr;
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

__global__ void __launch_bounds__(kRectThreads)
    rectify_kernel(const RectArgs a) {
  const int i = blockIdx.x * kRectThreads + threadIdx.x;
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

// The pyramid launch over an H x W frame with `levels` levels, into
// out[0..5]: the coarse tile's width and height, the coarse blocks (one a
// tile, first in the grid; none for one level), the level-0 blocks (a quad
// of four pixels of a row a thread), the threads of a block and the
// coarse blocks' dynamic shared memory in bytes. Returns 0, or -1 for a
// level count the library has no kernel for.
int ldso_pyramid_plan(int levels, int H, int W, int* out) {
  int smem = 0;
  if (pick(levels, &smem) == nullptr) return -1;
  out[0] = kTileX;
  out[1] = kTileY;
  out[2] = levels > 1 ? ((W + kTileX - 1) / kTileX) *
                            ((H + kTileY - 1) / kTileY)
                      : 0;
  out[3] = (H * ((W + 3) / 4) + kPyrThreads - 1) / kPyrThreads;
  out[4] = kPyrThreads;
  out[5] = smem;
  return 0;
}

// ptrs: img, b_grad (or null), then dI and abs_grad of each level; ints:
// levels, dtype (0 uint8, 1 float32, 2 uint16), then H and W of each
// level. One launch on `stream` of ldso_pyramid_plan's grid; returns its
// error (0 on success).
int ldso_pyramid(void* const* ptrs, const int* ints, void* stream) {
  PyrArgs a;
  const int levels = ints[0];
  a.dtype = ints[1];
  int smem = 0;
  const PyrKernel kernel = pick(levels, &smem);
  if (kernel == nullptr || ptrs[0] == nullptr ||
      (a.dtype != kU8 && a.dtype != kF32 && a.dtype != kU16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.img = ptrs[0];
  a.vec_in = (reinterpret_cast<uintptr_t>(a.img) & 15) == 0;
  a.bgrad = static_cast<const float*>(ptrs[1]);
  for (int l = 0; l < levels; ++l) {
    a.dI[l] = static_cast<float*>(ptrs[2 + 2 * l]);
    a.ag[l] = static_cast<float*>(ptrs[3 + 2 * l]);
    a.H[l] = ints[2 + 2 * l];
    a.W[l] = ints[3 + 2 * l];
    if (a.dI[l] == nullptr || a.ag[l] == nullptr || a.H[l] < 1 ||
        a.W[l] < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.vec_out[l] = ((reinterpret_cast<uintptr_t>(a.dI[l]) |
                     reinterpret_cast<uintptr_t>(a.ag[l])) & 15) == 0;
  }
  int plan[6];
  ldso_pyramid_plan(levels, a.H[0], a.W[0], plan);
  kernel<<<plan[2] + plan[3], plan[4], plan[5],
           static_cast<cudaStream_t>(stream)>>>(a, plan[2]);
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
  rectify_kernel<<<(a.n + kRectThreads - 1) / kRectThreads, kRectThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
