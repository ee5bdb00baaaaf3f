// K6: the windowed BA's linearization, hand-written for Hopper (sm_90a).
// One launch per linearization of the window's (P, F) residual lattice,
// from ldso_tpu_torch/ops/cuda_kernels.ba_linearize.
//
// Replaces `linearize_all` (ldso_tpu/backend/ba.py:148) and
// `linearize_target` (:291) of the JAX package, each one XLA program with
// no `pallas_call`. Its plain version is the port's backend/ba.
// linearize_ref (and `_residual_core`), which on the card runs as some
// hundreds of small aten kernels over the lattice.
//
// Function: for every residual (p, f) of the lattice in `_lin_mask`
// (res_exist, the point valid, not linearized, the target frame valid) and,
// in the column mode, with f the target read from `tgt` on the card:
//   * the centre projection at the FEJ point through the (host, target)
//     precalc R0, t0: Jpdxi (2x6), Jpdc (2x4), Jpdd (2) and center_proj;
//   * the 8 pattern taps projected at the current state through KRKi, Kt,
//     each sampled bilinearly from the target's image (3 channels);
//   * the gradient and Huber weights, JIdx, JabF, resF and the energy,
//     wJI2 and the outlier test, the OOB test (sticky: a residual OOB
//     before stays OOB), the new state and energies.
// It writes the 10 fields, and copies every other residual's through. It
// also returns the energy sum of the lattice's `_lin_mask` residuals (the
// new energies; in the column mode the other columns' old ones).
//
// Every operation is the plain version's, in its order: the rows of a 3x3
// product as (m0 x + m1 y) + m2, then + t idepth; the 8-tap sums as the
// tree ((x0 + x1) + (x2 + x3)) + ((x4 + x5) + (x6 + x7)); a Python scalar
// over a tensor as its reciprocal times the scalar; the focal lengths as
// true divisors; torch's clamp, maximum and where as the same selections.
// This file is built with --fmad=false, so no multiply and add is
// contracted, and on the same inputs the two give the same bits. The
// energy sum's order is the plain version's (backend/ba.
// ordered_energy_sum): 32-residual warp trees, eight of them a
// 256-residual group by the same tree (padded with zeros to a warp), then
// the groups by one warp in group order; no float atomics.
//
// What bounds it on this card: bytes. At P = 2048, F = 8 a linearized
// residual reads its state (10 bytes) and writes 67 floats and an int (272
// bytes), any other reads and writes those 272 bytes, each point is read
// once (85 bytes) and the taps read their pixels (8 taps x 4 corners x 3
// channels): some 9 MB and 2.8 us at 3.35 TB/s on the main path's window
// (chip_smoke.lin_bound_ms counts the pixels a run's taps read). The
// arithmetic, some 650 float operations a linearized residual, is 0.1 us
// at 67 TFLOP/s.
//
// What the design does about that: eight lanes per residual, lane k on
// tap k, so the grid has 8 threads a residual: 512 blocks of 256 at the
// main path's window (S = 1), one wave at 64 registers (4 blocks an SM),
// each thread one tap's chain of projection, bilinear reads and weights.
// The tap sums (`sum8`) are xor shuffles over the eight lanes with masks
// 1, 2 and 4: float addition commutes, so each step's pair holds one value
// and the result is sum8's tree bit for bit. The per-residual work (the
// FEJ centre projection, Jpdxi, Jpdc, Jpdd, the states) is one
// instruction stream for the eight lanes (their loads one address a
// group), the same operations in the same order, and each lane writes
// its share of the results. The precalc's views (R0, t0, KRKi, b0) are
// read in place by their strides, so the wrapper copies nothing. A block
// is 32 residuals: the linearized ones' 10 fields are staged in shared
// memory and the block stores all of them coalesced, 16 bytes a thread,
// each 16-byte unit from the stage or, for the residuals not linearized
// here, from the input.
// The block's 32 energies are one warp tree of the energy sum; the last
// block to arrive (an integer counter from torch.zeros) forms the
// 256-residual groups' trees from eight such sums each and sums the
// groups in order. One barrier a block before its stores.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 8;
constexpr int kLanes = 8;                       // lanes a residual, one a tap
constexpr int kRes = 32;                        // residuals a block: a warp tree
constexpr int kBlock = kRes * kLanes;
constexpr int kGroup = 8;                       // blocks a group: LIN_BLOCK / 32
constexpr unsigned kFull = 0xffffffffu;
// the 10 fields: words a residual, and their offsets in the block's stage
// (in units of kRes words)
constexpr int kFields = 10;
constexpr int kWords = 68;
enum : int { kXi = 0, kJc = 12, kJd = 20, kJI = 22, kJab = 38, kRe = 54,
             kCp = 62, kSt = 65, kEn = 66, kWo = 67 };
// window.RES_*
constexpr int kResIn = 0;
constexpr int kResOob = 1;
constexpr int kResOutlier = 2;

struct Args {
  // the window (cuda_kernels._LIN_INPUTS)
  const float* pt_u;
  const float* pt_v;
  const float* pt_color;          // (P, 8)
  const float* pt_weights;        // (P, 8)
  const float* idepth;
  const float* idepth_zero;
  const int64_t* pt_host;
  const bool* pt_valid;
  const bool* res_exist;          // (P, F)
  const bool* res_linearized;
  const int* res_state;
  const float* res_energy;
  const bool* frame_valid;        // (F,)
  const float* frame_energy_th;
  // the precalc: (F, F, ...) per (host, target), b0 (F), fxycxy (4)
  const float* R0;
  const float* t0;
  const float* KRKi;
  const float* Kt;
  const float* aff;
  const float* b0;
  const float* fxycxy;
  const float* dIs;               // (F, H, W, 3)
  const int64_t* tgt;             // the column mode's target
  // the 10 fields (cuda_kernels.LIN_FIELDS, kWidth words a residual) as
  // words: copied through from `in` where a residual is not linearized;
  // written to `out`
  const unsigned* in[kFields];
  unsigned* out[kFields];
  float* o_energy;                // (S,)
  // scratch: the blocks' 32-residual sums (S, nunits) and their arrival
  // counters (S,)
  float* partial;
  unsigned* arrived;
  int S, P, F, H, W, mode, aff_a_off, aff_b_off, nunits;
  int patt[2 * kTaps];
  // the strides (elements) of R0 (S, F, F, 3, 3), t0 (S, F, F, 3), KRKi
  // and b0 (S, F): the precalc's views, read in place
  int sR[5], st[4], sK[5], sb[2];
  float wM3, hM3, xmax, ymax, outlier_c, huber, scale_idepth, scale_f,
      scale_c;
};

// torch.clamp(v, lo, hi) and torch.clamp(v, min=lo) on the card: NaN
// passes, then ::max and ::min (fmaxf, fminf)
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
// torch.maximum: NaN from either side
__device__ __forceinline__ float maximum_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// sum8's tree over the eight lanes of a residual (`group` their mask), lane
// k holding tap k: after the step with mask m each pair (k, k ^ m) holds one
// value, as float addition commutes, so every lane ends with
// ((x0 + x1) + (x2 + x3)) + ((x4 + x5) + (x6 + x7))
__device__ __forceinline__ float lane_sum8(float v, unsigned group) {
  v = v + __shfl_xor_sync(group, v, 1);
  v = v + __shfl_xor_sync(group, v, 2);
  return v + __shfl_xor_sync(group, v, 4);
}
__device__ __forceinline__ bool lane_all8(bool v, unsigned group) {
  int x = v ? 1 : 0;
  x &= __shfl_xor_sync(group, x, 1);
  x &= __shfl_xor_sync(group, x, 2);
  x &= __shfl_xor_sync(group, x, 4);
  return x != 0;
}
// a warp's shuffle tree: lane i adds lane i ^ m for m = 16 .. 1
__device__ __forceinline__ float warp_tree(float v) {
  for (int m = 16; m >= 1; m >>= 1) v = v + __shfl_xor_sync(kFull, v, m);
  return v;
}

// backend/ba._bilinear_frames at one point of one frame: 3 channels
__device__ __forceinline__ void bilinear3(const float* img, int H, int W,
                                          float xmax, float ymax, float Ku,
                                          float Kv, float out[3]) {
  const float x = clamp_nan(Ku, 0.0f, xmax);
  const float y = clamp_nan(Kv, 0.0f, ymax);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float dx = x - x0;
  const float dy = y - y0;
  const long long xi = isnan(x0) ? 0 : (long long)x0;
  const long long yi = isnan(y0) ? 0 : (long long)y0;
  const long long base = yi * W + xi;
  const float dxdy = dx * dy;
  const float w10 = dy - dxdy;
  const float w01 = dx - dxdy;
  const float w00 = ((1.0f - dx) - dy) + dxdy;
  for (int c = 0; c < 3; ++c) {
    const float v00 = __ldg(img + base * 3 + c);
    const float v01 = __ldg(img + (base + 1) * 3 + c);
    const float v10 = __ldg(img + (base + W) * 3 + c);
    const float v11 = __ldg(img + (base + W + 1) * 3 + c);
    out[c] = ((dxdy * v11 + w10 * v10) + w01 * v01) + w00 * v00;
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// word c of residual j's field at stage offset `off` (kRes words a unit),
// `width` words a residual
__device__ __forceinline__ void put(unsigned* st, int off, int width, int j,
                                    int c, float v) {
  st[off * kRes + j * width + c] = __float_as_uint(v);
}

// The residual (p, f) of window s (r its index), held by the 8 lanes of
// `group`, lane k on tap k: its 10 fields written to the block's stage
// (slot j), its new energy returned (to every lane). The eight lanes load
// the residual's and its point's scalars and the (host, target) precalc
// alike (one address a group) and compute the per-residual values in one
// instruction stream.
__device__ float linearize_one(const Args& a, int s, int p, int f,
                               long long r, int j, int k, unsigned group,
                               unsigned* st) {
  const int F = a.F;
  const long long ps = (long long)s * a.P + p;
  int h = (int)a.pt_host[ps];
  h = h < 0 ? 0 : (h >= F ? F - 1 : h);
  const int hf = (s * F + h) * F + f;
  // R0, t0, KRKi and b0 read in place by the precalc views' strides
  const float* Rp = a.R0 + (s * a.sR[0] + h * a.sR[1] + f * a.sR[2]);
  const float* tp = a.t0 + (s * a.st[0] + h * a.st[1] + f * a.st[2]);
  const float* Kp = a.KRKi + (s * a.sK[0] + h * a.sK[1] + f * a.sK[2]);
  float R[9], t[3], K[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = tp[i * a.st[3]];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      R[3 * i + c] = Rp[i * a.sR[3] + c * a.sR[4]];
      K[3 * i + c] = Kp[i * a.sK[3] + c * a.sK[4]];
    }
  }
  const float* kt = a.Kt + hf * 3;
  const float* af = a.aff + hf * 2;
  const float b0 = a.b0[s * a.sb[0] + h * a.sb[1]];
  const float* c4 = a.fxycxy + s * 4;
  const float fx = c4[0], fy = c4[1], cx = c4[2], cy = c4[3];

  // the centre projection: one instruction stream for the eight lanes
  const float up = a.pt_u[ps], vp = a.pt_v[ps];
  const float x0 = (up - cx) / fx;
  const float y0 = (vp - cy) / fy;
  const float iz = a.idepth_zero[ps];
  const float p0 = ((R[0] * x0 + R[1] * y0) + R[2]) + t[0] * iz;
  const float p1 = ((R[3] * x0 + R[4] * y0) + R[5]) + t[1] * iz;
  const float p2 = ((R[6] * x0 + R[7] * y0) + R[8]) + t[2] * iz;
  const float drescale = 1.0f / p2;
  const float new_idepth = iz * drescale;
  const float u = p0 * drescale;
  const float v = p1 * drescale;
  const float Ku_c = u * fx + cx;
  const float Kv_c = v * fy + cy;
  const bool center_ok = (drescale > 0.0f) && (Ku_c > 1.1f) &&
                         (Kv_c > 1.1f) && (Ku_c < a.wM3) && (Kv_c < a.hM3);

  const float d_d_x = ((drescale * (t[0] - t[2] * u)) * a.scale_idepth) * fx;
  const float d_d_y = ((drescale * (t[1] - t[2] * v)) * a.scale_idepth) * fy;
  float dCx2 = drescale * (R[6] * u - R[0]);
  float dCx3 = ((fx * drescale) * (R[7] * u - R[1])) / fy;
  const float dCx0 = (x0 * dCx2 + u) * a.scale_f;
  const float dCx1 = (y0 * dCx3) * a.scale_f;
  dCx2 = (dCx2 + 1.0f) * a.scale_c;
  dCx3 = dCx3 * a.scale_c;
  float dCy2 = ((fy * drescale) * (R[6] * v - R[3])) / fx;
  float dCy3 = drescale * (R[7] * v - R[4]);
  const float dCy0 = (x0 * dCy2) * a.scale_f;
  const float dCy1 = (y0 * dCy3 + v) * a.scale_f;
  dCy2 = dCy2 * a.scale_c;
  dCy3 = (dCy3 + 1.0f) * a.scale_c;

  const float xi[12] = {new_idepth * fx, 0.0f, ((-new_idepth) * u) * fx,
                        ((-u) * v) * fx, (u * u + 1.0f) * fx, (-v) * fx,
                        0.0f, new_idepth * fy, ((-new_idepth) * v) * fy,
                        (-(v * v + 1.0f)) * fy, (u * v) * fy, u * fy};
  const float jc[8] = {dCx0, dCx1, dCx2, dCx3, dCy0, dCy1, dCy2, dCy3};
  const float cp[3] = {Ku_c, Kv_c, new_idepth};
  // lane k writes the words c with c % 8 == k
#pragma unroll
  for (int c = 0; c < 12; ++c)
    if ((c & 7) == k) put(st, kXi, 12, j, c, xi[c]);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if (c == k) put(st, kJc, 8, j, c, jc[c]);
  if (k == 0) put(st, kJd, 2, j, 0, d_d_x);
  if (k == 1) put(st, kJd, 2, j, 1, d_d_y);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    if (c == k) put(st, kCp, 3, j, c, cp[c]);

  // tap k at the current state
  const float idp = a.idepth[ps];
  const float* img = a.dIs + ((long long)s * F + f) * a.H * a.W * 3;
  const float color = a.pt_color[ps * kTaps + k];
  const float weight = a.pt_weights[ps * kTaps + k];
  const float uP = up + (float)a.patt[2 * k];
  const float vP = vp + (float)a.patt[2 * k + 1];
  const float q0 = ((K[0] * uP + K[1] * vP) + K[2]) + kt[0] * idp;
  const float q1 = ((K[3] * uP + K[4] * vP) + K[5]) + kt[1] * idp;
  const float q2 = ((K[6] * uP + K[7] * vP) + K[8]) + kt[2] * idp;
  const float Ku = q0 / q2;
  const float Kv = q1 / q2;
  float hit[3];
  bilinear3(img, a.H, a.W, a.xmax, a.ymax, Ku, Kv, hit);
  const bool tap_ok = (Ku > 1.1f) && (Kv > 1.1f) && (Ku < a.wM3) &&
                      (Kv < a.hM3) && isfinite(hit[0]);

  const float resid = hit[0] - (af[0] * color + af[1]);
  const float drdA = color - b0;
  const float gsq = hit[1] * hit[1] + hit[2] * hit[2];
  const float wg = sqrtf((1.0f / (gsq + a.outlier_c)) * a.outlier_c);
  const float wgt = 0.5f * (wg + weight);
  const float ar = fabsf(resid);
  const float hw_e = ar < a.huber
                         ? 1.0f
                         : (1.0f / clamp_min_nan(ar, 1e-12f)) * a.huber;
  const float e_term =
      ((((wgt * wgt) * hw_e) * resid) * resid) * (2.0f - hw_e);
  const float hw = (hw_e < 1.0f ? sqrtf(hw_e) : hw_e) * wgt;
  put(st, kJI, 16, j, k, hit[1] * hw);
  put(st, kJI, 16, j, kTaps + k, hit[2] * hw);
  put(st, kJab, 16, j, k, a.aff_a_off ? 0.0f : drdA * hw);
  put(st, kJab, 16, j, kTaps + k, a.aff_b_off ? 0.0f : hw);
  put(st, kRe, 8, j, k, resid * hw);
  const float w_term = (hw * hw) * gsq;

  const float energy = lane_sum8(e_term, group);
  const float wJI2 = lane_sum8(w_term, group);
  const bool taps_ok = lane_all8(tap_ok, group);
  const bool oob = (a.res_state[r] == kResOob) || !center_ok || !taps_ok;
  const float th = maximum_nan(a.frame_energy_th[s * F + h],
                               a.frame_energy_th[s * F + f]);
  const bool outlier = (energy > th) || (wJI2 < 2.0f);
  float new_energy = outlier ? th : energy;
  new_energy = oob ? a.res_energy[r] : new_energy;
  if (k == 0)
    st[kSt * kRes + j] = (unsigned)(oob ? kResOob
                                        : (outlier ? kResOutlier : kResIn));
  if (k == 1) put(st, kEn, 1, j, 0, new_energy);
  if (k == 2) put(st, kWo, 1, j, 0, oob ? -1.0f : energy);
  return new_energy;
}

// The block's 10 fields from the stage to the outputs, 16 bytes a thread
// where the addresses allow: a word of a residual linearized here from the
// stage, any other word copied through from the input (16-byte loads). A
// field's stage starts on 16 bytes, so a 4-word unit lies in one field.
__device__ void store_fields(const Args& a, long long base, int nv,
                             const bool* app, const unsigned* st) {
  for (int x = threadIdx.x; x < kWords * kRes / 4; x += kBlock) {
    const int word = 4 * x;
    int q = 0, off = kXi, wd = 12;
    if (word >= kJc * kRes) { q = 1; off = kJc; wd = 8; }
    if (word >= kJd * kRes) { q = 2; off = kJd; wd = 2; }
    if (word >= kJI * kRes) { q = 3; off = kJI; wd = 16; }
    if (word >= kJab * kRes) { q = 4; off = kJab; wd = 16; }
    if (word >= kRe * kRes) { q = 5; off = kRe; wd = 8; }
    if (word >= kCp * kRes) { q = 6; off = kCp; wd = 3; }
    if (word >= kSt * kRes) { q = 7; off = kSt; wd = 1; }
    if (word >= kEn * kRes) { q = 8; off = kEn; wd = 1; }
    if (word >= kWo * kRes) { q = 9; off = kWo; wd = 1; }
    const int w = word - off * kRes;         // the word in the field's block
    const int n = min(4, nv * wd - w);
    if (n <= 0) continue;
    const float inv = 1.0f / (float)wd;
    const uint4 sv = *reinterpret_cast<const uint4*>(st + word);
    unsigned v[4] = {sv.x, sv.y, sv.z, sv.w};
    bool from_st[4];
    bool copy = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      from_st[c] = c < n && app[(int)(((float)(w + c) + 0.5f) * inv)];
      copy = copy || (c < n && !from_st[c]);
    }
    if (copy) {
      const unsigned* src = a.in[q] + base * wd + w;
      unsigned in[4] = {0u, 0u, 0u, 0u};
      if (n == 4 && aligned16(src)) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
        in[0] = u.x;
        in[1] = u.y;
        in[2] = u.z;
        in[3] = u.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < n) in[c] = __ldg(src + c);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (!from_st[c]) v[c] = in[c];
    }
    unsigned* dst = a.out[q] + base * wd + w;
    if (n == 4 && aligned16(dst)) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < n) dst[c] = v[c];
    }
  }
}

// group b of the energy sum (LIN_BLOCK residuals: the 32-residual sums
// 8b .. 8b + 7 of `unit`, zeros past nunits) as a warp tree of the eight
// padded with zeros to a warp gives it on lane 0: y_i = x_i + 0, then
// ((y0 + y4) + (y2 + y6)) + ((y1 + y5) + (y3 + y7))
__device__ float group_sum(const float* unit, int b, int nunits) {
  float y[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int q = kGroup * b + u;
    y[u] = __fadd_rn(q < nunits ? __ldcg(unit + q) : 0.0f, 0.0f);
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(y[0], y[4]), __fadd_rn(y[2], y[6])),
                   __fadd_rn(__fadd_rn(y[1], y[5]), __fadd_rn(y[3], y[7])));
}

__global__ void __launch_bounds__(kBlock, 4) linearize_kernel(Args a) {
  __shared__ __align__(16) unsigned st[kWords * kRes];
  __shared__ bool app[kRes];
  __shared__ float es[kRes];
  __shared__ bool last;
  const int s = blockIdx.y;
  const int F = a.F;
  const int n = a.P * F;
  const int j = threadIdx.x / kLanes, k = threadIdx.x % kLanes;
  const int lane = threadIdx.x & 31;
  const unsigned group = 0xffu << (lane & ~(kLanes - 1));
  const int i0 = blockIdx.x * kRes;
  const int i = i0 + j;
  const int nv = min(kRes, n - i0);
  bool lin = false, apply = false;
  int p = 0, f = 0;
  long long r = 0;
  if (i < n) {
    p = i / F;
    f = i - p * F;
    r = (long long)s * n + i;
    lin = a.res_exist[r] && a.pt_valid[(long long)s * a.P + p] &&
          !a.res_linearized[r] && a.frame_valid[s * F + f];
    apply = lin && (a.mode == 0 || (long long)f == a.tgt[s]);
  }
  if (k == 0) app[j] = apply;
  float en = 0.0f;
  if (apply)
    en = linearize_one(a, s, p, f, r, j, k, group, st);
  else if (i < n)
    en = __uint_as_float(__ldg(a.in[8] + r));
  if (k == 0) es[j] = lin ? en : 0.0f;
  __syncthreads();
  // the block's 32 energies: one warp tree of the energy sum
  if (threadIdx.x < 32) {
    const float e = warp_tree(es[lane]);
    if (lane == 0) {
      a.partial[(long long)s * a.nunits + blockIdx.x] = e;
      __threadfence();
      last = atomicAdd(a.arrived + s, 1u) == (unsigned)(a.nunits - 1);
    }
  }
  store_fields(a, (long long)s * n + i0, nv, app, st);
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  // the last block of window s: lane l adds groups l, l + 32, ... in order
  // from 0.0, then the lanes by the tree
  __threadfence();
  const float* unit = a.partial + (long long)s * a.nunits;
  const int nb = (a.nunits + kGroup - 1) / kGroup;
  float acc = 0.0f;
  for (int b = lane; b < ((nb + 31) / 32) * 32; b += 32)
    acc = acc + (b < nb ? group_sum(unit, b, a.nunits) : 0.0f);
  acc = warp_tree(acc);
  if (lane == 0) a.o_energy[s] = acc;
}

}  // namespace

// ptrs: cuda_kernels._LIN_INPUTS (the window's, the precalc's, the images,
// the 10 fields copied through, the target), then the 10 fields and the
// energy sums, then the 32-residual sums and the counters. ints: S, P, F,
// H, W, mode, the affine a and b flags, the pattern's 16 offsets, the
// strides of R0 (5), t0 (4), KRKi (5) and b0 (2). floats:
// img_w - 3, img_h - 3, W - 1.001, H - 1.001, the outlier and Huber
// thresholds, SCALE_IDEPTH, SCALE_F, SCALE_C. Returns the launch's CUDA
// error.
extern "C" int ldso_ba_linearize(void** ptrs, const int* ints,
                                 const float* floats, void* stream) {
  Args a;
  int k = 0;
  a.pt_u = (const float*)ptrs[k++];
  a.pt_v = (const float*)ptrs[k++];
  a.pt_color = (const float*)ptrs[k++];
  a.pt_weights = (const float*)ptrs[k++];
  a.idepth = (const float*)ptrs[k++];
  a.idepth_zero = (const float*)ptrs[k++];
  a.pt_host = (const int64_t*)ptrs[k++];
  a.pt_valid = (const bool*)ptrs[k++];
  a.res_exist = (const bool*)ptrs[k++];
  a.res_linearized = (const bool*)ptrs[k++];
  a.res_state = (const int*)ptrs[k++];
  a.res_energy = (const float*)ptrs[k++];
  a.frame_valid = (const bool*)ptrs[k++];
  a.frame_energy_th = (const float*)ptrs[k++];
  a.R0 = (const float*)ptrs[k++];
  a.t0 = (const float*)ptrs[k++];
  a.KRKi = (const float*)ptrs[k++];
  a.Kt = (const float*)ptrs[k++];
  a.aff = (const float*)ptrs[k++];
  a.b0 = (const float*)ptrs[k++];
  a.fxycxy = (const float*)ptrs[k++];
  a.dIs = (const float*)ptrs[k++];
  for (int q = 0; q < kFields; ++q) a.in[q] = (const unsigned*)ptrs[k++];
  a.tgt = (const int64_t*)ptrs[k++];
  for (int q = 0; q < kFields; ++q) a.out[q] = (unsigned*)ptrs[k++];
  a.o_energy = (float*)ptrs[k++];
  a.partial = (float*)ptrs[k++];
  a.arrived = (unsigned*)ptrs[k++];
  a.S = ints[0];
  a.P = ints[1];
  a.F = ints[2];
  a.H = ints[3];
  a.W = ints[4];
  a.mode = ints[5];
  a.aff_a_off = ints[6];
  a.aff_b_off = ints[7];
  for (int i = 0; i < 2 * kTaps; ++i) a.patt[i] = ints[8 + i];
  const int* strides = ints + 8 + 2 * kTaps;
  for (int i = 0; i < 5; ++i) a.sR[i] = strides[i];
  for (int i = 0; i < 4; ++i) a.st[i] = strides[5 + i];
  for (int i = 0; i < 5; ++i) a.sK[i] = strides[9 + i];
  for (int i = 0; i < 2; ++i) a.sb[i] = strides[14 + i];
  a.wM3 = floats[0];
  a.hM3 = floats[1];
  a.xmax = floats[2];
  a.ymax = floats[3];
  a.outlier_c = floats[4];
  a.huber = floats[5];
  a.scale_idepth = floats[6];
  a.scale_f = floats[7];
  a.scale_c = floats[8];
  const long long n = (long long)a.P * a.F;
  a.nunits = (int)((n + kRes - 1) / kRes);
  dim3 grid(a.nunits, a.S);
  linearize_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
