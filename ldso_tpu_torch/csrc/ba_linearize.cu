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
// energy sum's order (warps by the shuffle tree, a block's warps by the
// same tree, then the blocks by one warp in block order) is the plain
// version's too (backend/ba.ordered_energy_sum); the blocks' sums meet in
// the last block to arrive (an integer counter; no float atomics).
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
// What the design does about that: one launch for the whole lattice, one
// thread per residual, its state and point read once, its 10 fields
// written once; the pixels through the read-only cache (the images fit in
// the 50 MB L2). A simple first design: the fields are written with a
// stride of their width, not coalesced.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 8;
constexpr int kBlock = 256;                     // backend/ba.LIN_BLOCK
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
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
  // the fields copied through where a residual is not linearized
  const float* Jpdxi;             // (P, F, 2, 6)
  const float* Jpdc;              // (P, F, 2, 4)
  const float* Jpdd;              // (P, F, 2)
  const float* JIdx;              // (P, F, 2, 8)
  const float* JabF;              // (P, F, 2, 8)
  const float* resF;              // (P, F, 8)
  const float* center_proj;       // (P, F, 3)
  const int* res_new_state;
  const float* res_new_energy;
  const float* res_new_energy_wo;
  const int64_t* tgt;             // the column mode's target
  // outputs
  float* o_Jpdxi;
  float* o_Jpdc;
  float* o_Jpdd;
  float* o_JIdx;
  float* o_JabF;
  float* o_resF;
  float* o_center_proj;
  int* o_res_new_state;
  float* o_res_new_energy;
  float* o_res_new_energy_wo;
  float* o_energy;                // (S,)
  // scratch: the blocks' sums (S, nb) and their arrival counters (S,)
  float* partial;
  unsigned* arrived;
  int S, P, F, H, W, mode, aff_a_off, aff_b_off, nb;
  int patt[2 * kTaps];
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
__device__ __forceinline__ float sum8(const float* x) {
  return ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
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

// The residual (p, f) of window s: its 10 fields written, its new energy
// returned.
__device__ float linearize_one(const Args& a, int s, int p, int f,
                               long long r) {
  const int P = a.P, F = a.F;
  const long long ps = (long long)s * P + p;
  int h = (int)a.pt_host[ps];
  h = h < 0 ? 0 : (h >= F ? F - 1 : h);
  const long long hf = ((long long)s * F + h) * F + f;
  const float* R = a.R0 + hf * 9;
  const float* t = a.t0 + hf * 3;
  const float* K = a.KRKi + hf * 9;
  const float* kt = a.Kt + hf * 3;
  const float* af = a.aff + hf * 2;
  const float b0 = a.b0[(long long)s * F + h];
  const float* c4 = a.fxycxy + (long long)s * 4;
  const float fx = c4[0], fy = c4[1], cx = c4[2], cy = c4[3];

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

  float* jxi = a.o_Jpdxi + r * 12;
  jxi[0] = new_idepth * fx;
  jxi[1] = 0.0f;
  jxi[2] = ((-new_idepth) * u) * fx;
  jxi[3] = ((-u) * v) * fx;
  jxi[4] = (u * u + 1.0f) * fx;
  jxi[5] = (-v) * fx;
  jxi[6] = 0.0f;
  jxi[7] = new_idepth * fy;
  jxi[8] = ((-new_idepth) * v) * fy;
  jxi[9] = (-(v * v + 1.0f)) * fy;
  jxi[10] = (u * v) * fy;
  jxi[11] = u * fy;
  float* jc = a.o_Jpdc + r * 8;
  jc[0] = dCx0; jc[1] = dCx1; jc[2] = dCx2; jc[3] = dCx3;
  jc[4] = dCy0; jc[5] = dCy1; jc[6] = dCy2; jc[7] = dCy3;
  a.o_Jpdd[r * 2] = d_d_x;
  a.o_Jpdd[r * 2 + 1] = d_d_y;
  a.o_center_proj[r * 3] = Ku_c;
  a.o_center_proj[r * 3 + 1] = Kv_c;
  a.o_center_proj[r * 3 + 2] = new_idepth;

  // the 8 pattern taps at the current state
  const float idp = a.idepth[ps];
  const float* img = a.dIs + ((long long)s * F + f) * a.H * a.W * 3;
  const float* color = a.pt_color + ps * kTaps;
  const float* weights = a.pt_weights + ps * kTaps;
  float* jidx = a.o_JIdx + r * 16;
  float* jab = a.o_JabF + r * 16;
  float* res = a.o_resF + r * kTaps;
  float e_terms[kTaps], w_terms[kTaps];
  bool taps_ok = true;
  for (int k = 0; k < kTaps; ++k) {
    const float uP = up + (float)a.patt[2 * k];
    const float vP = vp + (float)a.patt[2 * k + 1];
    const float q0 = ((K[0] * uP + K[1] * vP) + K[2]) + kt[0] * idp;
    const float q1 = ((K[3] * uP + K[4] * vP) + K[5]) + kt[1] * idp;
    const float q2 = ((K[6] * uP + K[7] * vP) + K[8]) + kt[2] * idp;
    const float Ku = q0 / q2;
    const float Kv = q1 / q2;
    float hit[3];
    bilinear3(img, a.H, a.W, a.xmax, a.ymax, Ku, Kv, hit);
    taps_ok = taps_ok && (Ku > 1.1f) && (Kv > 1.1f) && (Ku < a.wM3) &&
              (Kv < a.hM3) && isfinite(hit[0]);

    const float resid = hit[0] - (af[0] * color[k] + af[1]);
    const float drdA = color[k] - b0;
    const float gsq = hit[1] * hit[1] + hit[2] * hit[2];
    const float wg = sqrtf((1.0f / (gsq + a.outlier_c)) * a.outlier_c);
    const float wgt = 0.5f * (wg + weights[k]);
    const float ar = fabsf(resid);
    const float hw_e = ar < a.huber
                           ? 1.0f
                           : (1.0f / clamp_min_nan(ar, 1e-12f)) * a.huber;
    e_terms[k] = ((((wgt * wgt) * hw_e) * resid) * resid) * (2.0f - hw_e);
    const float hw = (hw_e < 1.0f ? sqrtf(hw_e) : hw_e) * wgt;
    jidx[k] = hit[1] * hw;
    jidx[kTaps + k] = hit[2] * hw;
    jab[k] = a.aff_a_off ? 0.0f : drdA * hw;
    jab[kTaps + k] = a.aff_b_off ? 0.0f : hw;
    res[k] = resid * hw;
    w_terms[k] = (hw * hw) * gsq;
  }
  const float energy = sum8(e_terms);
  const float wJI2 = sum8(w_terms);
  const bool oob = (a.res_state[r] == kResOob) || !center_ok || !taps_ok;
  const float th = maximum_nan(a.frame_energy_th[(long long)s * F + h],
                               a.frame_energy_th[(long long)s * F + f]);
  const bool outlier = (energy > th) || (wJI2 < 2.0f);
  float new_energy = outlier ? th : energy;
  a.o_res_new_state[r] = oob ? kResOob : (outlier ? kResOutlier : kResIn);
  new_energy = oob ? a.res_energy[r] : new_energy;
  a.o_res_new_energy[r] = new_energy;
  a.o_res_new_energy_wo[r] = oob ? -1.0f : energy;
  return new_energy;
}

__device__ void copy_one(const Args& a, long long r) {
  for (int i = 0; i < 12; ++i) a.o_Jpdxi[r * 12 + i] = a.Jpdxi[r * 12 + i];
  for (int i = 0; i < 8; ++i) a.o_Jpdc[r * 8 + i] = a.Jpdc[r * 8 + i];
  for (int i = 0; i < 2; ++i) a.o_Jpdd[r * 2 + i] = a.Jpdd[r * 2 + i];
  for (int i = 0; i < 16; ++i) a.o_JIdx[r * 16 + i] = a.JIdx[r * 16 + i];
  for (int i = 0; i < 16; ++i) a.o_JabF[r * 16 + i] = a.JabF[r * 16 + i];
  for (int i = 0; i < 8; ++i) a.o_resF[r * 8 + i] = a.resF[r * 8 + i];
  for (int i = 0; i < 3; ++i)
    a.o_center_proj[r * 3 + i] = a.center_proj[r * 3 + i];
  a.o_res_new_state[r] = a.res_new_state[r];
  a.o_res_new_energy[r] = a.res_new_energy[r];
  a.o_res_new_energy_wo[r] = a.res_new_energy_wo[r];
}

__global__ void __launch_bounds__(kBlock) linearize_kernel(Args a) {
  __shared__ float warp_sums[kWarps];
  __shared__ bool last;
  const int s = blockIdx.y;
  const int P = a.P, F = a.F;
  const long long n = (long long)P * F;
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  float e = 0.0f;
  if (i < n) {
    const int p = (int)(i / F);
    const int f = (int)(i % F);
    const long long r = (long long)s * n + i;
    const bool lin = a.res_exist[r] && a.pt_valid[(long long)s * P + p] &&
                     !a.res_linearized[r] &&
                     a.frame_valid[(long long)s * F + f];
    const bool apply = lin && (a.mode == 0 || (long long)f == a.tgt[s]);
    float en;
    if (apply) {
      en = linearize_one(a, s, p, f, r);
    } else {
      copy_one(a, r);
      en = a.res_new_energy[r];
    }
    e = lin ? en : 0.0f;
  }
  // this block's sum: each warp's by the tree, then its 8 warps' (padded
  // with zeros to a warp) by the tree
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  e = warp_tree(e);
  if (lane == 0) warp_sums[warp] = e;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? warp_sums[lane] : 0.0f;
    w = warp_tree(w);
    if (lane == 0) {
      a.partial[(long long)s * a.nb + blockIdx.x] = w;
      __threadfence();
      last = atomicAdd(a.arrived + s, 1u) == (unsigned)(a.nb - 1);
    }
  }
  __syncthreads();
  if (!last || warp != 0) return;
  // the last block of window s: lane l adds blocks l, l + 32, ... in
  // order from 0.0, then the lanes by the tree
  __threadfence();
  float acc = 0.0f;
  for (int b = lane; b < ((a.nb + 31) / 32) * 32; b += 32)
    acc = acc + (b < a.nb ? __ldcg(a.partial + (long long)s * a.nb + b)
                          : 0.0f);
  acc = warp_tree(acc);
  if (lane == 0) a.o_energy[s] = acc;
}

}  // namespace

// ptrs: cuda_kernels._LIN_INPUTS, then the 10 fields and the energy sums,
// then the partial sums and the counters. ints: S, P, F, H, W, mode, the
// affine a and b flags, the pattern's 16 offsets. floats: img_w - 3,
// img_h - 3, W - 1.001, H - 1.001, the outlier and Huber thresholds,
// SCALE_IDEPTH, SCALE_F, SCALE_C. Returns the launch's CUDA error.
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
  a.Jpdxi = (const float*)ptrs[k++];
  a.Jpdc = (const float*)ptrs[k++];
  a.Jpdd = (const float*)ptrs[k++];
  a.JIdx = (const float*)ptrs[k++];
  a.JabF = (const float*)ptrs[k++];
  a.resF = (const float*)ptrs[k++];
  a.center_proj = (const float*)ptrs[k++];
  a.res_new_state = (const int*)ptrs[k++];
  a.res_new_energy = (const float*)ptrs[k++];
  a.res_new_energy_wo = (const float*)ptrs[k++];
  a.tgt = (const int64_t*)ptrs[k++];
  a.o_Jpdxi = (float*)ptrs[k++];
  a.o_Jpdc = (float*)ptrs[k++];
  a.o_Jpdd = (float*)ptrs[k++];
  a.o_JIdx = (float*)ptrs[k++];
  a.o_JabF = (float*)ptrs[k++];
  a.o_resF = (float*)ptrs[k++];
  a.o_center_proj = (float*)ptrs[k++];
  a.o_res_new_state = (int*)ptrs[k++];
  a.o_res_new_energy = (float*)ptrs[k++];
  a.o_res_new_energy_wo = (float*)ptrs[k++];
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
  a.nb = (int)((n + kBlock - 1) / kBlock);
  dim3 grid(a.nb, a.S);
  linearize_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
