// K4: the epipolar trace of the candidate arena, hand-written for Hopper
// (sm_90a). One launch per trace of the arena against a new frame, from
// ldso_tpu_torch/ops/cuda_kernels.trace_arena.
//
// Replaces `trace` of the JAX package (ldso_tpu/frontend/immature.py:119),
// which runs over the arena inside the fused `_frame_step`
// (ldso_tpu/system/full_system.py:47-102) as part of one XLA program; it
// has no `pallas_call`. Its plain version is the port's
// frontend/immature.trace_arena_ref, which on the card runs as some
// hundreds of small aten kernels.
//
// Function: for every lane i of the arena (traceOn,
// ImmaturePoint.cc:47-310), with its host slot clamp(host, 0, F - 1) and
// active = valid & host >= 0 & status != OOB (OOB is sticky):
//   1. project the inverse-depth interval into the new frame (K R K^-1,
//      K t of the host) and apply the OOB, skipped, scale and
//      badcondition gates; the search line's direction, its step count
//      and the error bound from gradH;
//   2. the discrete search over the steps: the Huber SSD of the 8-tap
//      pattern at every step, in one of three samplings (packed: the
//      unrotated integer pattern sharing the step's fraction, each tap
//      clamped; the reference's rotated bilinear; nearest, over the
//      unrotated or the rotated pattern), 1e5 for a non-finite tap and 1e10
//      at and past the step count;
//   3. the first minimum (lowest step on a tie, a NaN first), the second
//      best outside +-2 steps and the quality;
//   4. after a nearest search, the bilinear re-score of +-refine steps;
//   5. Gauss-Newton along the line with the rotated pattern and its
//      backtracking;
//   6. the outlier test, the new interval and the status precedence, and
//      last_u, last_v, last_interval.
// It writes new tensors for the 7 fields the trace updates (idepth_min,
// idepth_max, quality, status, last_u, last_v, last_interval); a lane that
// is not active copies its fields through bit for bit.
//
// Every operation is the plain version's, in its order, and the plain
// version's order is the JAX package's jitted trace on the CPU: XLA:CPU
// contracts a multiply into the add that consumes it (the projection, the
// interval's ends and sums, each step's position, the bilinear blend, the
// residual's affine model, the GN's gradient and steps) and sums the 8
// taps left to right. The plain version writes those contractions with
// math/rounding.fma, one rounding each; this file is built with
// --fmad=false, so it contracts only where it says `__fmaf_rn`, at the
// same places. On the same inputs the two give the same bits;
// tests/torch_kernel_checks.trace_err still allows a lane to differ where
// the plain version's own numbers tie.
//
// What bounds it on this card: bytes, by the function's own count. The
// work is small: at 640x480 about 1,300 live lanes, 34 steps and 8
// bilinear taps each, some 0.35 M taps and 20 M float operations (0.3 us
// at 67 TFLOP/s). The bytes are the arena's lane state (125 bytes a lane
// read and 28 written, 0.6 MB at 4,096 lanes), the host tables and the
// target image's pixels that the taps read (at most its 3.7 MB), about 1.3
// us at 3.35 TB/s. The plain version's time is its launches, not its
// arithmetic.
//
// What held the first design (one warp per lane, 4 lanes a block, every
// thread computing the interval; globaltimer stamps of each lane's phases
// from a stamped copy, not kept, on an H100 at 700 W): at the bench
// scene's 4,096 live lanes its 1,024 blocks ran in two waves (80
// registers, 24 lanes an SM at once; the last lanes started 13.4 us after
// the first), and a searching lane took 12.7 us (median): 2.7 us
// to its interval, 7.6 of search, 1.5 of Gauss-Newton. At phase 3's last
// arena, with some 7 searching lanes an SM, its search still took 6.0 us:
// a chain, not a queue: its tap arrays sat in a 144-byte stack frame
// (ptxas), one warp scored 2 rounds of 32 steps for 34 steps, and each
// lane's interval and GN taps were computed by 32 and 4 threads.
//
// The design: one launch for the whole arena, a group of 16 threads per
// lane, 2 lanes a warp (neighbouring lanes on neighbouring groups), 8
// lanes a block of 128 threads, so a warp issues one instruction stream
// for 2 lanes. Sixteen, not the 8 first tried: with 8 threads a lane the
// search's 5 rounds made the chain longer (in turns in one call, 8 threads
// took 14.6 us at 4,096 lanes and 12.5 at phase 3's last arena against
// 12.6-12.8 and 10.7-10.9 for 16, both with the host tables then staged
// in shared memory; tests/tools/arena_kernel_turns.py). Read in place
// instead, they cost no more (12.1-12.4 and 10.2-10.4 us against the
// staged 12.3-12.4 and 10.5-10.7 in one call).
//   * the group reads its lane's fields alike in one trip, then its host
//     slot's tables (14 floats) in place through the read-only cache, and
//     computes the interval and gates in one instruction stream;
//   * the search: thread g of the group scores steps g, g + 16, g + 32, ...
//     (3 rounds at 34 steps, 7 at the cap of 100), a step's 32 pixel loads
//     issued before any is used (`fetch`, then `energy`), its 8 taps summed
//     left to right in the thread;
//   * the argmin and the second best are xor-shuffle reductions over the
//     group under `before`, a total order (lowest step on a tie, a NaN
//     first), and nan_min, which is order-free, so any tree gives the plain
//     version's result;
//   * the re-score puts candidate j of its 2K + 1 on thread j % 16 (2
//     rounds at most) and recomputes the winner's position from its index;
//   * a Gauss-Newton step puts tap p on threads p and p + 8 of the group
//     (one instruction for both); every thread reads the 8 taps' terms in
//     tap order by shuffles and sums them left to right, and the 12 words
//     of a tap's three channels go out together;
//   * thread 0 of the group writes the lane's 7 outputs.
// Every shuffle names its group's threads, so the 2 lanes of a warp may
// take different branches. A dead or inactive lane costs its group one
// read and one write of its 7 fields. Nothing is summed across lanes, so
// there are no atomics. Stamped again (the tables then staged), every
// lane starts within 0.3 us of the first (one wave, 32 lanes an SM at
// once); a searching lane takes 10.1 us at 4,096 lanes (1.6 to its
// interval, 6.8 of search, 1.4 of GN) and 8.1 at phase 3's last arena
// (5.2 of search): the search's 3 rounds, each its loads then its taps'
// arithmetic, are what is left.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 8;
constexpr int kMaxSteps = 100;                  // immature.MAX_STEPS
constexpr int kGroup = 16;                      // threads a lane
constexpr int kStepsPerThread = (kMaxSteps + kGroup - 1) / kGroup;
constexpr int kMaxRefine = 15;                  // cuda_kernels.TRACE_MAX_REFINE
constexpr int kRefinePerThread = (2 * kMaxRefine + kGroup) / kGroup;
constexpr int kThreads = 128;
constexpr int kLanesPerBlock = kThreads / kGroup;
constexpr int kNone = 0x7fffffff;               // no step on this thread

// immature.IPS_*
constexpr int kGood = 0;
constexpr int kOob = 1;
constexpr int kOutlier = 2;
constexpr int kSkipped = 3;
constexpr int kBadCondition = 4;

// the discrete search's sampling (cuda_kernels.TRACE_SEARCHES)
constexpr int kPacked = 0;          // unrotated integer pattern, bilinear
constexpr int kRotated = 1;         // the reference's rotated bilinear
constexpr int kNearestPacked = 2;   // unrotated integer pattern, nearest
constexpr int kNearestRotated = 3;  // rotated pattern, nearest

struct Args {
  // the arena (N lanes)
  const float* u;
  const float* v;
  const bool* valid;
  const float* color;        // (N, 8)
  const float* weights;      // (N, 8)
  const float* gradH;        // (N, 2, 2)
  const float* idepth_min;
  const float* idepth_max;
  const float* quality;
  const float* energy_th;
  const int* status;
  const float* last_u;
  const float* last_v;
  const float* last_interval;
  const int* host;
  // the target frame (H, W, 3) and the host tables (F, 3, 3), (F, 3), (F, 2)
  const float* dI;
  const float* KRKi;
  const float* Kt;
  const float* aff;
  // the 7 outputs (N lanes)
  float* o_idepth_min;
  float* o_idepth_max;
  float* o_quality;
  int* o_status;
  float* o_last_u;
  float* o_last_v;
  float* o_last_interval;
  int n, n_hosts, w, h, n_cap, search, refine, gn_iterations;
  // Config values and the plain version's Python scalars, as float32
  float max_pix_search, stepsize, slack_interval, min_improvement, huber_th,
      gn_threshold, extra_slack, x_hi, y_hi;
  int patt[kTaps][2];
};

// torch.clamp and its one-sided forms: a NaN stays NaN
__device__ __forceinline__ float clamp_f(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
// torch.minimum / torch.maximum: a NaN operand is the result
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// immature._tap_sum: the 8 taps left to right
__device__ __forceinline__ float tap_sum(const float* x) {
  float s = x[0];
#pragma unroll
  for (int p = 1; p < kTaps; ++p) s = s + x[p];
  return s;
}

// the same sum with tap p on threads p and p + 8 of a 16-thread group
// (`group` its mask): every thread reads the taps in order
__device__ __forceinline__ float tap_sum_shfl(float x, unsigned group) {
  float s = __shfl_sync(group, x, 0, kGroup);
#pragma unroll
  for (int p = 1; p < kTaps; ++p) s = s + __shfl_sync(group, x, p, kGroup);
  return s;
}

// torch.argmin's order (LessOrNan): a NaN before any number, the lower
// index on a tie; kNone loses to everything
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  if (ia == kNone) return false;
  if (ib == kNone) return true;
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  if (isnan(b)) return false;
  return a == b ? ia < ib : a < b;
}

// the group's first minimum; every thread of it gets it
__device__ __forceinline__ void group_argmin(float& val, int& idx,
                                             unsigned group) {
#pragma unroll
  for (int off = 1; off < kGroup; off <<= 1) {
    const float ov = __shfl_xor_sync(group, val, off);
    const int oi = __shfl_xor_sync(group, idx, off);
    if (before(ov, oi, val, idx)) {
      val = ov;
      idx = oi;
    }
  }
}

// torch.amin over the group (NaN propagates)
__device__ __forceinline__ float group_amin(float x, unsigned group) {
#pragma unroll
  for (int off = 1; off < kGroup; off <<= 1) {
    x = nan_min(x, __shfl_xor_sync(group, x, off));
  }
  return x;
}

// immature._trace_huber_w: th / |r| as one division
__device__ __forceinline__ float huber_w(float ar, float th) {
  return ar < th ? 1.0f : th / clamp_min(ar, 1e-12f);
}

// one tap's term of pattern_energy
__device__ __forceinline__ float pattern_term(float hit, float color,
                                              const float* af, float th) {
  const float res = hit - __fmaf_rn(af[0], color, af[1]);
  const float hw = huber_w(fabsf(res), th);
  return isfinite(hit) ? hw * res * res * (2.0f - hw) : 1e5f;
}

__device__ __forceinline__ float pixel(const Args& a, int y, int x, int c) {
  return __ldg(a.dI + 3 * (y * a.w + x) + c);
}

// interp.bilinear's weights and cell of (x, y): a NaN coordinate takes cell
// 0 and keeps its NaN weights
struct Cell {
  int x, y;
  float dx, dy;
};
__device__ __forceinline__ Cell bilinear_cell(const Args& a, float x,
                                              float y) {
  x = clamp_f(x, 0.0f, a.x_hi);
  y = clamp_f(y, 0.0f, a.y_hi);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  Cell c;
  c.x = isnan(x0) ? 0 : static_cast<int>(x0);
  c.y = isnan(y0) ? 0 : static_cast<int>(y0);
  c.dx = x - x0;
  c.dy = y - y0;
  return c;
}
// immature._blend: each of the last three products contracted into the
// sum before it
__device__ __forceinline__ float blend(float dx, float dy, float v00,
                                       float v01, float v10, float v11) {
  const float dxdy = dx * dy;
  float s = __fmaf_rn(dxdy, v11, (dy - dxdy) * v10);
  s = __fmaf_rn(dx - dxdy, v01, s);
  return __fmaf_rn(1.0f - dx - dy + dxdy, v00, s);
}
// interp.nearest's index: round half to even, then clamp to the image
__device__ __forceinline__ int nearest_index(float x, int n) {
  const float r = rintf(x);
  return static_cast<int>(clamp_f(isnan(r) ? 0.0f : r, 0.0f,
                                  static_cast<float>(n - 1)));
}

// A lane's fields, loaded alike by the threads of its group; tap g % 8's
// colour and GN weight on thread g.
struct Fields {
  float u, v, idepth_min, idepth_max, quality, energy_th, last_u, last_v,
      last_interval, g[4], color_g, weight_g;
  int status, host;
  bool valid;
};

__device__ __forceinline__ Fields load_fields(const Args& a, int i, int g) {
  Fields f;
  f.u = __ldg(a.u + i);
  f.v = __ldg(a.v + i);
  f.idepth_min = __ldg(a.idepth_min + i);
  f.idepth_max = __ldg(a.idepth_max + i);
  f.quality = __ldg(a.quality + i);
  f.energy_th = __ldg(a.energy_th + i);
  f.last_u = __ldg(a.last_u + i);
  f.last_v = __ldg(a.last_v + i);
  f.last_interval = __ldg(a.last_interval + i);
#pragma unroll
  for (int k = 0; k < 4; ++k) f.g[k] = __ldg(a.gradH + 4 * i + k);
  f.color_g = __ldg(a.color + kTaps * i + (g & (kTaps - 1)));
  f.weight_g = __ldg(a.weights + kTaps * i + (g & (kTaps - 1)));
  f.status = __ldg(a.status + i);
  f.host = __ldg(a.host + i);
  f.valid = a.valid[i];
  return f;
}

// The lane's state after the interval projection and its gates
// (immature.trace up to `do_search`), computed alike by the group.
struct Lane {
  float pr[3], kt[3], af[2], k2[4];   // k2: K R K^-1's 2x2 block
  float u_min, v_min, u_max, v_max, dist, dxn, dyn, error_px, ptx0, pty0;
  int n_steps;
  bool oob, skipped, badcond;
};

// tap p of the pattern rotated by K R K^-1's 2x2 block, (px r0 + py r1)
// per row
__device__ __forceinline__ float rot_x(const Args& a, const Lane& L, int p) {
  return static_cast<float>(a.patt[p][0]) * L.k2[0] +
         static_cast<float>(a.patt[p][1]) * L.k2[1];
}
__device__ __forceinline__ float rot_y(const Args& a, const Lane& L, int p) {
  return static_cast<float>(a.patt[p][0]) * L.k2[2] +
         static_cast<float>(a.patt[p][1]) * L.k2[3];
}

__device__ Lane interval(const Args& a, const Fields& f) {
  Lane L;
  const int hs = min(max(f.host, 0), a.n_hosts - 1);
  float K[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) K[k] = __ldg(a.KRKi + 9 * hs + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) L.kt[k] = __ldg(a.Kt + 3 * hs + k);
  L.af[0] = __ldg(a.aff + 2 * hs);
  L.af[1] = __ldg(a.aff + 2 * hs + 1);
  L.k2[0] = K[0];
  L.k2[1] = K[1];
  L.k2[2] = K[3];
  L.k2[3] = K[4];
  for (int r = 0; r < 3; ++r) {
    L.pr[r] = __fmaf_rn(K[3 * r + 1], f.v, K[3 * r] * f.u) + K[3 * r + 2];
  }
  const float W = static_cast<float>(a.w), H = static_cast<float>(a.h);
  const float mps = a.max_pix_search;
  const float id_min = f.idepth_min;
  const float p0 = __fmaf_rn(L.kt[0], id_min, L.pr[0]);
  const float p1 = __fmaf_rn(L.kt[1], id_min, L.pr[1]);
  const float p2 = __fmaf_rn(L.kt[2], id_min, L.pr[2]);
  L.u_min = p0 / p2;
  L.v_min = p1 / p2;
  const bool inb_min = (L.u_min > 4.0f) & (L.v_min > 4.0f) &
                       (L.u_min < W - 5.0f) & (L.v_min < H - 5.0f);
  const bool finite_max = isfinite(f.idepth_max);
  const float id_max = finite_max ? f.idepth_max : 0.01f;
  const float q0 = __fmaf_rn(L.kt[0], id_max, L.pr[0]);
  const float q1 = __fmaf_rn(L.kt[1], id_max, L.pr[1]);
  const float q2 = __fmaf_rn(L.kt[2], id_max, L.pr[2]);
  const float u_max0 = q0 / q2;
  const float v_max0 = q1 / q2;
  const float du = L.u_min - u_max0, dv = L.v_min - v_max0;
  const float dist_f = sqrtf(__fmaf_rn(du, du, dv * dv));
  const float dnorm = 1.0f / clamp_min(dist_f, 1e-12f);
  const float u_max_inf = __fmaf_rn(mps * (u_max0 - L.u_min), dnorm, L.u_min);
  const float v_max_inf = __fmaf_rn(mps * (v_max0 - L.v_min), dnorm, L.v_min);
  L.u_max = finite_max ? u_max0 : u_max_inf;
  L.v_max = finite_max ? v_max0 : v_max_inf;
  float dist = finite_max ? dist_f : mps;
  const bool inb_max = (L.u_max > 4.0f) & (L.v_max > 4.0f) &
                       (L.u_max < W - 5.0f) & (L.v_max < H - 5.0f);

  bool oob = !inb_min | !inb_max;
  L.skipped = finite_max & (dist < a.slack_interval) & !oob;
  const bool scale_ok = (id_min < 0.0f) | ((p2 > 0.75f) & (p2 < 1.5f));
  oob = oob | !scale_ok;

  // the error bound from gradH
  const float dx0 = a.stepsize * (L.u_max - L.u_min);
  const float dy0 = a.stepsize * (L.v_max - L.v_min);
  const float* g = f.g;
  const float A = __fmaf_rn(dx0, __fmaf_rn(g[1], dy0, g[0] * dx0),
                            dy0 * __fmaf_rn(g[2], dx0, g[3] * dy0));
  const float B = __fmaf_rn(dy0, __fmaf_rn(g[0], dy0, -(g[1] * dx0)),
                            -(dx0 * __fmaf_rn(g[2], dy0, -(g[3] * dx0))));
  float error_px = 0.2f + 0.2f * (A + B) / clamp_min(A, 1e-12f);
  L.badcond = (error_px * a.min_improvement > dist) & finite_max & !oob &
              !L.skipped;
  L.error_px = clamp_max(error_px, 10.0f);

  L.dxn = dx0 / clamp_min(dist, 1e-12f);
  L.dyn = dy0 / clamp_min(dist, 1e-12f);
  if (dist > mps) {
    L.u_max = __fmaf_rn(mps, L.dxn, L.u_min);
    L.v_max = __fmaf_rn(mps, L.dyn, L.v_min);
  }
  L.dist = clamp_max(dist, mps);
  L.n_steps = min(static_cast<int>(1.9999f + L.dist / a.stepsize),
                  a.n_cap - 1);
  const bool bad_dir = !isfinite(L.dxn) | !isfinite(L.dyn);
  L.oob = oob | bad_dir;

  const float rand_shift = L.u_min * 1000.0f - floorf(L.u_min * 1000.0f);
  L.ptx0 = __fmaf_rn(-rand_shift, L.dxn, L.u_min);
  L.pty0 = __fmaf_rn(-rand_shift, L.dyn, L.v_min);
  return L;
}

// One step's 8 taps: each tap's pixel words (the 4 corners of its
// bilinear cell; a nearest sampling has one) and its cell's fractions.
// `fetch` issues all of a step's loads before `energy` reads any, so they
// are in flight together.
struct Taps {
  float v[kTaps][4];
  float dx[kTaps], dy[kTaps];
};

// the step's taps at (sx, sy) in sampling kSearch (kRotated also serves
// the re-score: the reference's bilinear over the rotated pattern)
template <int kSearch>
__device__ __forceinline__ void fetch(const Args& a, const Lane& L, float sx,
                                      float sy, Taps& T) {
  if (kSearch == kPacked) {
    // immature._search_samples: one fraction, each tap's row and column
    // clamped to the image
    const Cell q = bilinear_cell(a, sx, sy);
#pragma unroll
    for (int p = 0; p < kTaps; ++p) {
      const int cx = min(max(q.x + a.patt[p][0], 0), a.w - 1);
      const int cy = min(max(q.y + a.patt[p][1], 0), a.h - 1);
      const int cx1 = min(cx + 1, a.w - 1);
      const int cy1 = min(cy + 1, a.h - 1);
      T.v[p][0] = pixel(a, cy, cx, 0);
      T.v[p][1] = pixel(a, cy, cx1, 0);
      T.v[p][2] = pixel(a, cy1, cx, 0);
      T.v[p][3] = pixel(a, cy1, cx1, 0);
      T.dx[p] = q.dx;
      T.dy[p] = q.dy;
    }
  } else if (kSearch == kRotated) {
#pragma unroll
    for (int p = 0; p < kTaps; ++p) {
      const Cell q = bilinear_cell(a, sx + rot_x(a, L, p),
                                   sy + rot_y(a, L, p));
      T.v[p][0] = pixel(a, q.y, q.x, 0);
      T.v[p][1] = pixel(a, q.y, q.x + 1, 0);
      T.v[p][2] = pixel(a, q.y + 1, q.x, 0);
      T.v[p][3] = pixel(a, q.y + 1, q.x + 1, 0);
      T.dx[p] = q.dx;
      T.dy[p] = q.dy;
    }
  } else if (kSearch == kNearestPacked) {
    // immature._nearest_samples: the rounded centre clamped, then each tap
    const int xi = nearest_index(sx, a.w), yi = nearest_index(sy, a.h);
#pragma unroll
    for (int p = 0; p < kTaps; ++p) {
      const int cx = min(max(xi + a.patt[p][0], 0), a.w - 1);
      const int cy = min(max(yi + a.patt[p][1], 0), a.h - 1);
      T.v[p][0] = pixel(a, cy, cx, 0);
    }
  } else {
#pragma unroll
    for (int p = 0; p < kTaps; ++p) {
      const int xi = nearest_index(sx + rot_x(a, L, p), a.w);
      const int yi = nearest_index(sy + rot_y(a, L, p), a.h);
      T.v[p][0] = pixel(a, yi, xi, 0);
    }
  }
}

// pattern_energy of fetched taps: each tap's term, summed left to right
template <int kSearch>
__device__ __forceinline__ float energy(const Args& a, const Lane& L,
                                        const float* color, const Taps& T) {
  float e[kTaps];
#pragma unroll
  for (int p = 0; p < kTaps; ++p) {
    const float hit =
        (kSearch == kNearestPacked || kSearch == kNearestRotated)
            ? T.v[p][0]
            : blend(T.dx[p], T.dy[p], T.v[p][0], T.v[p][1], T.v[p][2],
                    T.v[p][3]);
    e[p] = pattern_term(hit, color[p], L.af, a.huber_th);
  }
  return tap_sum(e);
}

// The discrete search: the first minimum's step and energy, and the
// second best outside +-2 steps, every thread of the group alike. Thread
// g scores steps g, g + 16, g + 32, ..., each step's 32 loads in flight
// together.
struct Search {
  int best;
  float best_e, second;
};

template <int kSearch>
__device__ Search search(const Args& a, const Lane& L, const float* color,
                         int g, unsigned group) {
  float e[kStepsPerThread];
  float val = 0.0f;
  int idx = kNone;
#pragma unroll
  for (int k = 0; k < kStepsPerThread; ++k) {
    const int s = g + kGroup * k;
    e[k] = 0.0f;
    if (kGroup * k < a.n_cap && s < a.n_cap) {
      const float fs = static_cast<float>(s);
      Taps T;
      fetch<kSearch>(a, L, __fmaf_rn(fs, L.dxn, L.ptx0),
                     __fmaf_rn(fs, L.dyn, L.pty0), T);
      const float en = energy<kSearch>(a, L, color, T);
      e[k] = fs < static_cast<float>(L.n_steps) ? en : 1e10f;
      if (before(e[k], s, val, idx)) {
        val = e[k];
        idx = s;
      }
    }
  }
  group_argmin(val, idx, group);
  Search r;
  r.best = idx;
  r.best_e = val;
  // the best step is never far, so 1e10 is always in the plain's amin
  float second = 1e10f;
#pragma unroll
  for (int k = 0; k < kStepsPerThread; ++k) {
    const int s = g + kGroup * k;
    if (s < a.n_cap &&
        fabsf(static_cast<float>(s) - static_cast<float>(r.best)) > 2.0f) {
      second = nan_min(second, e[k]);
    }
  }
  r.second = group_amin(second, group);
  return r;
}

// the bilinear re-score of +-K steps around the nearest search's best
// (the reference's energy over the rotated pattern): candidate j on thread
// j % 16; the winner's position is recomputed from its index, as its thread
// computed it
__device__ void refine(const Args& a, const Lane& L, const float* color,
                       int g, unsigned group, int best, float& best_e,
                       float& best_u, float& best_v) {
  const int K = a.refine;
  float val = 0.0f;
  int idx = kNone;
#pragma unroll
  for (int r = 0; r < kRefinePerThread; ++r) {
    const int j = g + kGroup * r;
    if (j <= 2 * K) {
      const float cand = static_cast<float>(best) + static_cast<float>(j - K);
      const bool live = (cand >= 0.0f) &
                        (cand < static_cast<float>(L.n_steps));
      Taps T;
      fetch<kRotated>(a, L, __fmaf_rn(cand, L.dxn, L.ptx0),
                      __fmaf_rn(cand, L.dyn, L.pty0), T);
      const float en = energy<kRotated>(a, L, color, T);
      const float e = live ? en : 1e10f;
      if (before(e, j, val, idx)) {
        val = e;
        idx = j;
      }
    }
  }
  group_argmin(val, idx, group);
  const float cand = static_cast<float>(best) + static_cast<float>(idx - K);
  best_e = val;
  best_u = __fmaf_rn(cand, L.dxn, L.ptx0);
  best_v = __fmaf_rn(cand, L.dyn, L.pty0);
}

// Gauss-Newton along the line with backtracking, tap p on threads p and
// p + 8;
// returns the final (u, v) and the energy of the last kept step
__device__ void gauss_newton(const Args& a, const Lane& L, const Fields& f,
                             int p, unsigned group, float& bu, float& bv,
                             float& be) {
  const float color = f.color_g;
  const float wt = f.weight_g;
  const float rx = rot_x(a, L, p), ry = rot_y(a, L, p);
  float ubak = bu, vbak = bv, stepback = 0.0f;
  be = 1e5f;
  bool done = false;
  for (int it = 0; it < a.gn_iterations; ++it) {
    const Cell q = bilinear_cell(a, bu + rx, bv + ry);
    float w[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      w[c][0] = pixel(a, q.y, q.x, c);
      w[c][1] = pixel(a, q.y, q.x + 1, c);
      w[c][2] = pixel(a, q.y + 1, q.x, c);
      w[c][3] = pixel(a, q.y + 1, q.x + 1, c);
    }
    const float h0 = blend(q.dx, q.dy, w[0][0], w[0][1], w[0][2], w[0][3]);
    const float h1 = blend(q.dx, q.dy, w[1][0], w[1][1], w[1][2], w[1][3]);
    const float h2 = blend(q.dx, q.dy, w[2][0], w[2][1], w[2][2], w[2][3]);
    const bool finite = isfinite(h0);
    const float r = h0 - __fmaf_rn(L.af[0], color, L.af[1]);
    const float d = __fmaf_rn(L.dxn, h1, L.dyn * h2);
    const float hw = huber_w(fabsf(r), a.huber_th);
    const float e = tap_sum_shfl(
        finite ? wt * wt * hw * r * r * (2.0f - hw) : 1e5f, group);
    const float Hc = 1.0f + tap_sum_shfl(finite ? hw * d * d : 0.0f, group);
    const float bc = tap_sum_shfl(finite ? hw * r * d : 0.0f, group);

    const bool worse = e > be;
    const float sb_half = stepback * 0.5f;
    const float bu_back = __fmaf_rn(sb_half, L.dxn, ubak);
    const float bv_back = __fmaf_rn(sb_half, L.dyn, vbak);
    float step = clamp_f(-bc / Hc, -0.5f, 0.5f);
    step = isfinite(step) ? step : 0.0f;
    const float bu_fwd = __fmaf_rn(step, L.dxn, bu);
    const float bv_fwd = __fmaf_rn(step, L.dyn, bv);
    if (!done) {
      if (!worse) {
        ubak = bu;
        vbak = bv;
        be = e;
      }
      bu = worse ? bu_back : bu_fwd;
      bv = worse ? bv_back : bv_fwd;
      stepback = worse ? sb_half : step;
    }
    done = done | (fabsf(worse ? sb_half : step) < a.gn_threshold);
  }
}

template <int kSearch>
__global__ void __launch_bounds__(kThreads)
    immature_trace_kernel(const Args a) {
  const int g = threadIdx.x & (kGroup - 1);
  const unsigned group = (0xffffffffu >> (32 - kGroup))
                         << (threadIdx.x & (32 - kGroup));
  const int i = blockIdx.x * kLanesPerBlock + threadIdx.x / kGroup;
  if (i >= a.n) return;                       // whole groups
  const Fields f = load_fields(a, i, g);
  const bool active = f.valid & (f.host >= 0) & (f.status != kOob);
  if (!active) {
    if (g == 0) {
      a.o_idepth_min[i] = f.idepth_min;
      a.o_idepth_max[i] = f.idepth_max;
      a.o_quality[i] = f.quality;
      a.o_status[i] = f.status;
      a.o_last_u[i] = f.last_u;
      a.o_last_v[i] = f.last_v;
      a.o_last_interval[i] = f.last_interval;
    }
    return;
  }
  const Lane L = interval(a, f);
  const bool do_search = !L.oob & !L.skipped & !L.badcond;

  float quality = f.quality;
  float best_u = 0.0f, best_v = 0.0f, best_e = 0.0f;
  bool is_outlier = false, interval_bad = false;
  float new_min = 0.0f, new_max = 0.0f;
  if (do_search) {                            // uniform over the group
    float color[kTaps];
#pragma unroll
    for (int p = 0; p < kTaps; ++p) {
      color[p] = __shfl_sync(group, f.color_g, p, kGroup);
    }
    const Search s = search<kSearch>(a, L, color, g, group);
    const float new_q = s.second / clamp_min(s.best_e, 1e-12f);
    quality = (new_q < quality) | (L.n_steps > 10) ? new_q : quality;
    best_e = s.best_e;
    best_u = __fmaf_rn(static_cast<float>(s.best), L.dxn, L.ptx0);
    best_v = __fmaf_rn(static_cast<float>(s.best), L.dyn, L.pty0);
    if ((kSearch == kNearestPacked || kSearch == kNearestRotated) &&
        a.refine > 0) {
      refine(a, L, color, g, group, s.best, best_e, best_u, best_v);
    }
    if (a.gn_iterations > 0) {
      gauss_newton(a, L, f, g & (kTaps - 1), group, best_u, best_v, best_e);
    }

    // the outlier test and the new interval
    is_outlier = !(best_e < f.energy_th * a.extra_slack);
    const bool use_x = L.dxn * L.dxn > L.dyn * L.dyn;
    const float px_lo = use_x ? __fmaf_rn(-L.error_px, L.dxn, best_u)
                              : __fmaf_rn(-L.error_px, L.dyn, best_v);
    const float px_hi = use_x ? __fmaf_rn(L.error_px, L.dxn, best_u)
                              : __fmaf_rn(L.error_px, L.dyn, best_v);
    const float pr_a = use_x ? L.pr[0] : L.pr[1];
    const float kt_a = use_x ? L.kt[0] : L.kt[1];
    const float id_lo = __fmaf_rn(L.pr[2], px_lo, -pr_a) /
                        __fmaf_rn(-L.kt[2], px_lo, kt_a);
    const float id_hi = __fmaf_rn(L.pr[2], px_hi, -pr_a) /
                        __fmaf_rn(-L.kt[2], px_hi, kt_a);
    new_min = nan_min(id_lo, id_hi);
    new_max = nan_max(id_lo, id_hi);
    interval_bad = !isfinite(new_min) | !isfinite(new_max) | (new_max < 0.0f);
  }
  if (g != 0) return;

  // the status precedence (the plain version's torch.where chain)
  const int status = f.status;
  const bool failed = do_search & (is_outlier | interval_bad);
  const bool good = do_search & !is_outlier & !interval_bad;
  int st = status;
  if (L.oob) st = kOob;
  if (!L.oob & L.skipped) st = kSkipped;
  if (L.badcond) st = kBadCondition;
  if (failed) st = (is_outlier & (status == kOutlier)) ? kOob : kOutlier;
  if (good) st = kGood;

  const bool sb = L.skipped | L.badcond;
  float last_u = good ? best_u : (sb ? (L.u_max + L.u_min) * 0.5f
                                     : f.last_u);
  float last_v = good ? best_v : (sb ? (L.v_max + L.v_min) * 0.5f
                                     : f.last_v);
  if (L.oob | failed) {
    last_u = -1.0f;
    last_v = -1.0f;
  }
  a.o_idepth_min[i] = good ? new_min : f.idepth_min;
  a.o_idepth_max[i] = good ? new_max : f.idepth_max;
  a.o_quality[i] = quality;
  a.o_status[i] = st;
  a.o_last_u[i] = last_u;
  a.o_last_v[i] = last_v;
  a.o_last_interval[i] = good ? 2.0f * L.error_px : (sb ? L.dist : 0.0f);
}

}  // namespace

extern "C" {

// ptrs: the 26 pointers of Args in order (u .. o_last_interval); ints: n,
// n_hosts, w, h, n_cap, search, refine, gn_iterations, then the pattern's
// 16 offsets (x0, y0, x1, ...); floats: max_pix_search, stepsize,
// slack_interval, min_improvement, huber_th, gn_threshold, extra_slack,
// x_hi, y_hi. Launches a group of 16 threads per lane on `stream` and
// returns the launch error (cudaError_t, 0 on success).
int ldso_immature_trace(void* const* ptrs, const int* ints,
                        const float* floats, void* stream) {
  for (int k = 0; k < 26; ++k) {
    if (ptrs[k] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto in = [&](int k) { return static_cast<const float*>(ptrs[k]); };
  const auto out = [&](int k) { return static_cast<float*>(ptrs[k]); };
  Args a;
  a.u = in(0);
  a.v = in(1);
  a.valid = static_cast<const bool*>(ptrs[2]);
  a.color = in(3);
  a.weights = in(4);
  a.gradH = in(5);
  a.idepth_min = in(6);
  a.idepth_max = in(7);
  a.quality = in(8);
  a.energy_th = in(9);
  a.status = static_cast<const int*>(ptrs[10]);
  a.last_u = in(11);
  a.last_v = in(12);
  a.last_interval = in(13);
  a.host = static_cast<const int*>(ptrs[14]);
  a.dI = in(15);
  a.KRKi = in(16);
  a.Kt = in(17);
  a.aff = in(18);
  a.o_idepth_min = out(19);
  a.o_idepth_max = out(20);
  a.o_quality = out(21);
  a.o_status = static_cast<int*>(ptrs[22]);
  a.o_last_u = out(23);
  a.o_last_v = out(24);
  a.o_last_interval = out(25);
  a.n = ints[0];
  a.n_hosts = ints[1];
  a.w = ints[2];
  a.h = ints[3];
  a.n_cap = ints[4];
  a.search = ints[5];
  a.refine = ints[6];
  a.gn_iterations = ints[7];
  for (int p = 0; p < kTaps; ++p) {
    a.patt[p][0] = ints[8 + 2 * p];
    a.patt[p][1] = ints[9 + 2 * p];
  }
  a.max_pix_search = floats[0];
  a.stepsize = floats[1];
  a.slack_interval = floats[2];
  a.min_improvement = floats[3];
  a.huber_th = floats[4];
  a.gn_threshold = floats[5];
  a.extra_slack = floats[6];
  a.x_hi = floats[7];
  a.y_hi = floats[8];
  if (a.n < 1 || a.n_hosts < 1 || a.w < 2 || a.h < 2 || a.n_cap < 1 ||
      a.n_cap > kMaxSteps || a.search < kPacked || a.search > kNearestRotated ||
      a.refine < 0 || a.refine > kMaxRefine || a.gn_iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (a.n + kLanesPerBlock - 1) / kLanesPerBlock;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.search) {
    case kPacked:
      immature_trace_kernel<kPacked><<<blocks, kThreads, 0, st>>>(a);
      break;
    case kRotated:
      immature_trace_kernel<kRotated><<<blocks, kThreads, 0, st>>>(a);
      break;
    case kNearestPacked:
      immature_trace_kernel<kNearestPacked><<<blocks, kThreads, 0, st>>>(
          a);
      break;
    default:
      immature_trace_kernel<kNearestRotated>
          <<<blocks, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
