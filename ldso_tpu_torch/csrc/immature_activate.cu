// K5: the keyframe's activation of the candidate arena, hand-written for
// Hopper (sm_90a). One launch per keyframe over every lane of the arena,
// from ldso_tpu_torch/ops/cuda_kernels.activate_arena.
//
// Replaces the per-lane part of `_activate_fused` of the JAX package
// (ldso_tpu/system/full_system.py:204): the gate `_gate_candidates`
// (:275), then `activate_arena` (ldso_tpu/frontend/immature.py:570),
// `activate` (:654) and `linearize_depth_residual` (:591), all inside one
// XLA program; it has no `pallas_call`. Its plain version is the port's
// frontend/immature.activate_arena_ref, which on the card runs as some
// thousands of small aten kernels.
//
// Function: for every lane i of the arena, with its host slot
// hs = clamp(host, 0, F - 1) and live = valid & host >= 0:
//   1. the gate against the newest keyframe at pyramid level 1
//      (activatePointsMT's candidate loop, FullSystem.cc:1089-1160): drop
//      (no idepth_max, or an outlier), can (a usable status, a narrow
//      interval, a good quality, a positive depth), kill; the depth
//      idm = (idepth_max + idepth_min) / 2, its projection K R K^-1
//      (u, v, 1) + K t idm with the host's tables, the pixel it rounds to,
//      and K1's distance map there against min_act_dist times the lane's
//      type; to_opt also needs host < nf and host != newest, remove
//      host < nf;
//   2. for a lane to optimise, the depth-only LM of optimizeImmaturePoint
//      (FullSystem.cc:892-1010): 1 + gn_iterations evaluations of the
//      residual against every window slot k (the tables Rs, ts, affs,
//      masks at [hs, k]), each the 8 pattern taps projected, sampled
//      bilinearly (3 channels), the Huber energy, Hdd and bd, the OOB and
//      outlier states; the LM's accept test, damping and convergence; ok
//      (finite, Hdd >= min_idepth_h_act) and the inlier count.
// It writes to_opt, remove, the idepth (the LM's where to_opt, else idm),
// ok and n_good per lane. A dead lane writes (false, false, idm, false,
// 0) and does nothing else.
//
// Every operation is the plain version's, in its order. The
// LM's residual rounds as the JAX package's jitted activation does on the
// CPU: the pattern rays times the focal lengths' float32 reciprocals (XLA
// turns a division by a constant into that multiply), each row of the
// projection fma(r1, y, r0 x) + r2, then + t idepth, the pixel
// fma(uu, fx, cx), the bilinear blend and the residual's affine model
// contracted, the depth derivative fma(dxI dr, t0 - t2 uu, dyI dr (t1 -
// t2 vv)) with both differences contracted (`__fmaf_rn` here, the plain
// version's math/rounding.fma). The gate's projection ((r0 u + r1 v) +
// r2, then + t idm), the 8-tap sums (the tree ((x0 + x1) + (x2 + x3)) +
// ((x4 + x5) + (x6 + x7))), the target sums (slot order from 0.0) and a
// Python scalar over a tensor (its reciprocal times the scalar) are
// written out alike in both; this file is built with --fmad=false, so it
// contracts only where it says `__fmaf_rn`. On the same inputs the two
// give the same bits; tests/torch_kernel_checks.activate_err still allows
// a lane to differ where the plain version's own numbers tie.
//
// What bounds it on this card: bytes, by the function's own count. At
// 640x480 with 4,096 lanes and 8 window slots, the work is at most 4,096 x
// 8 x 8 taps x 4 evaluations, about 1 M bilinear taps of 3 channels and
// some 100 M float operations (1.5 us at 67 TFLOP/s). The bytes are the
// arena's lane state (48 bytes a live lane for the gate and the 11
// written, 68 more for a lane the LM runs on), the tables, the distance
// map's words the gate reads and the window images' pixels the taps read
// (at most 8 x 3.7 MB, far fewer in a run): 1.7 us at 3.35 TB/s on the
// bench scene's arena against 8 slots (chip_smoke.activate_bound_ms). The
// plain version's time is its launches, not its arithmetic.
//
// What held the first design (one warp per lane, slot k on thread k, 4
// lanes a block; globaltimer stamps of each lane's phases from a stamped
// copy, not kept, on an H100 at 700 W): on the bench scene's arena
// against 8 slots its blocks ran in two waves (115 registers, 16 lanes an
// SM at once; the last lanes started 17.5 us after the first), and an
// optimised lane took 14.8 us (median): each LM
// evaluation 2.8-3.3 us, the first 4.9 with the tables' trip. Each of its
// 8 working threads ran a slot's 8 taps in series; 24 of 32 threads
// idled.
//
// The design: one launch for the whole arena, one warp per lane and a
// block per lane, so a lane that leaves early frees its place at once:
//   * the warp loads the lane's fields alike in one trip, then the gate's
//     and the LM's host tables in a second, and computes the gate in one
//     instruction stream, once per lane; a dead lane writes its outputs
//     after the first trip, a lane the gate drops after the second;
//   * a lane the gate keeps loads its distance-map word together with the
//     first evaluation's pixels (that evaluation, at idm, does not wait on
//     the map), and a lane whose distance test fails discards it;
//   * the LM: window slot j of a group of 8 on threads 4j..4j+3, thread
//     4j + q holding taps 2q and 2q + 1, so at 8 slots every thread works;
//     each thread adds its pair, then the xor shuffles 1 and 2 over the 4
//     threads give ((x0 + x1) + (x2 + x3)) + ((x4 + x5) + (x6 + x7)),
//     sum8's tree, and the all-taps-in-bounds test is an AND over them;
//     the 24 pixel words of a thread's two taps go out together;
//   * each evaluation's three sums over the slots fetch the 8 slots'
//     values by independent shuffles and add them in slot order from
//     0.0, so the dependent chain is one add a slot; the inlier count is a
//     ballot over the slots' leading threads;
//   * past 8 slots (up to 32) the slots run in groups of 8, in slot order,
//     each group's tables read again at each evaluation;
//   * thread 0 writes the lane's outputs.
// Nothing is summed across lanes, so there are no atomics. Stamped again,
// an evaluation takes 1.5 us and an optimised lane 7.6 us; at 118
// registers an SM still holds 16 lanes at once, so the bench's 2,533
// optimised lanes still run in two waves (the last lanes start 10.0 us
// after the first): the next lever. Held to 96 registers or 64 (copies not
// kept) it ran no faster.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 8;
constexpr int kGroupSlots = 8;                  // slots a group, 4 threads each
constexpr int kMaxSlots = 32;                   // cuda_kernels.ACTIVATE_MAX_SLOTS
constexpr unsigned kFull = 0xffffffffu;

// immature.IPS_*
constexpr int kGood = 0;
constexpr int kOob = 1;
constexpr int kOutlier = 2;
constexpr int kSkipped = 3;
constexpr int kBadCondition = 4;

struct Args {
  // the arena (N lanes)
  const float* u;
  const float* v;
  const bool* valid;
  const float* color;        // (N, 8)
  const float* weights;      // (N, 8)
  const float* idepth_min;
  const float* idepth_max;
  const float* quality;
  const float* energy_th;
  const int* status;
  const float* last_interval;
  const int* my_type;
  const int* host;
  // the gate: K1's map (h1, w1), KRKi (F, 3, 3), Kt (F, 3), marg (F,)
  const float* dist_map;
  const float* KRKi;
  const float* Kt;
  const bool* marg;
  // the LM: Rs (F, F, 3, 3), ts (F, F, 3), affs (F, F, 2), masks (F, F),
  // the window images (F, H, W, 3) and min_act_dist (one float)
  const float* Rs;
  const float* ts;
  const float* affs;
  const bool* masks;
  const float* dIs;
  const float* min_act_dist;
  // the outputs (N lanes)
  bool* o_to_opt;
  bool* o_remove;
  float* o_idepth;
  bool* o_ok;
  int* o_n_good;
  int n, n_slots, w, h, w1, h1, newest, nf, gn_iterations;
  // calibration, the bilinear clamps W - 1.001 and H - 1.001, and Config
  // values, as float32
  float fx, fy, cx, cy, x_hi, y_hi, min_quality, huber_th, min_h;
  int patt[kTaps][2];
};

// torch.clamp: a NaN stays NaN
__device__ __forceinline__ float clamp_f(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// the plain version's th / x is x.reciprocal() * th (Tensor.__rtruediv__)
__device__ __forceinline__ float huber_w(float ar, float th) {
  return ar < th ? 1.0f : (1.0f / clamp_min(ar, 1e-12f)) * th;
}

// sum8's tree over a slot's 4 threads, each holding the sum of its pair of
// taps: xor 1 forms (x0 + x1) + (x2 + x3) and (x4 + x5) + (x6 + x7), xor 2
// their sum (a + b and b + a being the same bits)
__device__ __forceinline__ float slot_sum8(float pair) {
  pair = pair + __shfl_xor_sync(kFull, pair, 1);
  return pair + __shfl_xor_sync(kFull, pair, 2);
}

// one (host, target) pair's tables, as the threads of its slot hold them
struct Target {
  float R[9], t[3], aff[2];
  const float* img;
  bool live;
};

__device__ __forceinline__ Target load_target(const Args& a, int hs,
                                              int slot) {
  Target T;
  T.live = false;
  T.img = a.dIs;
  if (slot < a.n_slots) {
    const int pair = hs * a.n_slots + slot;
#pragma unroll
    for (int k = 0; k < 9; ++k) T.R[k] = __ldg(a.Rs + 9 * pair + k);
#pragma unroll
    for (int k = 0; k < 3; ++k) T.t[k] = __ldg(a.ts + 3 * pair + k);
    T.aff[0] = __ldg(a.affs + 2 * pair);
    T.aff[1] = __ldg(a.affs + 2 * pair + 1);
    T.live = a.masks[pair];
    T.img = a.dIs + static_cast<size_t>(slot) * a.h * a.w * 3;
  }
  return T;
}

// The lane's pattern rays, colours and weights for this thread's two taps
struct Taps {
  float x[2], y[2], color[2], weight[2];
};

struct Sums {
  float e, H, b;
  int n_in;                  // slots with an inlier residual
};

// linearize_depth_residual's two taps of this thread against target T at
// idepth: the pair sums of the energy, Hdd and bd terms, and whether both
// taps are in bounds with a finite pixel. Both taps' 24 pixel words are
// loaded before any is used, so they are in flight together.
__device__ __forceinline__ void tap_pair(const Args& a, const Target& T,
                                         const Taps& P, float idepth,
                                         float& e, float& hd, float& bd,
                                         bool& ok) {
  const float W = static_cast<float>(a.w), H = static_cast<float>(a.h);
  float dr[2], uu[2], vv[2], dx[2], dy[2], wd[2][3][4];
  bool inb[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float p0 = (__fmaf_rn(T.R[1], P.y[k], T.R[0] * P.x[k]) + T.R[2]) +
                     T.t[0] * idepth;
    const float p1 = (__fmaf_rn(T.R[4], P.y[k], T.R[3] * P.x[k]) + T.R[5]) +
                     T.t[1] * idepth;
    const float p2 = (__fmaf_rn(T.R[7], P.y[k], T.R[6] * P.x[k]) + T.R[8]) +
                     T.t[2] * idepth;
    dr[k] = 1.0f / p2;
    uu[k] = p0 * dr[k];
    vv[k] = p1 * dr[k];
    const float Ku = __fmaf_rn(uu[k], a.fx, a.cx);
    const float Kv = __fmaf_rn(vv[k], a.fy, a.cy);
    inb[k] = (dr[k] > 0.0f) & (Ku > 1.1f) & (Kv > 1.1f) & (Ku < W - 3.0f) &
             (Kv < H - 3.0f);
    // interp.bilinear's cell: the W - 1.001 clamp, a NaN coordinate at
    // cell 0 with its NaN weights
    const float x = clamp_f(Ku, 0.0f, a.x_hi);
    const float y = clamp_f(Kv, 0.0f, a.y_hi);
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const int xi = isnan(x0) ? 0 : static_cast<int>(x0);
    const int yi = isnan(y0) ? 0 : static_cast<int>(y0);
    dx[k] = x - x0;
    dy[k] = y - y0;
    const float* p00 = T.img + 3 * (yi * a.w + xi);
    const float* p10 = p00 + 3 * a.w;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      wd[k][c][0] = __ldg(p00 + c);
      wd[k][c][1] = __ldg(p00 + 3 + c);
      wd[k][c][2] = __ldg(p10 + c);
      wd[k][c][3] = __ldg(p10 + 3 + c);
    }
  }
  float et[2], ht[2], bt[2];
  ok = true;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    // immature._bilinear of the three channels: each of the last three
    // products contracted into the sum before it
    float hit[3];
    const float dxdy = dx[k] * dy[k];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s = __fmaf_rn(dxdy, wd[k][c][3], (dy[k] - dxdy) * wd[k][c][2]);
      s = __fmaf_rn(dx[k] - dxdy, wd[k][c][1], s);
      hit[c] = __fmaf_rn(1.0f - dx[k] - dy[k] + dxdy, wd[k][c][0], s);
    }
    const bool pix_ok = inb[k] & isfinite(hit[0]);
    ok = ok & pix_ok;
    const float r = hit[0] - __fmaf_rn(T.aff[0], P.color[k], T.aff[1]);
    const float hw = huber_w(fabsf(r), a.huber_th);
    const float w2 = P.weight[k] * P.weight[k];
    et[k] = pix_ok ? w2 * hw * r * r * (2.0f - hw) : 0.0f;
    const float dxI = hit[1] * a.fx;
    const float dyI = hit[2] * a.fy;
    const float d =
        __fmaf_rn(dxI * dr[k], __fmaf_rn(-T.t[2], uu[k], T.t[0]),
                  dyI * dr[k] * __fmaf_rn(-T.t[2], vv[k], T.t[1]));
    const float hww = hw * w2;
    ht[k] = pix_ok ? hww * d * d : 0.0f;
    bt[k] = pix_ok ? hww * r * d : 0.0f;
  }
  e = et[0] + et[1];
  hd = ht[0] + ht[1];
  bd = bt[0] + bt[1];
}

// all_targets at idepth: every slot's residual (masked: 0 and OOB where it
// is not a target), the three sums over the slots in slot order from 0.0
// and the slots with an inlier. Slot 8m + j on threads 4j..4j+3; group 0's
// tables are T0, a later group's are read here.
__device__ Sums evaluate(const Args& a, const Target& T0, int hs,
                         const Taps& P, float energy_th, float idepth,
                         float slack, int t) {
  const int j = t >> 2;
  Sums s{0.0f, 0.0f, 0.0f, 0};
  const int groups = (a.n_slots + kGroupSlots - 1) / kGroupSlots;
#pragma unroll 1
  for (int m = 0; m < groups; ++m) {
    const int slot = kGroupSlots * m + j;
    const Target T = m == 0 ? T0 : load_target(a, hs, slot);
    float e = 0.0f, hd = 0.0f, bd = 0.0f;
    bool ok = true;
    if (T.live) tap_pair(a, T, P, idepth, e, hd, bd, ok);
    const float energy = slot_sum8(e);
    hd = slot_sum8(hd);
    bd = slot_sum8(bd);
    ok = ok & __shfl_xor_sync(kFull, ok, 1);
    ok = ok & __shfl_xor_sync(kFull, ok, 2);
    const float lim = energy_th * slack;
    const bool over = energy > lim;
    // a slot that is not a target gives 0 and OOB
    const float re = T.live ? (over ? lim : energy) : 0.0f;
    const float rh = T.live & ok ? hd : 0.0f;
    const float rb = T.live & ok ? bd : 0.0f;
    const bool in = T.live & ok & !over;
    s.n_in += __popc(__ballot_sync(kFull, ((t & 3) == 0) & in));
    // the slots' values by independent shuffles, then added in slot order
    float ve[kGroupSlots], vh[kGroupSlots], vb[kGroupSlots];
#pragma unroll
    for (int k = 0; k < kGroupSlots; ++k) {
      ve[k] = __shfl_sync(kFull, re, 4 * k);
      vh[k] = __shfl_sync(kFull, rh, 4 * k);
      vb[k] = __shfl_sync(kFull, rb, 4 * k);
    }
#pragma unroll
    for (int k = 0; k < kGroupSlots; ++k) {
      if (kGroupSlots * m + k < a.n_slots) {
        s.e = s.e + ve[k];
        s.H = s.H + vh[k];
        s.b = s.b + vb[k];
      }
    }
  }
  return s;
}

__global__ void __launch_bounds__(32) immature_activate_kernel(const Args a) {
  const int t = threadIdx.x;
  const int i = blockIdx.x;
  // the lane's fields in one trip, alike on every thread; taps 2q and
  // 2q + 1 on thread 4j + q
  const int q = t & 3;
  const bool valid = a.valid[i];
  const int hst = __ldg(a.host + i);
  const float id_max = __ldg(a.idepth_max + i);
  const float id_min = __ldg(a.idepth_min + i);
  const int st = __ldg(a.status + i);
  const float last_interval = __ldg(a.last_interval + i);
  const float quality = __ldg(a.quality + i);
  const float u = __ldg(a.u + i), v = __ldg(a.v + i);
  const int my_type = __ldg(a.my_type + i);
  const float eth = __ldg(a.energy_th + i);
  const float min_act = __ldg(a.min_act_dist);
  Taps P;
  // the focal lengths' float32 reciprocals, one correctly rounded division
  // each (immature._focal_reciprocal)
  const float rfx = 1.0f / a.fx, rfy = 1.0f / a.fy;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int p = 2 * q + k;
    P.x[k] = (u + static_cast<float>(a.patt[p][0]) - a.cx) * rfx;
    P.y[k] = (v + static_cast<float>(a.patt[p][1]) - a.cy) * rfy;
    P.color[k] = __ldg(a.color + kTaps * i + p);
    P.weight[k] = __ldg(a.weights + kTaps * i + p);
  }
  const bool finite_max = isfinite(id_max);
  const float idm = 0.5f * ((finite_max ? id_max : 0.0f) + id_min);
  if (!(valid & (hst >= 0))) {                // a dead lane
    if (t == 0) {
      a.o_to_opt[i] = false;
      a.o_remove[i] = false;
      a.o_idepth[i] = idm;
      a.o_ok[i] = false;
      a.o_n_good[i] = 0;
    }
    return;
  }
  const int hs = min(hst, a.n_slots - 1);

  // the host's tables in one trip: the gate's, and the LM's first group
  const float* K = a.KRKi + 9 * hs;
  const float* kt = a.Kt + 3 * hs;
  float Kr[9], ktr[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) Kr[k] = __ldg(K + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) ktr[k] = __ldg(kt + k);
  const bool marg = a.marg[hs];
  const Target T0 = load_target(a, hs, t >> 2);

  // the gate (gate_candidates), alike on every thread
  const bool drop = !finite_max | (st == kOutlier);
  bool can = !drop &
             ((st == kGood) | (st == kSkipped) | (st == kBadCondition) |
              (st == kOob)) &
             (last_interval < 8.0f) & (quality > a.min_quality) &
             (id_max + id_min > 0.0f);
  bool kill = !drop & !can & (marg | (st == kOob));
  const float q0 = (Kr[0] * u + Kr[1] * v + Kr[2]) + ktr[0] * idm;
  const float q1 = (Kr[3] * u + Kr[4] * v + Kr[5]) + ktr[1] * idm;
  const float q2 = (Kr[6] * u + Kr[7] * v + Kr[8]) + ktr[2] * idm;
  const bool z_ok = q2 > 1e-6f;
  const float zs = z_ok ? q2 : 1.0f;
  const float uu = q0 / zs;
  const float vv = q1 / zs;
  // Tensor.to(int64) then torch.clamp
  const long long ui = min(max(static_cast<long long>(uu + 0.5f), 0LL),
                           static_cast<long long>(a.w1 - 1));
  const long long vi = min(max(static_cast<long long>(vv + 0.5f), 0LL),
                           static_cast<long long>(a.h1 - 1));
  const bool inb = z_ok & (ui > 0) & (vi > 0) & (ui < a.w1) & (vi < a.h1);
  kill = kill | (can & !inb);
  can = can & inb;
  const bool remove = (drop | kill) & (hst < a.nf);
  const bool kept = can & (hst < a.nf) & (hst != a.newest);
  // the distance test's map word, and the first evaluation (at idm, which
  // does not wait on it) in the same trip
  float dist = 0.0f;
  Sums c{0.0f, 0.0f, 0.0f, 0};
  if (kept) {                                 // uniform over the warp
    dist = __ldg(a.dist_map + vi * a.w1 + ui) + (uu - floorf(uu));
    c = evaluate(a, T0, hs, P, eth, idm, 1000.0f, t);
  }
  const bool to_opt = kept &
                      (dist >= min_act * static_cast<float>(my_type));
  if (!to_opt) {                              // uniform over the warp
    if (t == 0) {
      a.o_to_opt[i] = false;
      a.o_remove[i] = remove;
      a.o_idepth[i] = idm;
      a.o_ok[i] = false;
      a.o_n_good[i] = 0;
    }
    return;
  }

  // the depth-only LM
  float idepth = idm;
  float lam = 0.1f;
  bool done = false;
  for (int it = 0; it < a.gn_iterations; ++it) {
    const float step = (1.0f / (c.H * (1.0f + lam) + 1e-12f)) * c.b;
    const float new_id = idepth - step;
    const Sums c2 = evaluate(a, T0, hs, P, eth, new_id, 1.0f, t);
    const bool accept = c2.e < c.e;
    const bool upd = !done;
    const bool converged = fabsf(step) < 1e-4f * fabsf(idepth);
    if (accept & upd) {
      idepth = new_id;
      c = c2;
    }
    if (upd) lam = accept ? lam * 0.5f : lam * 5.0f;
    done = done | converged;
  }
  if (t == 0) {
    a.o_to_opt[i] = true;
    a.o_remove[i] = remove;
    a.o_idepth[i] = idepth;
    a.o_ok[i] = isfinite(c.e) & isfinite(idepth) & (c.H >= a.min_h);
    a.o_n_good[i] = c.n_in;
  }
}

}  // namespace

extern "C" {

// ptrs: the 28 pointers of Args in order (u .. o_n_good); ints: n,
// n_slots, w, h, w1, h1, newest, nf, gn_iterations, then the pattern's 16
// offsets (x0, y0, x1, ...); floats: fx, fy, cx, cy, x_hi, y_hi,
// min_quality, huber_th, min_h. Launches one warp per lane on `stream` and
// returns the launch error (cudaError_t, 0 on success).
int ldso_immature_activate(void* const* ptrs, const int* ints,
                           const float* floats, void* stream) {
  for (int k = 0; k < 28; ++k) {
    if (ptrs[k] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto in = [&](int k) { return static_cast<const float*>(ptrs[k]); };
  const auto flag = [&](int k) { return static_cast<const bool*>(ptrs[k]); };
  Args a;
  a.u = in(0);
  a.v = in(1);
  a.valid = flag(2);
  a.color = in(3);
  a.weights = in(4);
  a.idepth_min = in(5);
  a.idepth_max = in(6);
  a.quality = in(7);
  a.energy_th = in(8);
  a.status = static_cast<const int*>(ptrs[9]);
  a.last_interval = in(10);
  a.my_type = static_cast<const int*>(ptrs[11]);
  a.host = static_cast<const int*>(ptrs[12]);
  a.dist_map = in(13);
  a.KRKi = in(14);
  a.Kt = in(15);
  a.marg = flag(16);
  a.Rs = in(17);
  a.ts = in(18);
  a.affs = in(19);
  a.masks = flag(20);
  a.dIs = in(21);
  a.min_act_dist = in(22);
  a.o_to_opt = static_cast<bool*>(ptrs[23]);
  a.o_remove = static_cast<bool*>(ptrs[24]);
  a.o_idepth = static_cast<float*>(ptrs[25]);
  a.o_ok = static_cast<bool*>(ptrs[26]);
  a.o_n_good = static_cast<int*>(ptrs[27]);
  a.n = ints[0];
  a.n_slots = ints[1];
  a.w = ints[2];
  a.h = ints[3];
  a.w1 = ints[4];
  a.h1 = ints[5];
  a.newest = ints[6];
  a.nf = ints[7];
  a.gn_iterations = ints[8];
  for (int p = 0; p < kTaps; ++p) {
    a.patt[p][0] = ints[9 + 2 * p];
    a.patt[p][1] = ints[10 + 2 * p];
  }
  a.fx = floats[0];
  a.fy = floats[1];
  a.cx = floats[2];
  a.cy = floats[3];
  a.x_hi = floats[4];
  a.y_hi = floats[5];
  a.min_quality = floats[6];
  a.huber_th = floats[7];
  a.min_h = floats[8];
  if (a.n < 1 || a.n_slots < 1 || a.n_slots > kMaxSlots || a.w < 2 ||
      a.h < 2 || a.w1 < 1 || a.h1 < 1 || a.gn_iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  immature_activate_kernel<<<a.n, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
