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
// Every operation is the plain version's, in its order: the plain version
// writes its projections ((r0 x + r1 y) + r2, then + t idepth), its 8-tap
// sums (the tree ((x0 + x1) + (x2 + x3)) + ((x4 + x5) + (x6 + x7))) and its
// target sums (slot order from 0.0) out in one order, a Python scalar over
// a tensor is its reciprocal times the scalar there and here, the division
// by the focal length is a true division in both, and this file is built
// with --fmad=false, so no multiply and add is contracted. On the same
// inputs the two give the same bits; tests/torch_kernel_checks.
// activate_err still allows a lane to differ where the plain version's own
// numbers tie.
//
// What bounds it on this card: bytes. At 640x480 with 4,096 lanes and 8
// window slots, the work is at most 4,096 x 8 x 8 taps x 4 evaluations,
// about 1 M bilinear taps of 3 channels and some 100 M float operations
// (1.5 us at 67 TFLOP/s). The bytes are the arena's lane state (48 bytes
// a live lane for the gate and the 11 written, 68 more for a lane the LM
// runs on), the tables, the distance map's words the gate reads and the
// window images' pixels the taps read (at most 8 x 3.7 MB, far fewer in a
// run): 1.7 us at 3.35 TB/s on the bench scene's arena against 8 slots
// (chip_smoke.activate_bound_ms). The plain version's time is its
// launches, not its arithmetic.
//
// What the design does about that: one launch for the whole arena, each
// lane's state read once, the 5 outputs written once, the pixels read
// through the read-only cache (`__ldg`; the window images fit in the 50 MB
// L2). One warp per lane:
//   * every thread computes the lane's gate itself (a few dozen scalar
//     operations), so the warp decides alike and nothing is broadcast;
//   * thread k < F evaluates window slot k, its 8 taps in order and summed
//     in the tree; a slot that is not a target is skipped;
//   * each evaluation's three sums over the slots are taken in slot order
//     from 0.0 by shuffles from threads 0..F-1, so every thread holds them
//     and runs the LM's scalar steps itself;
//   * the inlier count is a ballot over the slots' states;
//   * thread 0 writes the lane's outputs.
// Nothing is summed across lanes, so there are no atomics.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 8;
constexpr int kMaxSlots = 32;                   // one slot per thread
constexpr int kLanesPerBlock = 4;               // one warp per lane
constexpr unsigned kFull = 0xffffffffu;

// immature.IPS_*
constexpr int kGood = 0;
constexpr int kOob = 1;
constexpr int kOutlier = 2;
constexpr int kSkipped = 3;
constexpr int kBadCondition = 4;
// immature.RES_*
constexpr int kResIn = 0;
constexpr int kResOob = 1;
constexpr int kResOutlier = 2;

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

// immature._sum8's tree
__device__ __forceinline__ float sum8(const float* x) {
  return ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
}

// the slots' values summed in slot order from 0.0, slot k's on thread k;
// every thread gets the sum
__device__ __forceinline__ float slot_sum(float x, int n_slots) {
  float s = 0.0f;
  for (int k = 0; k < n_slots; ++k) {
    s = s + __shfl_sync(kFull, x, k);
  }
  return s;
}

// the plain version's th / x is x.reciprocal() * th (Tensor.__rtruediv__)
__device__ __forceinline__ float huber_w(float ar, float th) {
  return ar < th ? 1.0f : (1.0f / clamp_min(ar, 1e-12f)) * th;
}

// interp.bilinear of the three channels of image `img` at (x, y): the
// W - 1.001 clamp, a NaN coordinate at cell 0 with its NaN weights
__device__ __forceinline__ void bilinear3(const Args& a, const float* img,
                                          float x, float y, float* out) {
  x = clamp_f(x, 0.0f, a.x_hi);
  y = clamp_f(y, 0.0f, a.y_hi);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const int xi = isnan(x0) ? 0 : static_cast<int>(x0);
  const int yi = isnan(y0) ? 0 : static_cast<int>(y0);
  const float dx = x - x0;
  const float dy = y - y0;
  const float dxdy = dx * dy;
  const float* p00 = img + 3 * (yi * a.w + xi);
  const float* p10 = p00 + 3 * a.w;
  for (int c = 0; c < 3; ++c) {
    const float v00 = __ldg(p00 + c), v01 = __ldg(p00 + 3 + c);
    const float v10 = __ldg(p10 + c), v11 = __ldg(p10 + 3 + c);
    out[c] = dxdy * v11 + (dy - dxdy) * v10 + (dx - dxdy) * v01 +
             (1.0f - dx - dy + dxdy) * v00;
  }
}

// one slot's table and the lane's pattern rays, as a thread holds them
struct Target {
  float R[9], t[3], aff[2];
  const float* img;
  bool live;
};

struct Residual {
  float e, H, b;
  int state;
};

// linearize_depth_residual of the lane against one target at idepth
__device__ Residual residual(const Args& a, const Target& T, const float* x,
                             const float* y, const float* color,
                             const float* weights, float energy_th,
                             float idepth, float slack) {
  const float W = static_cast<float>(a.w), H = static_cast<float>(a.h);
  float e_t[kTaps], h_t[kTaps], b_t[kTaps];
  bool all_ok = true;
  for (int p = 0; p < kTaps; ++p) {
    const float p0 = (T.R[0] * x[p] + T.R[1] * y[p] + T.R[2]) +
                     T.t[0] * idepth;
    const float p1 = (T.R[3] * x[p] + T.R[4] * y[p] + T.R[5]) +
                     T.t[1] * idepth;
    const float p2 = (T.R[6] * x[p] + T.R[7] * y[p] + T.R[8]) +
                     T.t[2] * idepth;
    const float dr = 1.0f / p2;
    const float uu = p0 * dr;
    const float vv = p1 * dr;
    const float Ku = uu * a.fx + a.cx;
    const float Kv = vv * a.fy + a.cy;
    const bool inb = (dr > 0.0f) & (Ku > 1.1f) & (Kv > 1.1f) &
                     (Ku < W - 3.0f) & (Kv < H - 3.0f);
    float hit[3];
    bilinear3(a, T.img, Ku, Kv, hit);
    const bool pix_ok = inb & isfinite(hit[0]);
    all_ok = all_ok & pix_ok;
    const float r = hit[0] - (T.aff[0] * color[p] + T.aff[1]);
    const float hw = huber_w(fabsf(r), a.huber_th);
    const float w2 = weights[p] * weights[p];
    e_t[p] = pix_ok ? w2 * hw * r * r * (2.0f - hw) : 0.0f;
    const float dxI = hit[1] * a.fx;
    const float dyI = hit[2] * a.fy;
    const float d = dxI * dr * (T.t[0] - T.t[2] * uu) +
                    dyI * dr * (T.t[1] - T.t[2] * vv);
    const float hww = hw * w2;
    h_t[p] = pix_ok ? hww * d * d : 0.0f;
    b_t[p] = pix_ok ? hww * r * d : 0.0f;
  }
  Residual out;
  const float energy = sum8(e_t);
  const float lim = energy_th * slack;
  const bool over = energy > lim;
  out.e = over ? lim : energy;
  out.state = !all_ok ? kResOob : (over ? kResOutlier : kResIn);
  out.H = all_ok ? sum8(h_t) : 0.0f;
  out.b = all_ok ? sum8(b_t) : 0.0f;
  return out;
}

// all_targets: this thread's slot (masked: 0 and OOB where it is not a
// target), and the three sums over the slots
struct Sums {
  float e, H, b;
  int state;
};
__device__ Sums evaluate(const Args& a, const Target& T, int slot,
                         const float* x, const float* y, const float* color,
                         const float* weights, float energy_th,
                         float idepth, float slack) {
  Residual r{0.0f, 0.0f, 0.0f, kResOob};
  if (slot < a.n_slots && T.live) {
    r = residual(a, T, x, y, color, weights, energy_th, idepth, slack);
  }
  Sums s;
  s.e = slot_sum(r.e, a.n_slots);
  s.H = slot_sum(r.H, a.n_slots);
  s.b = slot_sum(r.b, a.n_slots);
  s.state = r.state;
  return s;
}

__global__ void __launch_bounds__(32 * kLanesPerBlock)
    immature_activate_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kLanesPerBlock + (threadIdx.x >> 5);
  if (i >= a.n) return;                       // whole warps
  const float id_max = a.idepth_max[i];
  const float id_min = a.idepth_min[i];
  const bool finite_max = isfinite(id_max);
  const float idm = 0.5f * ((finite_max ? id_max : 0.0f) + id_min);
  const int hst = a.host[i];
  if (!(a.valid[i] & (hst >= 0))) {           // a dead lane
    if (lane == 0) {
      a.o_to_opt[i] = false;
      a.o_remove[i] = false;
      a.o_idepth[i] = idm;
      a.o_ok[i] = false;
      a.o_n_good[i] = 0;
    }
    return;
  }
  const int hs = min(hst, a.n_slots - 1);

  // the gate (gate_candidates), alike on every thread
  const int st = a.status[i];
  const bool drop = !finite_max | (st == kOutlier);
  bool can = !drop &
             ((st == kGood) | (st == kSkipped) | (st == kBadCondition) |
              (st == kOob)) &
             (a.last_interval[i] < 8.0f) & (a.quality[i] > a.min_quality) &
             (id_max + id_min > 0.0f);
  bool kill = !drop & !can & (a.marg[hs] | (st == kOob));
  const float u = a.u[i], v = a.v[i];
  const float* K = a.KRKi + 9 * hs;
  const float* kt = a.Kt + 3 * hs;
  const float q0 = (K[0] * u + K[1] * v + K[2]) + kt[0] * idm;
  const float q1 = (K[3] * u + K[4] * v + K[5]) + kt[1] * idm;
  const float q2 = (K[6] * u + K[7] * v + K[8]) + kt[2] * idm;
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
  const float dist = __ldg(a.dist_map + vi * a.w1 + ui) + (uu - floorf(uu));
  const bool to_opt = can &
                      (dist >= *a.min_act_dist *
                                   static_cast<float>(a.my_type[i])) &
                      (hst < a.nf) & (hst != a.newest);
  const bool remove = (drop | kill) & (hst < a.nf);
  if (!to_opt) {                              // uniform over the warp
    if (lane == 0) {
      a.o_to_opt[i] = false;
      a.o_remove[i] = remove;
      a.o_idepth[i] = idm;
      a.o_ok[i] = false;
      a.o_n_good[i] = 0;
    }
    return;
  }

  // the depth-only LM; thread `lane` evaluates slot `lane`
  Target T;
  T.live = false;
  T.img = a.dIs;
  if (lane < a.n_slots) {
    const int pair = hs * a.n_slots + lane;
    for (int k = 0; k < 9; ++k) T.R[k] = a.Rs[9 * pair + k];
    for (int k = 0; k < 3; ++k) T.t[k] = a.ts[3 * pair + k];
    T.aff[0] = a.affs[2 * pair];
    T.aff[1] = a.affs[2 * pair + 1];
    T.live = a.masks[pair];
    T.img = a.dIs + static_cast<size_t>(lane) * a.h * a.w * 3;
  }
  float x[kTaps], y[kTaps], color[kTaps], weights[kTaps];
  for (int p = 0; p < kTaps; ++p) {
    // a true division by the focal length, as the plain version's by a
    // 0-d tensor
    x[p] = (u + static_cast<float>(a.patt[p][0]) - a.cx) / a.fx;
    y[p] = (v + static_cast<float>(a.patt[p][1]) - a.cy) / a.fy;
    color[p] = a.color[kTaps * i + p];
    weights[p] = a.weights[kTaps * i + p];
  }
  const float eth = a.energy_th[i];

  float idepth = idm;
  Sums c = evaluate(a, T, lane, x, y, color, weights, eth, idepth, 1000.0f);
  float lam = 0.1f;
  bool done = false;
  for (int it = 0; it < a.gn_iterations; ++it) {
    const float step = (1.0f / (c.H * (1.0f + lam) + 1e-12f)) * c.b;
    const float new_id = idepth - step;
    const Sums c2 =
        evaluate(a, T, lane, x, y, color, weights, eth, new_id, 1.0f);
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
  const unsigned good = __ballot_sync(
      kFull, (lane < a.n_slots) & T.live & (c.state == kResIn));
  if (lane == 0) {
    a.o_to_opt[i] = true;
    a.o_remove[i] = remove;
    a.o_idepth[i] = idepth;
    a.o_ok[i] = isfinite(c.e) & isfinite(idepth) & (c.H >= a.min_h);
    a.o_n_good[i] = __popc(good);
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
  const int blocks = (a.n + kLanesPerBlock - 1) / kLanesPerBlock;
  immature_activate_kernel<<<blocks, 32 * kLanesPerBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
