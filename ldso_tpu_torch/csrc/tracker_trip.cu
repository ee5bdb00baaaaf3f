// One trip of the coarse tracker (warp, residual, 8x8 reduce) with the LM
// control around it, hand-written for Hopper (sm_90a). Every trip of
// ldso_tpu_torch/frontend/tracker._level_block is one launch of this kernel.
//
// Replaces the fused XLA regions that the JAX package evaluates per trip of
// `_level_block` in ldso_tpu/frontend/tracker.py (:319): `_calc_res` then
// `_calc_gs` (:168-292; calcRes and calcGSSSE, CoarseTracker.cc:440-632),
// and around them the cutoff loop's body and the LM loop's body (`_solve_inc`
// :295, `lie.se3_exp`, the accept test and the selects). It has no
// `pallas_call`. Three modes, each the function of a plain version in
// ldso_tpu_torch/frontend/tracker.py, for S sequences of B members each:
//   * trip (tracker_trip_ref): stats, H and b at the member's T and aff;
//   * cutoff (cutoff_trip_ref): one trip of the cutoff adaptation; a member
//     runs when it is `run`, more than 60% saturated and its cutoff
//     multiplier is under 50: it doubles the multiplier and takes the
//     trip's stats, H and b at coarse_cutoff_th times it;
//   * lm (lm_trip_ref): one LM iteration of a member that is not done: the
//     damped solve over the active parameters, the extrapolation, the
//     scaling, non-finite increments set to 0, se3_exp(inc[:6]) @ T and
//     aff + inc[6:8], the trip there, the accept test on the mean energy
//     E / max(n, 1), the selects of T, aff, H, b and stats, the lambda
//     update and done = |inc| <= 1e-3.
// A member with nothing to do (not more, or done) passes its state through
// bit for bit, as the plain version's masks keep it.
// The trip itself:
//   * rel = affine.from_to(ref exposure, new exposure, ref aff, aff), with
//     the zero-exposure rule;
//   * the warp p' = R K^-1 [x y 1] + t idepth, (u, v) = p'.xy / p'.z,
//     (Ku, Kv) = (fx u + cx, fy v + cy), new idepth = idepth / p'.z;
//   * ok = valid & Ku > 2 & Kv > 2 & Ku < w-3 & Kv < h-3 & new idepth > 0;
//   * (I, dx, dy) sampled bilinearly with ops/interp.bilinear's weight
//     factorisation and its W-1.001 clamp; ok &= isfinite(I);
//   * r = I - (a_rel color + b_rel), the Huber weight hw, saturation at
//     the cutoff with max_energy = 2 huber cutoff - huber^2;
//   * stats = [E, numTerms, flowT, 0, flowRT, numSat / max(numTerms, 1)],
//     the flow sums (level 0 only) over every ok point, / (2 (n + 0.1));
//   * over the good points (ok and not saturated) the 8-column Jacobian J,
//     H = sum hw J J^T and b = sum hw J r, each / max(#good, 1) and scaled
//     by SCALE_XI_ROT, SCALE_XI_TRANS, SCALE_A, SCALE_B.
// A point that is not ok (or, for H and b, not good) adds nothing to the
// sums: it is skipped, never multiplied by 0. The plain version (and the
// JAX package's `_calc_gs`) forms H as (J w)^T J and b as (J w)^T r over
// every row of the point list, padding rows included, with w = 0 for a
// point that is not good: 0 times a non-finite term is NaN. So each thread
// also forms the terms of its points that are not good and keeps a mask of
// what is non-finite there (kBad*): J[q] turns H's row and column q and
// b[q] NaN, a NaN residual (whose Huber weight is NaN) every entry of H and
// b, an infinite one every entry of b, and at level 0 a non-finite flow
// term of a point that is not ok the flow statistic it would add to. The
// masks are OR-ed across the cluster and written as NaN in the epilogue,
// where the plain version's entries are NaN. In lm mode a NaN H or b gives
// a NaN step, whose non-finite increments are set to 0 as in
// `lm_step_ref`: the member does not move.
//
// What bounds it on this card: bytes, and at these sizes latency. The
// inputs are N points of 16 bytes and their mask byte, about 100 floats of
// state per member, and one (h, w, 3) float32 level that the gathers touch
// sparsely (3.7 MB at level 0 of 640x480, which stays in the 50 MB L2
// across the 316 trips of a track); the work is about 300 float operations
// per good point and some 1,500 per member for the step. The outputs are
// the state again. What is left is the launch, the serial step and the
// reductions.
//
// What the design does about it:
//  * One launch per trip; the cross-block reduction happens inside it. Each
//    (member, sequence) is a thread block cluster of up to 8 blocks of 256
//    threads (3 to 6 points a thread at level 0). Each thread keeps the 50
//    sums of its points in registers (H's upper triangle, b, E, the three
//    counts, two flow sums); the block reduces them with a warp
//    reduce-scatter (31 shuffles for 32 sums, so 62 a warp, not 250) and
//    one fixed-order pass over its warps. Rank 0 then reads the other
//    ranks' sums through distributed shared memory in rank order
//    (cluster.map_shared_rank between two cluster.sync()). No float
//    atomics and no global scratch: every launch gives the same bits, and
//    no buffer outlives a launch. (The other design, a fixed grid whose
//    last-arriving block reduces behind an integer ticket, needs a ticket
//    buffer per device, shape and stream; it was not built.)
//  * The epilogue, two warps of rank 0, divides, scales, mirrors H, runs
//    the accept test, the selects, lambda and done, and writes the state.
//  * The step: thread 0 of every block of a live member solves the damped
//    system in its prologue (identical inputs give identical bits in every
//    block: a few hundred float operations, all in registers), so no trip
//    depends on a value that another launch left behind and the plain
//    version's state is the kernel's whole state. The solve is float32
//    Gaussian elimination with partial pivoting (the first largest |pivot|,
//    as LAPACK's isamax) on the augmented system, what solve_ex's LU does;
//    an inactive parameter (affine_opt_mode_a/b < 0) is an identity row
//    and column with a zero right-hand side, so its increment is exactly 0.
//  * Early exit: every block reads its member's flag first; for an idle
//    member rank 0 copies the ~100 floats of state (loaded beside the flag,
//    so the copy waits for one round trip) and every other block returns
//    at its first instructions. The outputs are new tensors of the wrapper
//    (torch.empty), because vmap refuses in-place writes.
//  * Memory access: a thread reads its point as one 16-byte float4 (threads
//    on neighbouring points, coalesced) and its mask byte; the level's
//    three channels are __ldg gathers at four taps (TMA does not apply to
//    data-dependent taps). Every row of the list is sampled, masked ones
//    too, since their non-finite terms count (above); the padding rows all
//    repeat one pixel, and out-of-bounds points land on the clamped border,
//    so their gathers hit lines already in cache.
//  * Tensor cores stay unused: the 8x8 outer products are float32 (the port
//    keeps TF32 off) and 36 FMAs a point fill no wgmma tile.
// Tried on the card and not kept: 512 threads a block (a live trip at level
// 0 faster, every idle trip slower, and most trips of a track are idle), and
// two or three points in flight per thread (no faster: a live trip is bound
// by the launch, the serial step and the reductions, not by the loads).

#include <cooperative_groups.h>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kClusterMax = 8;
// the sums of one member
constexpr int kH = 0;         // 36: H's upper triangle, row-major
constexpr int kB = 36;        // 8
constexpr int kE = 44;
constexpr int kNum = 45;      // ok points
constexpr int kSat = 46;      // ok and saturated
constexpr int kGood = 47;     // ok and not saturated
constexpr int kFlowT = 48;
constexpr int kFlowRT = 49;
constexpr int kAcc = 50;
// what is non-finite among the terms of the points that are not good (bits
// 0-7: J[q])
constexpr unsigned kBadResNaN = 1u << 8;   // the residual is NaN
constexpr unsigned kBadResInf = 1u << 9;   // the residual is infinite
constexpr unsigned kBadFlowT = 1u << 10;   // a point that is not ok
constexpr unsigned kBadFlowRT = 1u << 11;
constexpr int kParams = 31;
constexpr int kPointers = 21;

constexpr int kModeTrip = 0;
constexpr int kModeCutoff = 1;
constexpr int kModeLm = 2;

constexpr float kLambdaExtrapolationLimit = 1e-3f;
constexpr float kCutoffLimit = 50.0f;

struct Params {
  float fx, fy, cx, cy;
  float Ki[9];        // K^-1 of the level, row-major
  float huber;
  float scale[8];
  float cutoff_th;    // coarse_cutoff_th
  float active[8];    // 1 for a parameter the LM solves for, else 0
};

struct Args {
  const float* points;      // (S, N, 4)
  const uint8_t* valid;     // (S, N)
  const float* dI;          // (S, h, w, 3)
  const float* T;           // (S, B, 4, 4)
  const float* aff;         // (S, B, 2)
  const float* ref_aff;     // (S, 2)
  const float* ref_expo;    // (S,)
  const float* new_expo;    // (S,)
  const float* cutoff;      // (S, B): trip, lm
  const float* stats;       // (S, B, 6): cutoff, lm
  const float* H;           // (S, B, 8, 8)
  const float* b;           // (S, B, 8)
  const float* scalar;      // (S, B): cutoff_rep (cutoff), lam (lm)
  const uint8_t* flag;      // (S, B): run (cutoff), done (lm)
  float* out_stats;
  float* out_H;
  float* out_b;
  float* out_scalar;        // cutoff_rep, lam
  float* out_T;             // lm
  float* out_aff;
  uint8_t* out_done;
};

// what every thread of a block needs of its member's trip
struct Trip {
  float T[16];        // the pose the trip warps with
  float aff[2];
  float RKi[9];
  float a_rel, b_rel, cut;
  float inc_norm;     // lm: |inc| after the extrapolation
};

// index of H[i][j], i <= j, in the row-major upper triangle
__host__ __device__ constexpr int tri(int i, int j) {
  return i * 8 - i * (i - 1) / 2 + (j - i);
}

__device__ __forceinline__ float sq(float x) { return x * x; }

// torch.clamp(x, min=lo): a NaN stays NaN (fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// the kBad* bits of the terms of a point that is not good
__device__ __forceinline__ unsigned bad_bits(const float (&J)[8], float res) {
  unsigned bits = 0u;
#pragma unroll
  for (int q = 0; q < 8; ++q) bits |= isfinite(J[q]) ? 0u : 1u << q;
  if (isnan(res)) bits |= kBadResNaN;
  if (isinf(res)) bits |= kBadResInf;
  return bits;
}

// p.scale[i] for a thread-dependent i, by selects: an indexed parameter
// array would be copied to local memory by every thread at the start
__device__ __forceinline__ float scale_of(const Params& p, int i) {
  float s = p.scale[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) s = i == k ? p.scale[k] : s;
  return s;
}

// The damped step of `_solve_inc` and the LM body's update
// (frontend/tracker.lm_trip_ref): T <- se3_exp(inc[:6]) @ T,
// aff <- aff + inc[6:8]; returns |inc| before the scaling.
__device__ __forceinline__ float lm_step(const float* __restrict__ Hm,
                         const float* __restrict__ bm, float lam,
                         const Params& p, float (&T)[16], float (&aff)[2]) {
  float M[8][9];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float h = Hm[i * 8 + j];
      if (i == j) h = __fadd_rn(__fadd_rn(h, __fmul_rn(h, lam)), 1e-12f);
      const bool both = p.active[i] != 0.0f && p.active[j] != 0.0f;
      M[i][j] = both ? h : (i == j ? 1.0f : 0.0f);
    }
    M[i][8] = p.active[i] != 0.0f ? -bm[i] : 0.0f;
  }
  // forward elimination with partial pivoting; row swaps by predicated
  // selects so that M stays in registers
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int piv = k;
    float best = fabsf(M[k][k]);
#pragma unroll
    for (int r = k + 1; r < 8; ++r) {
      if (fabsf(M[r][k]) > best) {
        best = fabsf(M[r][k]);
        piv = r;
      }
    }
#pragma unroll
    for (int r = k + 1; r < 8; ++r) {
      if (r == piv) {
#pragma unroll
        for (int c = k; c < 9; ++c) {
          const float x = M[k][c];
          M[k][c] = M[r][c];
          M[r][c] = x;
        }
      }
    }
    const float d = M[k][k];
#pragma unroll
    for (int r = k + 1; r < 8; ++r) {
      const float l = M[r][k] / d;
#pragma unroll
      for (int c = k + 1; c < 9; ++c) M[r][c] = M[r][c] - l * M[k][c];
    }
  }
  float inc[8];
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    float acc = M[i][8];
#pragma unroll
    for (int j = i + 1; j < 8; ++j) acc = acc - M[i][j] * inc[j];
    inc[i] = acc / M[i][i];
  }
  const float extrap =
      lam < kLambdaExtrapolationLimit
          ? sqrtf(sqrtf(kLambdaExtrapolationLimit / fmaxf(lam, 1e-12f)))
          : 1.0f;
  float norm2 = 0.0f;
  float xi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    inc[i] = p.active[i] != 0.0f ? __fmul_rn(inc[i], extrap) : 0.0f;
    norm2 += inc[i] * inc[i];
    const float x = __fmul_rn(inc[i], p.scale[i]);
    xi[i] = isfinite(x) ? x : 0.0f;
  }
  // se3_exp([v, w]) as math/lie.so3_exp and _V, small-angle branches
  // below theta = 1e-4
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float theta = sqrtf(theta2 + 1e-30f);
  const bool small = theta < 1e-4f;
  // sine and cosine rounded once from double, as the plain step's
  // lie.se3_exp_exact (XLA:CPU's float32 cosine is the correctly
  // rounded one; cosf is not on some small angles, and (1 - cos) / theta^2
  // amplifies that)
  const float sn = static_cast<float>(sin(static_cast<double>(theta)));
  const float cs = static_cast<float>(cos(static_cast<double>(theta)));
  const float ca = small ? 1.0f - theta2 / 6.0f : sn / theta;
  const float cb = small ? 0.5f - theta2 / 24.0f : (1.0f - cs) / theta2;
  const float vb = small ? 1.0f / 6.0f - theta2 / 120.0f
                         : (theta - sn) / (theta2 * theta);
  const float W[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float W2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      W2[i * 3 + j] = W[i * 3 + 0] * W[0 * 3 + j] +
                      W[i * 3 + 1] * W[1 * 3 + j] +
                      W[i * 3 + 2] * W[2 * 3 + j];
    }
  }
  float E[16];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float id = i == j ? 1.0f : 0.0f;
      E[i * 4 + j] = id + ca * W[i * 3 + j] + cb * W2[i * 3 + j];
      t += (id + cb * W[i * 3 + j] + vb * W2[i * 3 + j]) * xi[j];
    }
    E[i * 4 + 3] = t;
  }
  E[12] = 0.0f;
  E[13] = 0.0f;
  E[14] = 0.0f;
  E[15] = 1.0f;
  float Tn[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Tn[i * 4 + j] =
          E[i * 4 + 0] * T[0 * 4 + j] + E[i * 4 + 1] * T[1 * 4 + j] +
          E[i * 4 + 2] * T[2 * 4 + j] + E[i * 4 + 3] * T[3 * 4 + j];
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) T[i] = Tn[i];
  aff[0] = __fadd_rn(aff[0], xi[6]);
  aff[1] = __fadd_rn(aff[1], xi[7]);
  return sqrtf(norm2);
}

// One step of the warp reduce-scatter: lanes whose bit kOff is clear keep
// the low half of their live values and add the partner's, the others the
// high half.
template <int kOff>
__device__ __forceinline__ void halve(float (&v)[32], bool upper) {
#pragma unroll
  for (int i = 0; i < kOff; ++i) {
    const float send = upper ? v[i] : v[i + kOff];
    const float keep = upper ? v[i + kOff] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

// The warp's sum of v[lane] (31 shuffles for 32 sums, in a fixed order).
__device__ __forceinline__ float reduce_scatter(float (&v)[32], int lane) {
  halve<16>(v, lane & 16);
  halve<8>(v, lane & 8);
  halve<4>(v, lane & 4);
  halve<2>(v, lane & 2);
  halve<1>(v, lane & 1);
  return v[0];
}

__global__ void __launch_bounds__(kThreads)
tracker_trip_kernel(Args a, Params p, int mode, int B, int N, int w, int h,
                    int compute_flow) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int m = blockIdx.y;
  const int s = blockIdx.z;
  const int sb = s * B + m;
  const int tid = threadIdx.x;

  // 1. the member's flag: an idle member passes its state through. Rank
  // 0's first 64 threads load the state they pass through or select from
  // beside the flag, so that an idle trip waits for one load, not two.
  const bool keeper = rank == 0 && tid < 64 && mode != kModeTrip;
  float old_H = 0.0f, old_b = 0.0f, old_st = 0.0f, old_T = 0.0f;
  float old_aff = 0.0f, old_s = 0.0f;
  if (keeper) {
    old_H = a.H[sb * 64 + tid];
    if (tid < 8) old_b = a.b[sb * 8 + tid];
    if (tid < 6) old_st = a.stats[sb * 6 + tid];
    if (tid == 0) old_s = a.scalar[sb];
    if (mode == kModeLm && tid < 16) old_T = a.T[sb * 16 + tid];
    if (mode == kModeLm && tid < 2) old_aff = a.aff[sb * 2 + tid];
  }
  bool live = true;
  if (mode == kModeCutoff) {
    live = a.flag[sb] != 0 && a.stats[sb * 6 + 5] > 0.6f &&
           a.scalar[sb] < kCutoffLimit;
  } else if (mode == kModeLm) {
    live = a.flag[sb] == 0;
  }
  if (!live) {
    if (!keeper) return;
    a.out_H[sb * 64 + tid] = old_H;
    if (tid < 8) a.out_b[sb * 8 + tid] = old_b;
    if (tid < 6) a.out_stats[sb * 6 + tid] = old_st;
    if (tid == 0) a.out_scalar[sb] = old_s;
    if (mode == kModeLm) {
      if (tid < 16) a.out_T[sb * 16 + tid] = old_T;
      if (tid < 2) a.out_aff[sb * 2 + tid] = old_aff;
      if (tid == 0) a.out_done[sb] = 1;
    }
    return;
  }

  // 2. the trip's pose, affine and cutoff (thread 0; in lm mode the step)
  __shared__ Trip tr;
  if (tid == 0) {
    float T[16], aff[2] = {a.aff[sb * 2 + 0], a.aff[sb * 2 + 1]};
#pragma unroll
    for (int i = 0; i < 16; ++i) T[i] = a.T[sb * 16 + i];
    float cut, inc_norm = 0.0f;
    if (mode == kModeLm) {
      inc_norm = lm_step(a.H + sb * 64, a.b + sb * 8, a.scalar[sb], p, T, aff);
      cut = a.cutoff[sb];
    } else if (mode == kModeCutoff) {
      cut = __fmul_rn(p.cutoff_th, __fmul_rn(a.scalar[sb], 2.0f));
    } else {
      cut = a.cutoff[sb];
    }
    float ef = a.ref_expo[s], et = a.new_expo[s];
    if (ef == 0.0f || et == 0.0f) {
      ef = 1.0f;
      et = 1.0f;
    }
    const float ra0 = a.ref_aff[s * 2 + 0], ra1 = a.ref_aff[s * 2 + 1];
    // exp rounded once from double, as frontend/affine.from_to(exact=True)
    const float a_rel = __fdiv_rn(
        __fmul_rn(static_cast<float>(exp(static_cast<double>(aff[0] - ra0))),
                  et),
        ef);
    tr.a_rel = a_rel;
    tr.b_rel = __fsub_rn(aff[1], __fmul_rn(a_rel, ra1));
    tr.cut = cut;
    tr.inc_norm = inc_norm;
#pragma unroll
    for (int i = 0; i < 16; ++i) tr.T[i] = T[i];
    tr.aff[0] = aff[0];
    tr.aff[1] = aff[1];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        tr.RKi[i * 3 + j] = T[i * 4 + 0] * p.Ki[0 * 3 + j] +
                            T[i * 4 + 1] * p.Ki[1 * 3 + j] +
                            T[i * 4 + 2] * p.Ki[2 * 3 + j];
      }
    }
  }
  __syncthreads();

  float RKi[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) RKi[i] = tr.RKi[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = tr.T[i * 4 + 3];
  const float a_rel = tr.a_rel;
  const float b_rel = tr.b_rel;
  const float b0 = a.ref_aff[s * 2 + 1];
  const float cut = tr.cut;
  const float huber = p.huber;
  const float max_energy = 2.0f * huber * cut - huber * huber;
  const float wlim = static_cast<float>(w - 1.001);
  const float hlim = static_cast<float>(h - 1.001);
  const float umax = static_cast<float>(w - 3);
  const float vmax = static_cast<float>(h - 3);

  const float4* P = reinterpret_cast<const float4*>(a.points) +
                    static_cast<size_t>(s) * N;
  const uint8_t* V = a.valid + static_cast<size_t>(s) * N;
  const float* img = a.dI + static_cast<size_t>(s) * h * w * 3;

  // 3. this thread's points: sums in registers, two warp-widths of slots
  float acc[2][32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    acc[0][k] = 0.0f;
    acc[1][k] = 0.0f;
  }
#define ACC(k) acc[(k) / 32][(k) % 32]

  unsigned bad = 0u;
  for (int i = rank * kThreads + tid; i < N; i += n_ranks * kThreads) {
    const bool valid = V[i] != 0;
    const float4 pt = __ldg(P + i);
    const float x = pt.x, y = pt.y, idep = pt.z, color = pt.w;

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
    const bool inb = Ku > 2.0f && Kv > 2.0f && Ku < umax && Kv < vmax &&
                     nid > 0.0f;

    // bilinear (I, dx, dy): the taps of ops/interp.bilinear, whose clamp
    // keeps a NaN coordinate, and so a NaN sample
    float I, gx, gy;
    if (isnan(Ku) || isnan(Kv)) {
      I = gx = gy = __int_as_float(0x7fc00000);
    } else {
      const float xc = fminf(fmaxf(Ku, 0.0f), wlim);
      const float yc = fminf(fmaxf(Kv, 0.0f), hlim);
      const float x0 = floorf(xc), y0 = floorf(yc);
      const float fx_ = xc - x0, fy_ = yc - y0;
      const float* t00 =
          img + (static_cast<size_t>(y0) * w + static_cast<size_t>(x0)) * 3;
      const float* t01 = t00 + 3;
      const float* t10 = t00 + static_cast<size_t>(w) * 3;
      const float* t11 = t10 + 3;
      const float dxdy = fx_ * fy_;
      const float w11 = dxdy, w10 = fy_ - dxdy, w01 = fx_ - dxdy;
      const float w00 = 1.0f - fx_ - fy_ + dxdy;
      I = w11 * __ldg(t11) + w10 * __ldg(t10) + w01 * __ldg(t01) +
          w00 * __ldg(t00);
      gx = w11 * __ldg(t11 + 1) + w10 * __ldg(t10 + 1) +
           w01 * __ldg(t01 + 1) + w00 * __ldg(t00 + 1);
      gy = w11 * __ldg(t11 + 2) + w10 * __ldg(t10 + 2) +
           w01 * __ldg(t01 + 2) + w00 * __ldg(t00 + 2);
    }
    const bool ok = valid && inb && isfinite(I);

    const float res = I - (a_rel * color + b_rel);
    const float abs_r = fabsf(res);
    const float hw = abs_r < huber ? 1.0f : huber / clamp_min(abs_r, 1e-12f);
    const bool sat = abs_r > cut;
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
      const float ft = sq(KuT - x) + sq(KvT - y) + sq(KuT2 - x) + sq(KvT2 - y);
      const float frt = sq(Ku - x) + sq(Kv - y) + sq(Ku3 - x) + sq(Kv3 - y);
      if (ok) {
        ACC(kFlowT) += ft;
        ACC(kFlowRT) += frt;
      } else {
        bad |= (isfinite(ft) ? 0u : kBadFlowT) |
               (isfinite(frt) ? 0u : kBadFlowRT);
      }
    }
    if (ok) {
      ACC(kE) += sat ? max_energy : hw * res * res * (2.0f - hw);
      ACC(kNum) += 1.0f;
    }
    if (!ok || sat) {
      // not good: nothing in the sums, but its non-finite terms
      bad |= bad_bits(J, res);
      if (ok) ACC(kSat) += 1.0f;
      continue;
    }
    ACC(kGood) += 1.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float Jw = J[q] * hw;
#pragma unroll
      for (int c = q; c < 8; ++c) ACC(kH + tri(q, c)) += Jw * J[c];
      ACC(kB + q) += Jw * res;
    }
  }
#undef ACC

  // 4. the block's sums in a fixed order: a reduce-scatter per warp, then
  // the warps in index order
  __shared__ float red[kWarps][64];
  __shared__ float blk[kAcc];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __shared__ unsigned red_bad[kWarps];
  __shared__ unsigned blk_bad;
  red[warp][lane] = reduce_scatter(acc[0], lane);
  red[warp][32 + lane] = reduce_scatter(acc[1], lane);
  bad = __reduce_or_sync(0xffffffffu, bad);
  if (lane == 0) red_bad[warp] = bad;
  __syncthreads();
  if (tid < kAcc) {
    float x = red[0][tid];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) x += red[wi][tid];
    blk[tid] = x;
  }
  if (tid == kAcc) {
    unsigned x = 0u;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) x |= red_bad[wi];
    blk_bad = x;
  }

  // 5. the cluster's sums: rank 0 adds the other ranks' in rank order
  __shared__ float tot[kAcc];
  cluster.sync();
  if (rank == 0 && tid < kAcc) {
    // every remote load in flight at once, then the sum in rank order
    float part[kClusterMax];
#pragma unroll
    for (int r = 1; r < kClusterMax; ++r) {
      part[r] = r < n_ranks ? cluster.map_shared_rank(blk, r)[tid] : 0.0f;
    }
    float x = blk[tid];
#pragma unroll
    for (int r = 1; r < kClusterMax; ++r) {
      if (r < n_ranks) x += part[r];
    }
    tot[tid] = x;
  }
  __shared__ unsigned tot_bad;
  if (rank == 0 && tid == kAcc) {
    unsigned x = blk_bad;
    for (int r = 1; r < n_ranks; ++r) x |= *cluster.map_shared_rank(&blk_bad, r);
    tot_bad = x;
  }
  cluster.sync();      // the other ranks' shared memory lives until here
  if (rank != 0) return;

  // 6. the epilogue: stats, H and b of the trip, then the mode's selects
  __shared__ float nH[64], nb[8], nst[6];
  if (tid < 64) {
    const float nan = __int_as_float(0x7fc00000);
    const unsigned bad_all = tot_bad;
    const float n = fmaxf(tot[kGood], 1.0f);
    const int i = tid >> 3, j = tid & 7;
    const int lo = i < j ? i : j, hi = i < j ? j : i;
    const bool h_nan = (bad_all & (kBadResNaN | (1u << i) | (1u << j))) != 0u;
    nH[tid] = h_nan ? nan
                    : tot[kH + tri(lo, hi)] / n * scale_of(p, i) *
                          scale_of(p, j);
    if (tid < 8) {
      const bool b_nan =
          (bad_all & (kBadResNaN | kBadResInf | (1u << tid))) != 0u;
      nb[tid] = b_nan ? nan : tot[kB + tid] / n * scale_of(p, tid);
    }
    if (tid == 0) {
      const float num = tot[kNum];
      const float n_flow = 2.0f * (num + 0.1f);
      nst[0] = tot[kE];
      nst[1] = num;
      nst[2] = !compute_flow            ? 0.0f
               : bad_all & kBadFlowT    ? nan
                                        : tot[kFlowT] / n_flow;
      nst[3] = 0.0f;
      nst[4] = !compute_flow            ? 0.0f
               : bad_all & kBadFlowRT   ? nan
                                        : tot[kFlowRT] / n_flow;
      nst[5] = tot[kSat] / fmaxf(num, 1.0f);
    }
  }
  __syncthreads();
  if (tid >= 64) return;
  if (mode == kModeTrip) {
    a.out_H[sb * 64 + tid] = nH[tid];
    if (tid < 8) a.out_b[sb * 8 + tid] = nb[tid];
    if (tid < 6) a.out_stats[sb * 6 + tid] = nst[tid];
    return;
  }
  bool take = true;
  if (mode == kModeLm) {
    const float* st = a.stats + sb * 6;
    take = nst[0] / fmaxf(nst[1], 1.0f) < st[0] / fmaxf(st[1], 1.0f);
    if (tid < 16) a.out_T[sb * 16 + tid] = take ? tr.T[tid] : old_T;
    if (tid < 2) a.out_aff[sb * 2 + tid] = take ? tr.aff[tid] : old_aff;
    if (tid == 0) {
      a.out_scalar[sb] = take ? __fmul_rn(old_s, 0.5f)
                              : fmaxf(__fmul_rn(old_s, 4.0f),
                                      kLambdaExtrapolationLimit);
      a.out_done[sb] = tr.inc_norm <= 1e-3f ? 1 : 0;
    }
  } else if (tid == 0) {
    a.out_scalar[sb] = __fmul_rn(old_s, 2.0f);
  }
  a.out_H[sb * 64 + tid] = take ? nH[tid] : old_H;
  if (tid < 8) a.out_b[sb * 8 + tid] = take ? nb[tid] : old_b;
  if (tid < 6) a.out_stats[sb * 6 + tid] = take ? nst[tid] : old_st;
}

}  // namespace

extern "C" {

// mode 0 trip, 1 cutoff, 2 lm. ptrs: kPointers device pointers in the order
// of Args (points (S, N, 4) f32 [u, v, idepth, color] 16-byte aligned,
// valid (S, N) uint8, dI (S, h, w, 3) f32, T (S, B, 4, 4), aff (S, B, 2),
// ref_aff (S, 2), ref_exposure (S,), new_exposure (S,), cutoff (S, B),
// stats (S, B, 6), H (S, B, 8, 8), b (S, B, 8), cutoff_rep or lam (S, B),
// run or done (S, B) uint8, then the outputs in the same layouts: stats, H,
// b, cutoff_rep or lam, T, aff, done); a pointer the mode does not use may
// be null. params (host): fx, fy, cx, cy, K^-1 (9, row-major), huber, the 8
// scales, coarse_cutoff_th, the 8 active flags. Launches one cluster of up
// to 8 blocks per (member, sequence) on `stream` and returns the launch
// error (cudaError_t, 0 on success).
int ldso_tracker_trip(int mode, void* const* ptrs, int S, int B, int N,
                      int w, int h, const float* params, int compute_flow,
                      void* stream) {
  if (mode < kModeTrip || mode > kModeLm || ptrs == nullptr || S < 1 ||
      S > 65535 || B < 1 || B > 65535 || N < 1 || w < 7 || h < 7 ||
      params == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the pointers each mode reads and writes
  const bool need[kPointers] = {
      true, true, true, true, true, true, true, true,
      mode != kModeCutoff, mode != kModeTrip, mode != kModeTrip,
      mode != kModeTrip, mode != kModeTrip, mode != kModeTrip,
      true, true, true, mode != kModeTrip, mode == kModeLm, mode == kModeLm,
      mode == kModeLm};
  for (int i = 0; i < kPointers; ++i) {
    if (need[i] && ptrs[i] == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (reinterpret_cast<uintptr_t>(ptrs[0]) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  Args a;
  a.points = static_cast<const float*>(ptrs[0]);
  a.valid = static_cast<const uint8_t*>(ptrs[1]);
  a.dI = static_cast<const float*>(ptrs[2]);
  a.T = static_cast<const float*>(ptrs[3]);
  a.aff = static_cast<const float*>(ptrs[4]);
  a.ref_aff = static_cast<const float*>(ptrs[5]);
  a.ref_expo = static_cast<const float*>(ptrs[6]);
  a.new_expo = static_cast<const float*>(ptrs[7]);
  a.cutoff = static_cast<const float*>(ptrs[8]);
  a.stats = static_cast<const float*>(ptrs[9]);
  a.H = static_cast<const float*>(ptrs[10]);
  a.b = static_cast<const float*>(ptrs[11]);
  a.scalar = static_cast<const float*>(ptrs[12]);
  a.flag = static_cast<const uint8_t*>(ptrs[13]);
  a.out_stats = static_cast<float*>(ptrs[14]);
  a.out_H = static_cast<float*>(ptrs[15]);
  a.out_b = static_cast<float*>(ptrs[16]);
  a.out_scalar = static_cast<float*>(ptrs[17]);
  a.out_T = static_cast<float*>(ptrs[18]);
  a.out_aff = static_cast<float*>(ptrs[19]);
  a.out_done = static_cast<uint8_t*>(ptrs[20]);
  Params p;
  static_assert(sizeof(Params) == kParams * sizeof(float), "Params layout");
  std::memcpy(&p, params, sizeof(Params));

  int ranks = (N + kThreads - 1) / kThreads;
  if (ranks > kClusterMax) ranks = kClusterMax;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, B, S);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, tracker_trip_kernel, a, p, mode,
                                       B, N, w, h, compute_flow);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
