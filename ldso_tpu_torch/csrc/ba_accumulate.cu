// K7: the windowed BA's accumulation, hand-written for Hopper (sm_90a).
// One call per accumulation, from ldso_tpu_torch/ops/cuda_kernels.
// ba_accumulate_top and ba_accumulate_sc; each call queues two grids on
// the stream, a pass over the points and a pass over the (host, target)
// blocks, and counts as one launch.
//
// Replaces `_accumulate_top` (ldso_tpu/backend/ba.py:519, modes 0, 1 and
// 2 with `_res_approx`, :486) and `_accumulate_sc` (:610) of the JAX
// package, inside the XLA programs of `build_system` (:686) and
// `accumulate_marg` (:867); they have no `pallas_call`. Its plain
// versions are the port's backend/ba._accumulate_top_ref and _sc_sums_ref
// (einsums, a one-hot product and a matmul over the points). The adjoint
// stitch of the (F, F) blocks stays in PyTorch (backend/ba._stitch_top,
// _accumulate_sc).
//
// Function, per window of P points and F slots:
//   top (part 0, mode m): for every residual (p, t) in the mode's mask
//     (active, existing, target valid, the point in pt_mask; mode 0 not
//     linearized, mode 1 linearized), its 8 rows of 13 [JIdx Jpdc (4) |
//     JIdx Jpdxi (6) | JabF (2) | resApprox] (resApprox resF, res_toZero
//     + J delta, res_toZero), their 13x13 outer products summed per
//     (host, target) over the points; per point Hdd, bd and Hcd (4) over
//     its targets; the mask's count;
//   sc (part 1): per point ngood, HdiF, bdSum, the gated Hcd and JpJdF
//     (F, 8); summed over the points Hcc_sc (4x4) and bc_sc (4), and per
//     host accE (F, 8, 4), accEB (F, 8) and accD (F, F, 8, 8).
// The plain versions multiply masked terms by 0 and sum every host's
// products over every point, so one non-finite term anywhere turns an
// output entry NaN for every host. K7 skips masked points in its sums, as
// the reference does, but ORs flags of the non-finite terms over all the
// points and writes NaN where the plain version's 0 x term is NaN (per
// point exactly, as `m * term`; per (host, target) block by column).
//
// Sums: every sum over the points runs in point order within one thread
// (or in a fixed lane order and a warp's shuffle tree), with no float
// atomics: a grid of point chunks writes each point's pieces and flags,
// then each (host, target) block sums its entries over the points of its
// host in order. So a call repeats bit for bit; its order is not the
// plain version's (tests/torch_kernel_checks.accumulate_err holds it to a
// tolerance).
//
// What bounds it on this card: bytes. At P = 2048, F = 8 the top part
// reads each residual's Jacobian pieces (some 250 bytes) once and writes
// 13 KB of blocks; the Schur part reads some 190 bytes a residual and
// writes JpJdF (32 bytes a residual) and 140 KB of blocks: about 4 MB and
// 1.2 us at 3.35 TB/s per call (chip_smoke.acc_bound_ms). The operations,
// 16,384 x 8 x 91 multiply-adds for the top part and 2,048 x 8 x 64 x 8
// for accD, are under 0.5 us at 67 TFLOP/s.
//
// What the design does about that: the point pass runs one thread per
// residual (a block holds whole points; a point's sums over its targets
// are taken by its target-0 thread from shared memory), so each
// residual's pieces are read once and the flags written once; the block
// pass reads the flags of every point (4 bytes a residual) and the pieces
// of its own host's points only: each step compacts a block's worth of
// candidate points in point order (ballots and a prefix over the warps)
// and brings those points through shared memory in tiles. No sum is split
// across blocks, so no partial sums go through device memory. A simple
// first design: the block pass has few blocks (F x F + 1 per window), each
// entry summed by one thread in point order.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 8;
constexpr int kRows = 13;
constexpr int kEntries = kRows * (kRows + 1) / 2;   // the upper triangle
constexpr int kMaxF = 32;                           // BA_MAX_SLOTS
constexpr int kPointBlock = 128;
constexpr int kTopBlock = 128;
constexpr int kTopTile = 64;
constexpr int kScBlock = 256;
constexpr int kScTile = 32;
constexpr int kScPer = (kMaxF * 64 + 40 + kScBlock - 1) / kScBlock;
constexpr unsigned kFull = 0xffffffffu;

struct Top {
  const float* JIdx;        // (P, F, 2, 8)
  const float* Jpdc;        // (P, F, 2, 4)
  const float* Jpdxi;       // (P, F, 2, 6)
  const float* JabF;        // (P, F, 2, 8)
  const float* Jpdd;        // (P, F, 2)
  const float* resF;        // (P, F, 8)
  const float* res_toZero;  // (P, F, 8)
  const bool* res_active;   // (P, F)
  const bool* res_exist;
  const bool* res_linearized;
  const bool* frame_valid;  // (F,)
  const bool* pt_mask;      // (P,)
  const int64_t* pt_host;
  const float* adHTdelta;   // (F, F, 8)
  const float* c_delta;     // (4,)
  const float* idepth;
  const float* idepth_zero;
  float* acc;               // (F, F, 13, 13)
  float* Hdd;               // (P,)
  float* bd;
  float* Hcd;               // (P, 4)
  int64_t* nres;            // ()
  int* flags;               // (P, F): the residual's non-finite columns
  int* count;               // (P,): its masked residuals
  int S, P, F, mode;
};

struct Sc {
  const float* JIdx;
  const float* JabF;
  const float* Jpdxi;
  const float* Jpdd;
  const bool* res_active;
  const bool* res_exist;
  const bool* frame_valid;
  const bool* pt_mask;
  const int64_t* pt_host;
  const float* pt_prior;
  const float* idepth;
  const float* idepth_zero;
  const float* Hdd_tot;
  const float* bd_tot;
  const float* Hcd_tot;     // (P, 4)
  float* HdiF;              // (P,)
  float* bdSum;
  float* Hcd;               // (P, 4)
  float* JpJdF;             // (P, F, 8)
  int64_t* ngood;           // (P,)
  float* Hcc_sc;            // (4, 4)
  float* bc_sc;             // (4,)
  float* accE;              // (F, F, 8, 4)
  float* accEB;             // (F, F, 8)
  float* accD;              // (F, F, F, 8, 8)
  int* jflags;              // (P, F): JpJdF's non-finite entries
  int* pflags;              // (P,): see kHas and the bits below it
  int S, P, F, shift_prior;
};

// Sc.pflags bits: HdiF, HdiF bdSum and Hcd[c] non-finite, and `has`
constexpr int kNfHdiF = 1;
constexpr int kNfHB = 2;
constexpr int kNfHcd = 4;                 // 4 bits from here
constexpr int kHas = 64;

__device__ __forceinline__ int host_of(const int64_t* pt_host, long long i,
                                       int F) {
  const int h = (int)pt_host[i];
  return h < 0 ? 0 : (h >= F ? F - 1 : h);
}

__device__ __forceinline__ float warp_tree(float v) {
  for (int m = 16; m >= 1; m >>= 1) v = v + __shfl_xor_sync(kFull, v, m);
  return v;
}

// The values of the threads with `inc`, appended to `list` in thread
// order; returns their count. warp_n: one int per warp of shared memory.
// Every thread of the block calls it.
__device__ int block_compact(bool inc, int value, int* list, int* warp_n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, inc);
  if (lane == 0) warp_n[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, n = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    if (w < warp) before += warp_n[w];
    n += warp_n[w];
  }
  if (inc) list[before + __popc(ballot & ((1u << lane) - 1u))] = value;
  __syncthreads();
  return n;
}

// ---------------------------------------------------------------- top part

__device__ __forceinline__ bool top_mask(const Top& a, int s, int p, int t) {
  const long long r = ((long long)s * a.P + p) * a.F + t;
  const bool base = a.res_active[r] && a.res_exist[r] &&
                    a.frame_valid[(long long)s * a.F + t] &&
                    a.pt_mask[(long long)s * a.P + p];
  if (a.mode == 0) return base && !a.res_linearized[r];
  if (a.mode == 1) return base && a.res_linearized[r];
  return base;
}

// resApprox (AccumulatedTopHessian.cc:40-66) of residual (p, t)
__device__ void res_approx(const Top& a, int s, int p, int t, float res[8]) {
  const long long r = ((long long)s * a.P + p) * a.F + t;
  if (a.mode == 0) {
    for (int k = 0; k < kTaps; ++k) res[k] = a.resF[r * 8 + k];
    return;
  }
  for (int k = 0; k < kTaps; ++k) res[k] = a.res_toZero[r * 8 + k];
  if (a.mode == 2) return;
  const int h = host_of(a.pt_host, (long long)s * a.P + p, a.F);
  const float* dp = a.adHTdelta + (((long long)s * a.F + h) * a.F + t) * 8;
  const float* cd = a.c_delta + (long long)s * 4;
  const float dd = a.idepth[(long long)s * a.P + p] -
                   a.idepth_zero[(long long)s * a.P + p];
  const float* xi = a.Jpdxi + r * 12;
  const float* jc = a.Jpdc + r * 8;
  const float* jd = a.Jpdd + r * 2;
  float Jp[2];
  for (int x = 0; x < 2; ++x) {
    float v = 0.0f;
    for (int j = 0; j < 6; ++j) v += xi[x * 6 + j] * dp[j];
    float w = 0.0f;
    for (int j = 0; j < 4; ++j) w += jc[x * 4 + j] * cd[j];
    Jp[x] = (v + w) + jd[x] * dd;
  }
  const float* ji = a.JIdx + r * 16;
  const float* jab = a.JabF + r * 16;
  for (int k = 0; k < kTaps; ++k)
    res[k] += ((ji[k] * Jp[0] + ji[8 + k] * Jp[1]) + jab[k] * dp[6]) +
              jab[8 + k] * dp[7];
}

// the 13 row entries of tap k of residual r (unmasked)
__device__ __forceinline__ void top_row(const Top& a, long long r, int k,
                                        const float res[8], float row[13]) {
  const float* ji = a.JIdx + r * 16;
  const float j0 = ji[k], j1 = ji[8 + k];
  const float* jc = a.Jpdc + r * 8;
  const float* xi = a.Jpdxi + r * 12;
  for (int c = 0; c < 4; ++c) row[c] = j0 * jc[c] + j1 * jc[4 + c];
  for (int c = 0; c < 6; ++c) row[4 + c] = j0 * xi[c] + j1 * xi[6 + c];
  row[10] = a.JabF[r * 16 + k];
  row[11] = a.JabF[r * 16 + 8 + k];
  row[12] = res[k];
}

// pass 1: one thread per residual, a block's residuals those of
// kPointBlock / F whole points; each point's sums over its targets are
// taken by its target-0 thread, in target order
__global__ void __launch_bounds__(kPointBlock) top_points(Top a) {
  __shared__ float terms[kPointBlock][6];          // bd, Hdd, Hcd (4)
  __shared__ int masked[kPointBlock];
  const int s = blockIdx.y, F = a.F;
  const int per = kPointBlock / F;
  const int p = blockIdx.x * per + threadIdx.x / F;
  const int t = threadIdx.x % F;
  const bool live = threadIdx.x < per * F && p < a.P;
  if (live) {
    const long long r = ((long long)s * a.P + p) * F + t;
    const bool m = top_mask(a, s, p, t);
    float res[8];
    res_approx(a, s, p, t, res);
    const float* ji = a.JIdx + r * 16;
    const float* jd = a.Jpdd + r * 2;
    const float* jc = a.Jpdc + r * 8;
    float jr0 = 0.0f, jr1 = 0.0f, j00 = 0.0f, j01 = 0.0f, j11 = 0.0f;
    int nf = 0;
    for (int k = 0; k < kTaps; ++k) {
      jr0 += ji[k] * res[k];
      jr1 += ji[8 + k] * res[k];
      j00 += ji[k] * ji[k];
      j01 += ji[k] * ji[8 + k];
      j11 += ji[8 + k] * ji[8 + k];
      float row[13];
      top_row(a, r, k, res, row);
      for (int c = 0; c < kRows; ++c)
        if (!isfinite(row[c])) nf |= 1 << c;
    }
    const float g0 = j00 * jd[0] + j01 * jd[1];
    const float g1 = j01 * jd[0] + j11 * jd[1];
    const float mf = m ? 1.0f : 0.0f;
    float* tm = terms[threadIdx.x];
    tm[0] = mf * (jr0 * jd[0] + jr1 * jd[1]);
    tm[1] = mf * (g0 * jd[0] + g1 * jd[1]);
    for (int c = 0; c < 4; ++c) tm[2 + c] = mf * (jc[c] * g0 + jc[4 + c] * g1);
    masked[threadIdx.x] = m ? 1 : 0;
    a.flags[r] = nf;
  }
  __syncthreads();
  if (!live || t != 0) return;
  float sum[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int count = 0;
  for (int u = 0; u < F; ++u) {
    for (int c = 0; c < 6; ++c) sum[c] += terms[threadIdx.x + u][c];
    count += masked[threadIdx.x + u];
  }
  const long long q = (long long)s * a.P + p;
  a.bd[q] = sum[0];
  a.Hdd[q] = sum[1];
  for (int c = 0; c < 4; ++c) a.Hcd[q * 4 + c] = sum[2 + c];
  a.count[q] = count;
}

// the upper-triangle entry e of 13x13 as (row, column)
__device__ __forceinline__ void entry_rc(int e, int& i, int& j) {
  i = 0;
  while (e >= kRows - i) {
    e -= kRows - i;
    ++i;
  }
  j = i + e;
}

// pass 2: block (h, t) sums its 13x13 block over the masked residuals of
// the points hosted by h, in point order; the last block counts the mask
__global__ void __launch_bounds__(kTopBlock) top_blocks(Top a) {
  __shared__ float rows[kTopTile][kTaps][kRows];
  __shared__ int list[kTopBlock];
  __shared__ int warp_n[kTopBlock / 32];
  __shared__ int nf_cols;
  __shared__ long long total;
  const int s = blockIdx.y;
  const int F = a.F, P = a.P;
  const int tid = threadIdx.x;
  if (blockIdx.x == F * F) {
    if (tid == 0) total = 0;
    __syncthreads();
    long long c = 0;
    for (int p = tid; p < P; p += kTopBlock) c += a.count[(long long)s * P + p];
    atomicAdd((unsigned long long*)&total, (unsigned long long)c);
    __syncthreads();
    if (tid == 0) a.nres[s] = total;
    return;
  }
  const int h = blockIdx.x / F, t = blockIdx.x % F;
  if (tid == 0) nf_cols = 0;
  __syncthreads();
  int nf = 0;
  for (int p = tid; p < P; p += kTopBlock)
    nf |= a.flags[((long long)s * P + p) * F + t];
  if (nf) atomicOr(&nf_cols, nf);
  int ei = 0, ej = 0;
  if (tid < kEntries) entry_rc(tid, ei, ej);
  float acc = 0.0f;
  for (int base = 0; base < P; base += kTopBlock) {
    // this step's points of host h in the mask at t, in point order
    const int p = base + tid;
    const bool inc = p < P &&
                     host_of(a.pt_host, (long long)s * P + p, F) == h &&
                     top_mask(a, s, p, t);
    const int n = block_compact(inc, p, list, warp_n);
    for (int sub = 0; sub < n; sub += kTopTile) {
      const int m = min(kTopTile, n - sub);
      for (int j = tid; j < m; j += kTopBlock) {
        float res[8];
        res_approx(a, s, list[sub + j], t, res);
        for (int k = 0; k < kTaps; ++k)
          top_row(a, ((long long)s * P + list[sub + j]) * F + t, k, res,
                  rows[j][k]);
      }
      __syncthreads();
      if (tid < kEntries) {
        for (int i = 0; i < m; ++i) {
          float o = 0.0f;
          for (int k = 0; k < kTaps; ++k)
            o += rows[i][k][ei] * rows[i][k][ej];
          acc += o;
        }
      }
      __syncthreads();
    }
  }
  if (tid < kEntries) {
    const bool bad = (nf_cols >> ei & 1) || (nf_cols >> ej & 1);
    const float v = bad ? __int_as_float(0x7fc00000) : acc;
    float* blk = a.acc + (((long long)s * F + h) * F + t) * kRows * kRows;
    blk[ei * kRows + ej] = v;
    blk[ej * kRows + ei] = v;
  }
}

// --------------------------------------------------------------- Schur part

__device__ __forceinline__ bool sc_act(const Sc& a, int s, int p, int t) {
  const long long r = ((long long)s * a.P + p) * a.F + t;
  return a.res_active[r] && a.res_exist[r] &&
         a.frame_valid[(long long)s * a.F + t] &&
         a.pt_mask[(long long)s * a.P + p];
}

// pass 1: one thread per residual (JpJdF and its flags), a block's
// residuals those of kPointBlock / F whole points; each point's pieces by
// its target-0 thread
__global__ void __launch_bounds__(kPointBlock) sc_points(Sc a) {
  __shared__ int active[kPointBlock];
  const int s = blockIdx.y, F = a.F;
  const int per = kPointBlock / F;
  const int p = blockIdx.x * per + threadIdx.x / F;
  const int t = threadIdx.x % F;
  const bool live = threadIdx.x < per * F && p < a.P;
  const long long q = (long long)s * a.P + p;
  if (live) {
    const long long r = q * F + t;
    const float* ji = a.JIdx + r * 16;
    const float* jab = a.JabF + r * 16;
    const float* xi = a.Jpdxi + r * 12;
    const float* jd = a.Jpdd + r * 2;
    float j00 = 0.0f, j01 = 0.0f, j11 = 0.0f;
    float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;
    for (int k = 0; k < kTaps; ++k) {
      j00 += ji[k] * ji[k];
      j01 += ji[k] * ji[8 + k];
      j11 += ji[8 + k] * ji[8 + k];
      a00 += jab[k] * ji[k];
      a01 += jab[k] * ji[8 + k];
      a10 += jab[8 + k] * ji[k];
      a11 += jab[8 + k] * ji[8 + k];
    }
    const float g0 = j00 * jd[0] + j01 * jd[1];
    const float g1 = j01 * jd[0] + j11 * jd[1];
    const bool act = sc_act(a, s, p, t);
    const float af = act ? 1.0f : 0.0f;
    float v[8];
    for (int i = 0; i < 6; ++i) v[i] = (xi[i] * g0 + xi[6 + i] * g1) * af;
    v[6] = (a00 * jd[0] + a01 * jd[1]) * af;
    v[7] = (a10 * jd[0] + a11 * jd[1]) * af;
    int nf = 0;
    for (int i = 0; i < 8; ++i) {
      a.JpJdF[r * 8 + i] = v[i];
      if (!isfinite(v[i])) nf |= 1 << i;
    }
    a.jflags[r] = nf;
    active[threadIdx.x] = act ? 1 : 0;
  }
  __syncthreads();
  if (!live || t != 0) return;
  long long ngood = 0;
  for (int u = 0; u < F; ++u) ngood += active[threadIdx.x + u];
  const bool has = ngood > 0 && a.pt_mask[q];
  float Hd = a.Hdd_tot[q] + a.pt_prior[q];
  Hd = isnan(Hd) ? Hd : fmaxf(Hd, 1e-10f);
  const float HdiF = has ? 1.0f / Hd : 0.0f;
  float bdSum = a.bd_tot[q] + (a.shift_prior
                                   ? a.pt_prior[q] * (a.idepth[q] -
                                                      a.idepth_zero[q])
                                   : 0.0f);
  bdSum = has ? bdSum : 0.0f;
  int pf = has ? kHas : 0;
  if (!isfinite(HdiF)) pf |= kNfHdiF;
  if (!isfinite(HdiF * bdSum)) pf |= kNfHB;
  for (int c = 0; c < 4; ++c) {
    const float h = has ? a.Hcd_tot[q * 4 + c] : 0.0f;
    a.Hcd[q * 4 + c] = h;
    if (!isfinite(h)) pf |= kNfHcd << c;
  }
  a.HdiF[q] = HdiF;
  a.bdSum[q] = bdSum;
  a.ngood[q] = ngood;
  a.pflags[q] = pf;
}

// pass 2: block (h, t1) sums accD[h, t1], accE[h, t1] and accEB[h, t1]
// over the points of host h with `has`, in point order; the last block
// sums Hcc_sc and bc_sc over every point, a warp per entry
__global__ void __launch_bounds__(kScBlock) sc_blocks(Sc a) {
  __shared__ float J[kScTile][kMaxF * 8];
  __shared__ float hdi[kScTile], bds[kScTile], hcd[kScTile][4];
  __shared__ int list[kScBlock];
  __shared__ int warp_n[kScBlock / 32];
  __shared__ int nfj[kMaxF];
  __shared__ int nfp;
  const int s = blockIdx.y;
  const int F = a.F, P = a.P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (blockIdx.x == F * F) {
    for (int e = warp; e < 20; e += kScBlock / 32) {
      const int i = e < 16 ? e / 4 : e - 16, j = e % 4;
      float acc = 0.0f;
      for (int p = lane; p < P; p += 32) {
        const long long q = (long long)s * P + p;
        const float x = a.HdiF[q] * a.Hcd[q * 4 + i];
        acc += e < 16 ? x * a.Hcd[q * 4 + j] : x * a.bdSum[q];
      }
      acc = warp_tree(acc);
      if (lane == 0) {
        if (e < 16)
          a.Hcc_sc[(long long)s * 16 + e] = acc;
        else
          a.bc_sc[(long long)s * 4 + i] = acc;
      }
    }
    return;
  }
  const int h = blockIdx.x / F, t1 = blockIdx.x % F;
  if (tid < kMaxF) nfj[tid] = 0;
  if (tid == 0) nfp = 0;
  __syncthreads();
  int pf = 0;
  for (int p = tid; p < P; p += kScBlock) {
    const long long q = (long long)s * P + p;
    pf |= a.pflags[q] & ~kHas;
    for (int t = 0; t < F; ++t) {
      const int v = a.jflags[q * F + t];
      if (v) atomicOr(&nfj[t], v);
    }
  }
  if (pf) atomicOr(&nfp, pf);
  const int nD = F * 64;
  const int nE = nD + 32;
  const int nAll = nE + 8;
  float acc[kScPer];
#pragma unroll
  for (int u = 0; u < kScPer; ++u) acc[u] = 0.0f;
  for (int base = 0; base < P; base += kScBlock) {
    // this step's points of host h with `has`, in point order
    const int p = base + tid;
    const bool inc = p < P &&
                     host_of(a.pt_host, (long long)s * P + p, F) == h &&
                     (a.pflags[(long long)s * P + p] & kHas);
    const int n = block_compact(inc, p, list, warp_n);
    for (int sub = 0; sub < n; sub += kScTile) {
      const int m = min(kScTile, n - sub);
      for (int j = tid; j < m * F * 8; j += kScBlock) {
        const int k = j / (F * 8);
        J[k][j % (F * 8)] =
            a.JpJdF[((long long)s * P + list[sub + k]) * F * 8 + j % (F * 8)];
      }
      if (tid < m) {
        const long long q = (long long)s * P + list[sub + tid];
        hdi[tid] = a.HdiF[q];
        bds[tid] = a.bdSum[q];
        for (int c = 0; c < 4; ++c) hcd[tid][c] = a.Hcd[q * 4 + c];
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kScPer; ++u) {
        const int e = tid + u * kScBlock;
        if (e >= nAll) continue;
        float v = acc[u];
        if (e < nD) {
          const int t2 = e / 64, i = (e / 8) % 8, j = e % 8;
          for (int k = 0; k < m; ++k)
            v += (hdi[k] * J[k][t1 * 8 + i]) * J[k][t2 * 8 + j];
        } else if (e < nE) {
          const int i = (e - nD) / 4, c = (e - nD) % 4;
          for (int k = 0; k < m; ++k)
            v += (hdi[k] * J[k][t1 * 8 + i]) * hcd[k][c];
        } else {
          const int i = e - nE;
          for (int k = 0; k < m; ++k)
            v += (hdi[k] * bds[k]) * J[k][t1 * 8 + i];
        }
        acc[u] = v;
      }
      __syncthreads();
    }
  }
  const float nan = __int_as_float(0x7fc00000);
  const long long blk = ((long long)s * F + h) * F + t1;
  const bool bad_h = nfp & kNfHdiF;
#pragma unroll
  for (int u = 0; u < kScPer; ++u) {
    const int e = tid + u * kScBlock;
    if (e >= nAll) continue;
    if (e < nD) {
      const int t2 = e / 64, i = (e / 8) % 8, j = e % 8;
      const bool bad = bad_h || (nfj[t1] >> i & 1) || (nfj[t2] >> j & 1);
      a.accD[(blk * F + t2) * 64 + i * 8 + j] = bad ? nan : acc[u];
    } else if (e < nE) {
      const int i = (e - nD) / 4, c = (e - nD) % 4;
      const bool bad = bad_h || (nfj[t1] >> i & 1) || (nfp >> 2 >> c & 1);
      a.accE[(blk * 8 + i) * 4 + c] = bad ? nan : acc[u];
    } else {
      const int i = e - nE;
      const bool bad = (nfp & kNfHB) || (nfj[t1] >> i & 1);
      a.accEB[blk * 8 + i] = bad ? nan : acc[u];
    }
  }
}

}  // namespace

// part 0 (top): ptrs cuda_kernels._TOP_INPUTS, then TOP_OUTPUTS, then the
// flags and counts; ints: 0, S, P, F, mode. part 1 (Schur): ptrs
// _SC_INPUTS, then SC_OUTPUTS, then the two flag arrays; ints: 1, S, P, F,
// shift_prior. Queues the point pass and the block pass; returns the
// launches' CUDA error.
extern "C" int ldso_ba_accumulate(void** ptrs, const int* ints,
                                  const float* /*floats*/, void* stream) {
  const int part = ints[0], S = ints[1], P = ints[2], F = ints[3];
  cudaStream_t st = (cudaStream_t)stream;
  const int per = kPointBlock / F;                // whole points a block
  const dim3 points((P + per - 1) / per, S);
  const dim3 blocks(F * F + 1, S);
  int k = 0;
  if (part == 0) {
    Top a;
    a.JIdx = (const float*)ptrs[k++];
    a.Jpdc = (const float*)ptrs[k++];
    a.Jpdxi = (const float*)ptrs[k++];
    a.JabF = (const float*)ptrs[k++];
    a.Jpdd = (const float*)ptrs[k++];
    a.resF = (const float*)ptrs[k++];
    a.res_toZero = (const float*)ptrs[k++];
    a.res_active = (const bool*)ptrs[k++];
    a.res_exist = (const bool*)ptrs[k++];
    a.res_linearized = (const bool*)ptrs[k++];
    a.frame_valid = (const bool*)ptrs[k++];
    a.pt_mask = (const bool*)ptrs[k++];
    a.pt_host = (const int64_t*)ptrs[k++];
    a.adHTdelta = (const float*)ptrs[k++];
    a.c_delta = (const float*)ptrs[k++];
    a.idepth = (const float*)ptrs[k++];
    a.idepth_zero = (const float*)ptrs[k++];
    a.acc = (float*)ptrs[k++];
    a.Hdd = (float*)ptrs[k++];
    a.bd = (float*)ptrs[k++];
    a.Hcd = (float*)ptrs[k++];
    a.nres = (int64_t*)ptrs[k++];
    a.flags = (int*)ptrs[k++];
    a.count = (int*)ptrs[k++];
    a.S = S;
    a.P = P;
    a.F = F;
    a.mode = ints[4];
    top_points<<<points, kPointBlock, 0, st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    top_blocks<<<blocks, kTopBlock, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  Sc a;
  a.JIdx = (const float*)ptrs[k++];
  a.JabF = (const float*)ptrs[k++];
  a.Jpdxi = (const float*)ptrs[k++];
  a.Jpdd = (const float*)ptrs[k++];
  a.res_active = (const bool*)ptrs[k++];
  a.res_exist = (const bool*)ptrs[k++];
  a.frame_valid = (const bool*)ptrs[k++];
  a.pt_mask = (const bool*)ptrs[k++];
  a.pt_host = (const int64_t*)ptrs[k++];
  a.pt_prior = (const float*)ptrs[k++];
  a.idepth = (const float*)ptrs[k++];
  a.idepth_zero = (const float*)ptrs[k++];
  a.Hdd_tot = (const float*)ptrs[k++];
  a.bd_tot = (const float*)ptrs[k++];
  a.Hcd_tot = (const float*)ptrs[k++];
  a.HdiF = (float*)ptrs[k++];
  a.bdSum = (float*)ptrs[k++];
  a.Hcd = (float*)ptrs[k++];
  a.JpJdF = (float*)ptrs[k++];
  a.ngood = (int64_t*)ptrs[k++];
  a.Hcc_sc = (float*)ptrs[k++];
  a.bc_sc = (float*)ptrs[k++];
  a.accE = (float*)ptrs[k++];
  a.accEB = (float*)ptrs[k++];
  a.accD = (float*)ptrs[k++];
  a.jflags = (int*)ptrs[k++];
  a.pflags = (int*)ptrs[k++];
  a.S = S;
  a.P = P;
  a.F = F;
  a.shift_prior = ints[4];
  sc_points<<<points, kPointBlock, 0, st>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sc_blocks<<<blocks, kScBlock, 0, st>>>(a);
  return (int)cudaGetLastError();
}
