// K7: the windowed BA's accumulation, hand-written for Hopper (sm_90a).
// One call per accumulation, from ldso_tpu_torch/ops/cuda_kernels.
// ba_accumulate_top and ba_accumulate_sc; each call queues two grids on
// the stream, the point stage and the chunk stage, and counts as one
// launch.
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
// Sums, in one fixed order (tests/torch_kernel_checks.acc_emulated writes
// it out in plain PyTorch, and the card holds K7 to it bit for bit): a
// residual's sums over its 8 taps (Hdd, bd, Hcd's 2x2 products, JpJdF's)
// by sum8's tree ((x0 + x1) + (x2 + x3)) + ((x4 + x5) + (x6 + x7)); a
// host's points are listed in point order (the points in pt_mask, the
// host clamped to the slots) and cut into chunks of kChunk; a chunk's sum
// of an entry runs over its points in order from 0.0, each point's term
// the 8 taps' products by the same tree in the top part, one product in
// the Schur part; the chunks' sums are added in chunk order from 0.0.
// Hcc_sc and bc_sc are summed per point-stage block (its points in
// order), the blocks in kHccSplit runs of consecutive ones, then the runs
// in order. This file is built with --fmad=false, so no multiply and add
// is contracted. No float atomics: a call repeats bit for bit. Its order
// is not the plain version's (torch_kernel_checks.acc_err holds it to a
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
// What the design does about that: the work is spread so that one window
// fills the card, no block walks points it does not use, and a block's
// loads go out together (its time is its chain of trips to memory).
//   * The point stage: eight lanes per residual, lane k on tap k, so a
//     warp's loads of the residuals' pieces are coalesced (and the Schur
//     part's JpJdF stores); 32 residuals (32 / F whole points) a block,
//     512 blocks at the main path's window. It writes each point's
//     pieces; each block ORs its non-finite flags by column in shared
//     memory, then into the window's one word a column with an integer
//     atomicOr, and adds its count (or the Schur part's point flags) to
//     the window's count word (integers: exact in any order; the wrapper
//     zeroes these words with the chunk stage's arrival counters). Its
//     last block builds the window's per-host point lists (each thread
//     kSeg consecutive points a round read in one trip, ranks by a warp
//     scan per host, a prefix over the warps, the rounds and the hosts).
//   * The chunk stage: one block per (target, chunk), F x (P / kChunk + F)
//     a window (576 at the main path's), each summing its chunk of one
//     host's points for one target into a partial in device memory: top,
//     the 91 entries of the 13x13 upper triangle, two threads an entry
//     (taps 0-3 and 4-7, the tree's last add by a shuffle); Schur, accD's
//     row (t1, i) for all t2 and j in one thread's registers from the
//     point's left factor hdi J[t1, i], accE and accEB alike. A chunk's
//     pieces come in one trip, 16 bytes a load. The last block to arrive
//     at its (host, target) (an integer counter; one fence by the
//     arriving thread) adds the host's chunk partials in chunk order,
//     reads the columns' flag words and writes the block.
//   * Two grids a call, not one: the chunk stage needs the lists, which
//     need every point's host and mask first; a grid cannot wait for
//     another part of itself inside a CUDA graph without a cooperative
//     launch. Launching the chunk stage as a programmatic dependent launch
//     of the point stage measured slower (by 0.3-2.7 us a call), so it is
//     an ordinary launch.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 8;
constexpr int kRows = 13;
constexpr int kEntries = kRows * (kRows + 1) / 2;   // the upper triangle
constexpr int kMaxF = 32;                           // BA_MAX_SLOTS
constexpr int kPointBlock = 256;   // threads of a point-stage block
constexpr int kLanes = 8;          // lanes a residual, lane k on tap k
constexpr int kRes = kPointBlock / kLanes;        // ACC_RESIDUALS
constexpr int kChunk = 32;                          // ACC_CHUNK
constexpr int kTopBlock = 192;    // two threads an entry (taps 0-3, 4-7)
constexpr int kScBlock = 256;
constexpr int kRaw = 64;          // words of a residual's pieces (top stage)
constexpr int kHcc = 20;          // Hcc_sc's 16 entries and bc_sc's 4
constexpr int kHccSplit = 8;      // runs of point-stage blocks (ACC_HCC_RUNS)
// the shared memory a block may use without opting in
constexpr int kSmemBytes = 48 * 1024;
constexpr int kMeta = 2 * (kMaxF + 1);
constexpr int kSeg = 8;           // points a thread per round of build_lists
constexpr unsigned kFull = 0xffffffffu;

// A call's scratch, per window: ints (the point lists and their ranks, the
// hosts' list starts and chunk starts), floats (the chunk partials,
// [target][chunk][entry]; the Schur part's Hcc partials) and zeroed ints
// (the chunk stage's arrival counters, [host][target]; the column flag
// words; the count word: the top part's count, the Schur part's point
// flags).
struct Layout {
  int nbA, nch, E;
  long long list, rank, meta, ni;
  long long partial, hcc, nf;
  long long counters, cols, word, nz;
};

Layout layout(int part, int P, int F) {
  Layout L;
  const int per = kRes / F;
  L.nbA = (P + per - 1) / per;
  L.nch = (P + kChunk - 1) / kChunk + F;
  L.E = part == 0 ? kEntries : F * 64 + 40;
  long long o = 0;
  L.list = o;
  o += P;
  L.rank = o;
  o += P;
  L.meta = o;
  o += kMeta;
  L.ni = o;
  L.partial = 0;
  o = (long long)F * L.nch * L.E;
  L.hcc = o;
  if (part == 1) o += (long long)L.nbA * kHcc;
  L.nf = o;
  L.counters = 0;
  L.cols = (long long)F * F;
  L.word = L.cols + F;
  L.nz = L.word + 1;
  return L;
}

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
  int* iscr;                // (S, L.ni)
  float* fscr;              // (S, L.nf)
  int* zscr;                // (S, L.nz), zeroed
  Layout L;
  int S, P, F, mode, vec;   // vec: the pieces may be read 16 bytes a load
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
  int* pflags;              // (P,): see kHas and the bits below it
  int* iscr;
  float* fscr;
  int* zscr;
  Layout L;
  int S, P, F, shift_prior;
  int tile;   // chunk partials a Schur finisher stages at a time
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

__device__ __forceinline__ float4 ld4(const float* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(p[0], p[1], p[2], p[3]);
}

// the hosts (clamped; -1 outside pt_mask or past P) of points p0 ..
// p0 + kSeg - 1 of window q0 / P, 16 and 8 bytes a load where aligned
__device__ __forceinline__ void seg_hosts(const int64_t* pt_host,
                                          const bool* pt_mask, long long q0,
                                          int p0, int P, int F, int hs[kSeg]) {
  const int64_t* ph = pt_host + q0 + p0;
  const bool* pm = pt_mask + q0 + p0;
  if (p0 + kSeg <= P && ((uintptr_t)ph & 15u) == 0 &&
      ((uintptr_t)pm & 7u) == 0) {
    const uint2 m = *reinterpret_cast<const uint2*>(pm);
    long long hv[kSeg];
#pragma unroll
    for (int u = 0; u < kSeg / 2; ++u) {
      const longlong2 x = reinterpret_cast<const longlong2*>(ph)[u];
      hv[2 * u] = x.x;
      hv[2 * u + 1] = x.y;
    }
#pragma unroll
    for (int u = 0; u < kSeg; ++u) {
      const unsigned byte = ((u < 4 ? m.x : m.y) >> (8 * (u & 3))) & 0xffu;
      const int h = (int)hv[u];
      hs[u] = byte ? (h < 0 ? 0 : (h >= F ? F - 1 : h)) : -1;
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < kSeg; ++u) {
    const int p = p0 + u;
    hs[u] = p < P && pm[u] ? host_of(pt_host, q0 + p, F) : -1;
  }
}

// The last block of a point stage, for window s (`w` its ints): the list
// of the points in pt_mask by host (clamped), in point order within each
// host; meta: each host's list start (F + 1) and chunk start (F + 1; a
// host has max(1, ceil(n / kChunk)) chunks, the last one short or empty).
// Each thread takes kSeg consecutive points a round (one trip to memory
// for their hosts and masks); a point's rank in its host is its earlier
// points' of the same host in the thread, the lanes' before it (a warp
// scan per host), the warps' before it and the earlier rounds'. With one
// round (P <= 2048) the ranks stay in registers; with more they go to
// memory and a second pass reads them back, which costs the block two
// more trips (1.6-1.7 us a call at the main path's window, measured by
// tests/tools/ba_kernel_turns.py on the H100).
__device__ void build_lists(const int64_t* pt_host, const bool* pt_mask,
                            int s, int P, int F, int* w, const Layout& L) {
  __shared__ int wrel[kPointBlock / 32][kMaxF];
  __shared__ int base[kMaxF];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q0 = (long long)s * P;
  if (tid < kMaxF) base[tid] = 0;
  __syncthreads();
  int hs[kSeg], rk[kSeg];
  for (int r0 = 0; r0 < P; r0 += kPointBlock * kSeg) {
    const int p0 = r0 + tid * kSeg;
    seg_hosts(pt_host, pt_mask, q0, p0, P, F, hs);
#pragma unroll
    for (int u = 0; u < kSeg; ++u) {
      int c = 0;
#pragma unroll
      for (int v = 0; v < u; ++v) c += hs[v] == hs[u] ? 1 : 0;
      rk[u] = c;
    }
    for (int h = 0; h < F; ++h) {
      int c = 0;
#pragma unroll
      for (int u = 0; u < kSeg; ++u) c += hs[u] == h ? 1 : 0;
      int inc = c;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, d);
        if (lane >= d) inc += y;
      }
      if (lane == 31) wrel[warp][h] = inc;
#pragma unroll
      for (int u = 0; u < kSeg; ++u)
        if (hs[u] == h) rk[u] += inc - c;
    }
    __syncthreads();
    if (tid < F) {
      int at = base[tid];
      for (int v = 0; v < kPointBlock / 32; ++v) {
        const int n = wrel[v][tid];
        wrel[v][tid] = at;
        at += n;
      }
      base[tid] = at;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kSeg; ++u)
      if (hs[u] >= 0) rk[u] += wrel[warp][hs[u]];
    if (P > kPointBlock * kSeg) {
#pragma unroll
      for (int u = 0; u < kSeg; ++u)
        if (hs[u] >= 0) w[L.rank + p0 + u] = rk[u];
    }
    __syncthreads();
  }
  int* meta = w + L.meta;
  if (tid == 0) {
    int start = 0, ch = 0;
    for (int h = 0; h < F; ++h) {
      const int n = base[h];
      meta[h] = start;
      meta[kMaxF + 1 + h] = ch;
      base[h] = start;
      start += n;
      ch += max(1, (n + kChunk - 1) / kChunk);
    }
    meta[F] = start;
    meta[kMaxF + 1 + F] = ch;
  }
  __syncthreads();
  if (P <= kPointBlock * kSeg) {            // one round: ranks in registers
#pragma unroll
    for (int u = 0; u < kSeg; ++u)
      if (hs[u] >= 0) w[L.list + base[hs[u]] + rk[u]] = tid * kSeg + u;
    return;
  }
  for (int r0 = 0; r0 < P; r0 += kPointBlock * kSeg) {
    const int p0 = r0 + tid * kSeg;
    seg_hosts(pt_host, pt_mask, q0, p0, P, F, hs);
#pragma unroll
    for (int u = 0; u < kSeg; ++u) rk[u] = hs[u] >= 0 ? w[L.rank + p0 + u] : 0;
#pragma unroll
    for (int u = 0; u < kSeg; ++u)
      if (hs[u] >= 0) w[L.list + base[hs[u]] + rk[u]] = p0 + u;
  }
}

// the window's meta (list starts, chunk starts) into shared memory
__device__ __forceinline__ void load_meta(const int* meta, int* sm) {
  for (int i = threadIdx.x; i < kMeta; i += blockDim.x) sm[i] = meta[i];
}

// chunk cg of the window's list (sm: its meta in shared memory): its
// host, first list entry and length (0 for an empty host's chunk); false
// past the window's chunks
__device__ __forceinline__ bool chunk_of(const int* sm, int F, int cg,
                                         int& h, int& first, int& m) {
  const int* chs = sm + kMaxF + 1;
  if (cg >= chs[F]) return false;
  h = 0;
  while (h + 1 < F && chs[h + 1] <= cg) ++h;
  first = sm[h] + (cg - chs[h]) * kChunk;
  m = max(0, min(kChunk, sm[h + 1] - first));
  return true;
}

// an entry's chunk partials c0 .. c1 - 1 (`stride` floats apart) added in
// chunk order from 0.0, eight loads in flight at a time
__device__ __forceinline__ float chunk_total(const float* part,
                                             long long stride, int c0,
                                             int c1) {
  float tot = 0.0f;
  for (int c = c0; c < c1; c += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = c + u < c1 ? __ldcg(part + (long long)(c + u) * stride) : 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c + u < c1) tot = tot + v[u];
  }
  return tot;
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

// J delta's (Jp_x, Jp_y) of a residual (AccumulatedTopHessian.cc:40-66):
// xi its Jpdxi (12), jc its Jpdc (8), jd its Jpdd (2)
__device__ __forceinline__ void j_delta(const float* xi, const float* jc,
                                        const float* jd, const float* dp,
                                        const float* cd, float dd,
                                        float Jp[2]) {
  for (int x = 0; x < 2; ++x) {
    float v = 0.0f;
    for (int j = 0; j < 6; ++j) v = v + xi[x * 6 + j] * dp[j];
    float w = 0.0f;
    for (int j = 0; j < 4; ++j) w = w + jc[x * 4 + j] * cd[j];
    Jp[x] = (v + w) + jd[x] * dd;
  }
}

// resApprox of a tap (res0 its resF or res_toZero; mode 1 adds J delta):
// j0, j1 the tap's JIdx, b0, b1 its JabF
__device__ __forceinline__ float tap_res(float res0, float j0, float j1,
                                         float b0, float b1, const float* dp,
                                         const float Jp[2]) {
  return res0 + (((j0 * Jp[0] + j1 * Jp[1]) + b0 * dp[6]) + b1 * dp[7]);
}

// the 13 row entries of a tap (unmasked)
__device__ __forceinline__ void top_row(float j0, float j1, const float* jc,
                                        const float* xi, float b0, float b1,
                                        float res, float row[13]) {
  for (int c = 0; c < 4; ++c) row[c] = j0 * jc[c] + j1 * jc[4 + c];
  for (int c = 0; c < 6; ++c) row[4 + c] = j0 * xi[c] + j1 * xi[6 + c];
  row[10] = b0;
  row[11] = b1;
  row[12] = res;
}

// sum8's tree over the eight lanes of a residual (`group` their mask),
// lane k holding tap k's term: every lane ends with ((x0 + x1) + (x2 +
// x3)) + ((x4 + x5) + (x6 + x7)), float addition being commutative
__device__ __forceinline__ float lane_sum8(float v, unsigned group) {
  v = v + __shfl_xor_sync(group, v, 1);
  v = v + __shfl_xor_sync(group, v, 2);
  return v + __shfl_xor_sync(group, v, 4);
}
__device__ __forceinline__ int lane_or8(int v, unsigned group) {
  v |= __shfl_xor_sync(group, v, 1);
  v |= __shfl_xor_sync(group, v, 2);
  return v | __shfl_xor_sync(group, v, 4);
}

// the point stage: eight lanes per residual, lane k on tap k (its loads
// of the residual's pieces coalesced), a block's residuals those of
// kRes / F whole points; the sums over the taps by sum8's tree over the
// lanes; each point's sums over its targets taken by its target-0
// residual in target order; the block's column flags are ORed into the
// window's column words and its count added to its count word; the last
// block builds the lists
__global__ void __launch_bounds__(kPointBlock) top_points(Top a) {
  __shared__ float terms[kRes][6];                 // bd, Hdd, Hcd (4)
  __shared__ int masked[kRes];
  __shared__ int colf[kMaxF];
  __shared__ int count;
  const int s = blockIdx.y, F = a.F;
  if (blockIdx.x == a.L.nbA) {
    build_lists(a.pt_host, a.pt_mask, s, a.P, F,
                a.iscr + (long long)s * a.L.ni, a.L);
    return;
  }
  int* z = a.zscr + (long long)s * a.L.nz;
  if (threadIdx.x < kMaxF) colf[threadIdx.x] = 0;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  const int per = kRes / F;
  const int j = threadIdx.x / kLanes, k = threadIdx.x % kLanes;
  const unsigned group = 0xffu << ((threadIdx.x & 31) & ~(kLanes - 1));
  const int p = blockIdx.x * per + j / F;
  const int t = j % F;
  const bool live = j < per * F && p < a.P;
  if (live) {
    const long long q = (long long)s * a.P + p;
    const long long r = q * F + t;
    const bool m = top_mask(a, s, p, t);
    const float* ji = a.JIdx + r * 16;
    const float* jab = a.JabF + r * 16;
    const float* xi = a.Jpdxi + r * 12;
    const float j0 = ji[k], j1 = ji[8 + k];
    const float b0 = jab[k], b1 = jab[8 + k];
    const float r0 = (a.mode == 0 ? a.resF : a.res_toZero)[r * 8 + k];
    const float xk = xi[k], xk8 = k < 4 ? xi[8 + k] : 0.0f;
    const float ck = a.Jpdc[r * 8 + k];
    const float dk = k < 2 ? a.Jpdd[r * 2 + k] : 0.0f;
    // the residual's Jpdxi, Jpdc and Jpdd in every lane
    float X[12], C[8], D[2];
#pragma unroll
    for (int c = 0; c < 12; ++c)
      X[c] = __shfl_sync(group, c < 8 ? xk : xk8, c & 7, kLanes);
#pragma unroll
    for (int c = 0; c < 8; ++c) C[c] = __shfl_sync(group, ck, c, kLanes);
    D[0] = __shfl_sync(group, dk, 0, kLanes);
    D[1] = __shfl_sync(group, dk, 1, kLanes);
    float res = r0;
    if (a.mode == 1) {
      const float* dp = a.adHTdelta +
                        (((long long)s * F + host_of(a.pt_host, q, F)) * F +
                         t) * 8;
      float Jp[2];
      j_delta(X, C, D, dp, a.c_delta + (long long)s * 4,
              a.idepth[q] - a.idepth_zero[q], Jp);
      res = tap_res(r0, j0, j1, b0, b1, dp, Jp);
    }
    float row[13];
    top_row(j0, j1, C, X, b0, b1, res, row);
    int nf = 0;
    for (int c = 0; c < kRows; ++c)
      if (!isfinite(row[c])) nf |= 1 << c;
    nf = lane_or8(nf, group);
    const float jr0 = lane_sum8(j0 * res, group);
    const float jr1 = lane_sum8(j1 * res, group);
    const float j00 = lane_sum8(j0 * j0, group);
    const float j01 = lane_sum8(j0 * j1, group);
    const float j11 = lane_sum8(j1 * j1, group);
    const float g0 = j00 * D[0] + j01 * D[1];
    const float g1 = j01 * D[0] + j11 * D[1];
    const float mf = m ? 1.0f : 0.0f;
    if (k == 0) {
      float* tm = terms[j];
      tm[0] = mf * (jr0 * D[0] + jr1 * D[1]);
      tm[1] = mf * (g0 * D[0] + g1 * D[1]);
      for (int c = 0; c < 4; ++c) tm[2 + c] = mf * (C[c] * g0 + C[4 + c] * g1);
      masked[j] = m ? 1 : 0;
      if (nf) atomicOr(&colf[t], nf);
    }
  }
  __syncthreads();
  if (live && t == 0 && k == 0) {
    float sum[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    int n = 0;
    for (int u = 0; u < F; ++u) {
      for (int c = 0; c < 6; ++c) sum[c] = sum[c] + terms[j + u][c];
      n += masked[j + u];
    }
    const long long q = (long long)s * a.P + p;
    a.bd[q] = sum[0];
    a.Hdd[q] = sum[1];
    for (int c = 0; c < 4; ++c) a.Hcd[q * 4 + c] = sum[2 + c];
    if (n) atomicAdd(&count, n);
  }
  __syncthreads();
  if (threadIdx.x < F && colf[threadIdx.x])
    atomicOr(z + a.L.cols + threadIdx.x, colf[threadIdx.x]);
  if (threadIdx.x == 0 && count) atomicAdd(z + a.L.word, count);
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

// the chunk stage: block (t, cg) sums the 91 entries over the masked
// residuals (p, t) of chunk cg's points, in list order; the last block of
// its (host, t) adds the host's chunks in order and writes the block;
// block (0, 0) writes the count
__global__ void __launch_bounds__(kTopBlock) top_chunks(Top a) {
  __shared__ __align__(16) float raw[kChunk][kRaw];
  __shared__ float rows[kChunk][kTaps][kRows];
  __shared__ int pts[kChunk];
  __shared__ bool inc[kChunk];
  __shared__ float dd[kChunk], dp[8], cd[4];
  __shared__ bool last;
  __shared__ int sm[kMeta];
  const int s = blockIdx.y, F = a.F, P = a.P, tid = threadIdx.x;
  const int nch = a.L.nch;
  const int t = blockIdx.x / nch, cg = blockIdx.x % nch;
  int* w = a.iscr + (long long)s * a.L.ni;
  int* z = a.zscr + (long long)s * a.L.nz;
  load_meta(w + a.L.meta, sm);
  if (blockIdx.x == 0 && tid == 0) a.nres[s] = z[a.L.word];
  __syncthreads();
  int h, first, m;
  if (!chunk_of(sm, F, cg, h, first, m)) return;
  if (tid < kChunk) pts[tid] = tid < m ? w[a.L.list + first + tid] : -1;
  __syncthreads();
  // the pieces of the included residuals: JIdx [0, 16), JabF [16, 32),
  // Jpdxi [32, 44), Jpdc [44, 52), the residual column [52, 60), Jpdd
  // [60, 62)
  // (every thread's loads issued before any is stored)
  const float* res0 = a.mode == 0 ? a.resF : a.res_toZero;
  const bool vec = a.vec;
  constexpr int kLoads = (kChunk * 16 + kTopBlock - 1) / kTopBlock;
  float4 v[kLoads];
  int at[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int x = tid + u * kTopBlock;
    at[u] = -1;
    if (x >= kChunk * 16) continue;
    const int i = x >> 4, q = x & 15;
    if (pts[i] < 0) continue;
    const long long r = ((long long)s * P + pts[i]) * F + t;
    const float* src =
        q < 4 ? a.JIdx + r * 16 + 4 * q
      : q < 8 ? a.JabF + r * 16 + 4 * (q - 4)
      : q < 11 ? a.Jpdxi + r * 12 + 4 * (q - 8)
      : q < 13 ? a.Jpdc + r * 8 + 4 * (q - 11)
      : q < 15 ? res0 + r * 8 + 4 * (q - 13) : a.Jpdd + r * 2;
    v[u] = q < 15 ? ld4(src, vec) : make_float4(src[0], src[1], 0.0f, 0.0f);
    at[u] = i * kRaw + 4 * q;
  }
  // with them: the mask, mode 1's idepth steps, the pair's adHTdelta and
  // c_delta
  if (tid < kChunk) {
    const int p = pts[tid];
    inc[tid] = p >= 0 && top_mask(a, s, p, t);
    if (a.mode == 1 && p >= 0)
      dd[tid] = a.idepth[(long long)s * P + p] -
                a.idepth_zero[(long long)s * P + p];
  } else if (tid < kChunk + 8) {
    dp[tid - kChunk] =
        a.adHTdelta[(((long long)s * F + h) * F + t) * 8 + tid - kChunk];
  } else if (tid < kChunk + 12) {
    cd[tid - kChunk - 8] = a.c_delta[(long long)s * 4 + tid - kChunk - 8];
  }
#pragma unroll
  for (int u = 0; u < kLoads; ++u)
    if (at[u] >= 0) *reinterpret_cast<float4*>(&raw[0][0] + at[u]) = v[u];
  __syncthreads();
  for (int y = tid; y < kChunk * kTaps; y += kTopBlock) {
    const int i = y >> 3, k = y & 7;
    if (!inc[i]) continue;
    const float* ji = raw[i];
    const float* jab = ji + 16;
    const float* xi = ji + 32;
    const float* jc = ji + 44;
    float res = ji[52 + k];
    if (a.mode == 1) {
      float Jp[2];
      j_delta(xi, jc, ji + 60, dp, cd, dd[i], Jp);
      res = tap_res(res, ji[k], ji[8 + k], jab[k], jab[8 + k], dp, Jp);
    }
    top_row(ji[k], ji[8 + k], jc, xi, jab[k], jab[8 + k], res, rows[i][k]);
  }
  __syncthreads();
  // entry e by threads 2e (taps 0-3) and 2e + 1 (taps 4-7): each half's
  // tree, then the pair's sum (the tree's last add; both threads get it)
  float* part = a.fscr + (long long)s * a.L.nf + a.L.partial;
  const int half = tid & 1;
  int ei = 0, ej = 0;
  entry_rc(min(tid >> 1, kEntries - 1), ei, ej);
  float acc = 0.0f;
  for (int i = 0; i < m; ++i) {
    if (!inc[i]) continue;
    const float(*rk)[kRows] = rows[i] + 4 * half;
    const float hs = (rk[0][ei] * rk[0][ej] + rk[1][ei] * rk[1][ej]) +
                     (rk[2][ei] * rk[2][ej] + rk[3][ei] * rk[3][ej]);
    acc = acc + (hs + __shfl_xor_sync(kFull, hs, 1));
  }
  if (!half && (tid >> 1) < kEntries)
    part[((long long)t * nch + cg) * kEntries + (tid >> 1)] = acc;
  __syncthreads();
  const int* chs = sm + kMaxF + 1;
  if (tid == 0) {
    __threadfence();        // the block's partials, then its arrival
    last = atomicAdd(z + a.L.counters + h * F + t, 1) ==
           chs[h + 1] - chs[h] - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int nfs = z[a.L.cols + t];
  if (tid < kEntries) {
    entry_rc(tid, ei, ej);
    const float tot = chunk_total(part + (long long)t * nch * kEntries + tid,
                                  kEntries, chs[h], chs[h + 1]);
    const bool bad = (nfs >> ei & 1) || (nfs >> ej & 1);
    const float v = bad ? __int_as_float(0x7fc00000) : tot;
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

// the point stage: eight lanes per residual, lane k on tap k (the 2x2
// products' sums over the taps by sum8's tree over the lanes) and then on
// JpJdF's entry k, so its loads and JpJdF's stores are coalesced; a
// block's residuals those of kRes / F whole points; each point's pieces
// by its target-0 residual; the block's Hcc_sc and bc_sc over its points
// in order; its column flags are ORed into the window's column words and
// its point flags into its count word; the last block builds the lists
__global__ void __launch_bounds__(kPointBlock) sc_points(Sc a) {
  __shared__ int active[kRes];
  __shared__ int colf[kMaxF];
  __shared__ int pfs;
  __shared__ float hdi[kRes], bds[kRes], hcd[kRes][4];
  const int s = blockIdx.y, F = a.F;
  if (blockIdx.x == a.L.nbA) {
    build_lists(a.pt_host, a.pt_mask, s, a.P, F,
                a.iscr + (long long)s * a.L.ni, a.L);
    return;
  }
  int* z = a.zscr + (long long)s * a.L.nz;
  if (threadIdx.x < kMaxF) colf[threadIdx.x] = 0;
  if (threadIdx.x == 0) pfs = 0;
  __syncthreads();
  const int per = kRes / F;
  const int j = threadIdx.x / kLanes, k = threadIdx.x % kLanes;
  const unsigned group = 0xffu << ((threadIdx.x & 31) & ~(kLanes - 1));
  const int slot = j / F;
  const int p = blockIdx.x * per + slot;
  const int t = j % F;
  const bool live = j < per * F && p < a.P;
  const long long q = (long long)s * a.P + p;
  if (live) {
    const long long r = q * F + t;
    const float* ji = a.JIdx + r * 16;
    const float* jab = a.JabF + r * 16;
    const float* xi = a.Jpdxi + r * 12;
    const float j0 = ji[k], j1 = ji[8 + k];
    const float b0 = jab[k], b1 = jab[8 + k];
    const float x0 = k < 6 ? xi[k] : 0.0f, x1 = k < 6 ? xi[6 + k] : 0.0f;
    const float jd0 = a.Jpdd[r * 2], jd1 = a.Jpdd[r * 2 + 1];
    const float j00 = lane_sum8(j0 * j0, group);
    const float j01 = lane_sum8(j0 * j1, group);
    const float j11 = lane_sum8(j1 * j1, group);
    const float a00 = lane_sum8(b0 * j0, group);
    const float a01 = lane_sum8(b0 * j1, group);
    const float a10 = lane_sum8(b1 * j0, group);
    const float a11 = lane_sum8(b1 * j1, group);
    const float g0 = j00 * jd0 + j01 * jd1;
    const float g1 = j01 * jd0 + j11 * jd1;
    const bool act = sc_act(a, s, p, t);
    const float af = act ? 1.0f : 0.0f;
    const float v = k < 6 ? (x0 * g0 + x1 * g1) * af
                          : (k == 6 ? (a00 * jd0 + a01 * jd1) * af
                                    : (a10 * jd0 + a11 * jd1) * af);
    a.JpJdF[r * 8 + k] = v;
    const int nf = lane_or8(isfinite(v) ? 0 : 1 << k, group);
    if (k == 0) {
      if (nf) atomicOr(&colf[t], nf);
      active[j] = act ? 1 : 0;
    }
  }
  __syncthreads();
  if (live && t == 0 && k == 0) {
    long long ngood = 0;
    for (int u = 0; u < F; ++u) ngood += active[j + u];
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
      hcd[slot][c] = h;
      if (!isfinite(h)) pf |= kNfHcd << c;
    }
    a.HdiF[q] = HdiF;
    a.bdSum[q] = bdSum;
    a.ngood[q] = ngood;
    a.pflags[q] = pf;
    hdi[slot] = HdiF;
    bds[slot] = bdSum;
    if (pf & ~kHas) atomicOr(&pfs, pf & ~kHas);
  }
  __syncthreads();
  if (threadIdx.x < kHcc) {
    const int e = threadIdx.x;
    const int i = e < 16 ? e / 4 : e - 16, c = e % 4;
    const int n = min(per, a.P - (int)blockIdx.x * per);
    float acc = 0.0f;
    for (int u = 0; u < n; ++u) {
      const float x = hdi[u] * hcd[u][i];
      acc = acc + (e < 16 ? x * hcd[u][c] : x * bds[u]);
    }
    a.fscr[(long long)s * a.L.nf + a.L.hcc + blockIdx.x * kHcc + e] = acc;
  }
  if (threadIdx.x < F && colf[threadIdx.x])
    atomicOr(z + a.L.cols + threadIdx.x, colf[threadIdx.x]);
  if (threadIdx.x == 0 && pfs) atomicOr(z + a.L.word, pfs);
}

// the chunk stage: block (t1, cg) sums accD[h, t1], accE[h, t1] and
// accEB[h, t1] over chunk cg's points with `has`, in list order; the last
// block of its (host, t1) adds the host's chunks in order and writes them;
// the window's last block adds Hcc_sc and bc_sc over the point stage's
// blocks in order
__global__ void __launch_bounds__(kScBlock, 4) sc_chunks(Sc a) {
  // [kChunk][F * 8] JpJdF rows; the finisher's partials and totals
  extern __shared__ __align__(16) float J[];
  __shared__ int pts[kChunk];
  __shared__ bool has[kChunk];
  __shared__ float hdi[kChunk], bds[kChunk], hcd[kChunk][4];
  __shared__ float left[kChunk][9];      // hdi J[t1, i] (8), hdi bds
  __shared__ int nfj[kMaxF];
  __shared__ bool last;
  __shared__ int sm[kMeta];
  const int s = blockIdx.y, F = a.F, P = a.P, tid = threadIdx.x;
  const int nch = a.L.nch;
  int* w = a.iscr + (long long)s * a.L.ni;
  int* z = a.zscr + (long long)s * a.L.nz;
  const float* fs = a.fscr + (long long)s * a.L.nf;
  if (blockIdx.x == F * nch) {
    // Hcc_sc and bc_sc: the point stage's block sums, each entry in
    // kHccSplit runs of consecutive blocks (one thread a run, in block
    // order from 0.0), then the runs in order from 0.0
    __shared__ float runs[kHccSplit][kHcc];
    const int len = (a.L.nbA + kHccSplit - 1) / kHccSplit;
    if (tid < kHccSplit * kHcc) {
      const int g = tid / kHcc, e = tid % kHcc;
      const int b1 = min(a.L.nbA, (g + 1) * len);
      float acc = 0.0f;
      for (int b = g * len; b < b1; b += 8) {     // eight loads in flight
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = b + u < b1 ? __ldcg(fs + a.L.hcc + (b + u) * kHcc + e) : 0.0f;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (b + u < b1) acc = acc + v[u];
      }
      runs[g][e] = acc;
    }
    __syncthreads();
    if (tid < kHcc) {
      float tot = 0.0f;
      for (int g = 0; g < kHccSplit; ++g) tot = tot + runs[g][tid];
      if (tid < 16)
        a.Hcc_sc[(long long)s * 16 + tid] = tot;
      else
        a.bc_sc[(long long)s * 4 + tid - 16] = tot;
    }
    return;
  }
  const int t1 = blockIdx.x / nch, cg = blockIdx.x % nch;
  load_meta(w + a.L.meta, sm);
  __syncthreads();
  int h, first, m;
  if (!chunk_of(sm, F, cg, h, first, m)) return;
  if (tid < kChunk) pts[tid] = tid < m ? w[a.L.list + first + tid] : -1;
  __syncthreads();
  // one trip: the listed points' pieces and JpJdF rows (16 bytes a load)
  if (tid < kChunk) {
    bool hs = false;
    if (pts[tid] >= 0) {
      const long long q = (long long)s * P + pts[tid];
      hs = a.pflags[q] & kHas;
      hdi[tid] = a.HdiF[q];
      bds[tid] = a.bdSum[q];
      for (int c = 0; c < 4; ++c) hcd[tid][c] = a.Hcd[q * 4 + c];
    }
    has[tid] = hs;
  }
  const int row = F * 8;              // a point's JpJdF
  for (int x0 = tid; x0 < kChunk * (row / 4); x0 += 4 * kScBlock) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int x = x0 + u * kScBlock;
      const int i = x / (row / 4), c4 = x % (row / 4);
      if (x < kChunk * (row / 4) && pts[i] >= 0)
        v[u] = __ldg(reinterpret_cast<const float4*>(
                         a.JpJdF + ((long long)s * P + pts[i]) * row) + c4);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int x = x0 + u * kScBlock;
      const int i = x / (row / 4), c4 = x % (row / 4);
      if (x < kChunk * (row / 4) && pts[i] >= 0)
        *reinterpret_cast<float4*>(J + i * row + 4 * c4) = v[u];
    }
  }
  __syncthreads();
  const int nD = F * 64, nE = nD + 32, nAll = nE + 8;
  float* pbase = a.fscr + (long long)s * a.L.nf + a.L.partial;
  float* part = pbase + ((long long)t1 * nch + cg) * nAll;
  // item (t2, i): accD's row (t1, i; t2, 0..7), or (item F * 8 + i) accE's
  // row i and accEB's entry i; each point's left factor hdi J[t1, i] once
  for (int x = tid; x < kChunk * 9; x += kScBlock) {
    const int k = x / 9, i = x % 9;
    if (has[k])
      left[k][i] = i < 8 ? hdi[k] * J[k * row + t1 * 8 + i]
                         : hdi[k] * bds[k];
  }
  __syncthreads();
  for (int item = tid; item < F * 8 + 8; item += kScBlock) {
    const int i = item % 8;
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (item < F * 8) {
      const int t2 = item / 8;
      for (int k = 0; k < m; ++k) {
        if (!has[k]) continue;
        const float l = left[k][i];
        const float* J2 = J + k * row + t2 * 8;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[c] = acc[c] + l * J2[c];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) part[t2 * 64 + i * 8 + c] = acc[c];
    } else {
      for (int k = 0; k < m; ++k) {
        if (!has[k]) continue;
        const float l = left[k][i];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = acc[c] + l * hcd[k][c];
        acc[4] = acc[4] + left[k][8] * J[k * row + t1 * 8 + i];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) part[nD + i * 4 + c] = acc[c];
      part[nE + i] = acc[4];
    }
  }
  __syncthreads();
  const int* chs = sm + kMaxF + 1;
  if (tid == 0) {
    __threadfence();        // the block's partials, then its arrival
    last = atomicAdd(z + a.L.counters + h * F + t1, 1) ==
           chs[h + 1] - chs[h] - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the window's flag words (the columns' and the point flags'), then the
  // host's chunk partials a tile of chunks at a time through shared memory
  // (coalesced loads, eight in flight a thread), each entry added in chunk
  // order
  if (tid < F) nfj[tid] = z[a.L.cols + tid];
  const int nf1 = z[a.L.cols + t1], nfp = z[a.L.word];
  const int tile = a.tile;
  float* stage = J;
  float* total = J + tile * nAll;
  for (int e = tid; e < nAll; e += kScBlock) total[e] = 0.0f;
  for (int c0 = chs[h]; c0 < chs[h + 1]; c0 += tile) {
    const int n = min(tile, chs[h + 1] - c0) * nAll;
    const float* src = pbase + ((long long)t1 * nch + c0) * nAll;
    for (int x0 = tid; x0 < n; x0 += 8 * kScBlock) {
      float v[8];
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const int x = x0 + d * kScBlock;
        v[d] = x < n ? __ldcg(src + x) : 0.0f;
      }
#pragma unroll
      for (int d = 0; d < 8; ++d)
        if (x0 + d * kScBlock < n) stage[x0 + d * kScBlock] = v[d];
    }
    __syncthreads();
    for (int e = tid; e < nAll; e += kScBlock) {
      float acc = total[e];
      for (int c = 0; c < n / nAll; ++c) acc = acc + stage[c * nAll + e];
      total[e] = acc;
    }
    __syncthreads();
  }
  const float nan = __int_as_float(0x7fc00000);
  const long long blk = ((long long)s * F + h) * F + t1;
  const bool bad_h = nfp & kNfHdiF;
  for (int e = tid; e < nAll; e += kScBlock) {
    const float tot = total[e];
    if (e < nD) {
      const int t2 = e / 64, i = (e / 8) % 8, j = e % 8;
      const bool bad = bad_h || (nf1 >> i & 1) || (nfj[t2] >> j & 1);
      a.accD[(blk * F + t2) * 64 + i * 8 + j] = bad ? nan : tot;
    } else if (e < nE) {
      const int i = (e - nD) / 4, c = (e - nD) % 4;
      const bool bad = bad_h || (nf1 >> i & 1) || (nfp >> 2 >> c & 1);
      a.accE[(blk * 8 + i) * 4 + c] = bad ? nan : tot;
    } else {
      const int i = e - nE;
      const bool bad = (nfp & kNfHB) || (nf1 >> i & 1);
      a.accEB[blk * 8 + i] = bad ? nan : tot;
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// sc_chunks's dynamic shared memory at F slots, in what its static arrays
// leave of the 48 KB a block may use without opting in: a chunk's JpJdF
// rows, or a finisher's `tile` chunk partials (at most 8) and its totals
cudaError_t sc_smem(int F, int& tile, size_t& bytes) {
  static cudaFuncAttributes fa;
  static const cudaError_t got = cudaFuncGetAttributes(&fa, sc_chunks);
  if (got != cudaSuccess) return got;
  const int left = (kSmemBytes - (int)fa.sharedSizeBytes) / (int)sizeof(float);
  const int nAll = F * 64 + 40;
  tile = min(8, left / nAll - 1);
  const int need = max(kChunk * F * 8, (tile + 1) * nAll);
  if (tile < 1 || need > left) return cudaErrorInvalidConfiguration;
  bytes = (size_t)need * sizeof(float);
  return cudaSuccess;
}

}  // namespace

// The scratch of one call of `part` on a window of P points and F slots:
// out[0] int32 words, out[1] float32 words and out[2] int32 words that
// must be zero at the call, a window.
extern "C" int ldso_ba_accumulate_scratch(int part, int P, int F,
                                          long long* out) {
  const Layout L = layout(part, P, F);
  out[0] = L.ni;
  out[1] = L.nf;
  out[2] = L.nz;
  return 0;
}

// part 0 (top): ptrs cuda_kernels._TOP_INPUTS, then TOP_OUTPUTS, then the
// int, float and zeroed int scratch (ldso_ba_accumulate_scratch); ints: 0,
// S, P, F, mode. part 1 (Schur): ptrs _SC_INPUTS, then SC_OUTPUTS, then
// the point flags (S, P) and the three scratch arrays; ints: 1, S, P, F,
// shift_prior.
// Queues the point stage and the chunk stage; returns the launches' CUDA
// error.
extern "C" int ldso_ba_accumulate(void** ptrs, const int* ints,
                                  const float* /*floats*/, void* stream) {
  const int part = ints[0], S = ints[1], P = ints[2], F = ints[3];
  cudaStream_t st = (cudaStream_t)stream;
  const Layout L = layout(part, P, F);
  const dim3 points(L.nbA + 1, S);
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
    a.iscr = (int*)ptrs[k++];
    a.fscr = (float*)ptrs[k++];
    a.zscr = (int*)ptrs[k++];
    a.L = L;
    a.S = S;
    a.P = P;
    a.F = F;
    a.mode = ints[4];
    a.vec = aligned16(a.JIdx) && aligned16(a.JabF) && aligned16(a.Jpdxi) &&
            aligned16(a.Jpdc) && aligned16(a.resF) &&
            aligned16(a.res_toZero);
    top_points<<<points, kPointBlock, 0, st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    top_chunks<<<dim3(F * L.nch, S), kTopBlock, 0, st>>>(a);
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
  a.pflags = (int*)ptrs[k++];
  a.iscr = (int*)ptrs[k++];
  a.fscr = (float*)ptrs[k++];
  a.zscr = (int*)ptrs[k++];
  a.L = L;
  a.S = S;
  a.P = P;
  a.F = F;
  a.shift_prior = ints[4];
  size_t smem = 0;
  cudaError_t e = sc_smem(F, a.tile, smem);
  if (e != cudaSuccess) return (int)e;
  sc_points<<<points, kPointBlock, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sc_chunks<<<dim3(F * L.nch + 1, S), kScBlock, smem, st>>>(a);
  return (int)cudaGetLastError();
}
