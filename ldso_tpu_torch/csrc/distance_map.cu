// Chamfer distance map for activation spacing, hand-written for Hopper
// (sm_90a): bit-parallel reached sets, one block per band of rows.
//
// Replaces the TPU kernel `distance_transform_pallas` (body `_dist_kernel`)
// in ldso_tpu/ops/pallas_kernels.py, the rebuild of
// CoarseDistanceMap::growDistBFS (CoarseTracker.cc:724-812). It computes
// exactly the function of ldso_tpu_torch/ops/distance_map.py
// (distance_transform_ref): max_k - 1 min-plus relaxation sweeps over the
// (H, W) occupancy map, the 4-neighbourhood on every sweep and the
// diagonals added on odd sweeps, with sources only at interior pixels.
// Output: float32, 0 at occupied cells, k where first reached at sweep k,
// 1000.0 where unreachable.
//
// The function as sets. R_0 is the occupied cells and
//   R_k = R_{k-1} | N_k(R_{k-1} & I),
// I the interior cells (1 <= y <= H-2, 1 <= x <= W-2), N_k the 4-neighbour
// dilation on even k and the 8-neighbour one on odd k. A cell's output is
// the least k < max_k with the cell in R_k, else 1000. A set needs one bit
// per cell: row y is ceil(W / 32) 32-bit words (bit i of word w = column
// 32 w + i), a horizontal neighbour is a shift with the carry bit of the
// adjacent word, a vertical one the same word of the row above or below,
// and I is a per-word column mask and a per-row test. One 32-bit operation
// does the work of 32 cell tests.
//
// What bounds it: neither bytes nor operations. Device memory sees one
// read of the H*W occupancy bytes and one write of the H*W floats; the
// bit operations are a few per 32 cells and sweep. What is left is
// latency: the launch, and the chain of max_k - 1 dependent sweeps, each
// ended by a block barrier and each costing the instructions one SM
// issues for its rows.
//
// What the design does about it:
//  * Bands instead of one block. Each sweep moves a front by at most one
//    row, so a block that owns B output rows and loads them with max_k - 1
//    halo rows above and below (clamped at the image) computes them
//    exactly with no communication between blocks. Sweep k computes only
//    the rows within max_k - 1 - k of the band: every row it reads was
//    written by sweep k - 1, so all that a block computes is exact, and
//    the work per sweep shrinks towards the band. Rows are full width, so
//    there is no horizontal halo. A block's work per sweep is up to its
//    B + 2 (max_k - 1) rows, so the wrapper takes the smallest B that
//    keeps the ceil(H / B) blocks within one per SM
//    (ops/cuda_kernels.distance_plan): B = 2 at 240 x 320.
//  * Sweep k reads R_{k-1} and writes R_k into the other of two buffers
//    (never in place: a bit set during sweep k looks like an old one, and
//    would let a front advance several cells in one sweep), then one
//    barrier. A thread keeps one word column, with its masks, and takes
//    one word per row it owns: nine shared loads from clamped addresses,
//    masks, two funnel shifts per row and a few ORs, one store.
//  * Loads: a block's rows are one contiguous run of bytes. Each thread
//    turns 16-byte loads (from the 16-byte boundary below the run, so a
//    load may read up to 15 bytes beside the map but never leaves its
//    16-byte block of the allocation) into 16 bits of a stream in shared
//    memory, and a row's words are cut out of the stream with a funnel
//    shift, whatever the row's alignment.
//  * The first reach: the band's words of every R_k are kept (the sets
//    only grow), and each output cell bisects them for the least k that
//    holds it, so no thread loops over the bits a sweep sets. The band's
//    rows are contiguous in `out`: float32 stores are coalesced.
//  * State per block: 4 (ceil(W / 32) (2 min(H, B + 2 (max_k - 1)) +
//    max_k B) + 2) bytes, 4,328 at 240 x 320 with max_k 18 and B = 2,
//    within the 48 KB of dynamic shared memory a block gets without
//    opting in: no per-call attribute calls. The wrapper's plan
//    (distance_plan) sizes it, halves B until it fits and refuses a map
//    whose one-row band does not (for tall maps, about 4,400 columns at
//    max_k 18 and 1,980 at max_k 40).
// Tensor cores, TMA and cp.async do not apply: a block moves a few KB.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLoadChunks = 4;      // 16-byte loads each thread has in flight
constexpr int kOutCells = 2;        // output cells each thread has in flight
constexpr int kSmemLimit = 48 * 1024;

// 16 occupancy bytes -> 16 bits, bit i set where byte i is nonzero.
__device__ __forceinline__ uint32_t nonzero_bits16(uint4 q) {
  // per 4 bytes: 0x01 per nonzero byte, then the multiply gathers the
  // four bytes' low bits into bits 28..31 (no two partial products meet)
  auto nib = [](uint32_t v) {
    return ((__vcmpne4(v, 0u) & 0x01010101u) * 0x10204080u) >> 28;
  };
  return nib(q.x) | nib(q.y) << 4 | nib(q.z) << 8 | nib(q.w) << 12;
}

// Interior columns (1 <= x <= W - 2) of word w of a row; 0 off the row.
// `last` is the interior mask of the row's last word.
__device__ __forceinline__ uint32_t interior_cols(int w, int nw,
                                                  uint32_t last) {
  if (w < 0 || w >= nw) return 0u;
  return (w == 0 ? ~1u : ~0u) & (w == nw - 1 ? last : ~0u);
}

__global__ void __launch_bounds__(kThreads)
dist_bits_kernel(const uint8_t* __restrict__ occ, float* __restrict__ out,
                 int H, int W, int max_k, int band) {
  extern __shared__ uint32_t smem[];
  const int nw = (W + 31) >> 5;
  const int halo = max_k - 1;
  const int y0 = blockIdx.x * band;    // output rows [y0, y1)
  const int y1 = min(H, y0 + band);
  const int lo0 = max(0, y0 - halo);   // loaded rows [lo0, hi0)
  const int hi0 = min(H, y1 + halo);
  const int n_rows = hi0 - lo0;
  const int n_loaded = n_rows * nw;
  const int band_words = (y1 - y0) * nw;
  uint32_t* cur = smem;
  uint32_t* nxt = smem + n_loaded;
  uint32_t* hist = nxt + n_loaded + 2;    // band words of R_0 .. R_{max_k-1}
  const int tid = threadIdx.x;
  // the bits of the last word of a row that are columns (x < W), and
  // those that are interior columns (x <= W - 2)
  const int tail = W - 32 * (nw - 1);     // 1 .. 32
  const uint32_t tail_cols = tail == 32 ? ~0u : (1u << tail) - 1u;
  const uint32_t tail_interior = tail_cols >> 1;
  // Of the first col_step * nw threads, thread tid keeps word column
  // w = tid % nw and takes the rows tid / nw, tid / nw + col_step, ...
  const int w = tid % nw;
  const int col_step = kThreads / nw;
  const int r_first = tid < col_step * nw ? tid / nw : n_rows;

  // R_0 of the loaded rows as bits. The rows are one contiguous run of
  // bytes: 16-byte loads from the 16-byte boundary below its start
  // (which stay inside the allocation's 16-byte blocks) become a stream
  // of 16 bits each in `nxt`, and each row's words are cut out of the
  // stream with a funnel shift.
  {
    const uintptr_t start = reinterpret_cast<uintptr_t>(
        occ + static_cast<size_t>(lo0) * W);
    const uint4* chunks = reinterpret_cast<const uint4*>(start & ~uintptr_t{15});
    const int delta = static_cast<int>(start & 15);
    const int n_chunks = (delta + n_rows * W + 15) >> 4;
    uint16_t* stream16 = reinterpret_cast<uint16_t*>(nxt);
    for (int c0 = tid; c0 < n_chunks; c0 += kLoadChunks * kThreads) {
      uint4 q[kLoadChunks];
#pragma unroll
      for (int u = 0; u < kLoadChunks; ++u) {
        q[u] = __ldg(chunks + min(c0 + u * kThreads, n_chunks - 1));
      }
#pragma unroll
      for (int u = 0; u < kLoadChunks; ++u) {
        const int c = c0 + u * kThreads;
        if (c < n_chunks) stream16[c] = nonzero_bits16(q[u]);
      }
    }
    __syncthreads();
    for (int r = r_first; r < n_rows; r += col_step) {
      const int p = delta + r * W + 32 * w;          // bit offset
      uint32_t word = __funnelshift_r(nxt[p >> 5], nxt[(p >> 5) + 1], p & 31);
      if (w == nw - 1) word &= tail_cols;
      cur[r * nw + w] = word;
      const int y = lo0 + r;
      if (y >= y0 && y < y1) hist[(y - y0) * nw + w] = word;
    }
    __syncthreads();
  }

  // Sweeps. Per word: nine shared loads of R_{k-1} (the word and its left
  // and right neighbours in the rows above, at and below, from clamped
  // addresses), masks for the interior sources, funnel shifts and ORs,
  // one store of R_k.
  const uint32_t m_l = interior_cols(w - 1, nw, tail_interior);
  const uint32_t m_c = interior_cols(w, nw, tail_interior);
  const uint32_t m_r = interior_cols(w + 1, nw, tail_interior);
  const int to_l = w > 0 ? -1 : 0;
  const int to_r = w + 1 < nw ? 1 : 0;
  const int src_lo = max(lo0, 1);          // rows that can be sources
  const int src_hi = min(hi0 - 1, H - 2);
  for (int k = 1; k < max_k; ++k) {
    const int lo = max(lo0, y0 - (halo - k));   // this sweep's rows
    const int hi = min(hi0, y1 + (halo - k));
    const uint32_t diag = (k & 1) ? ~0u : 0u;
    uint32_t* hk = hist + k * band_words;
    for (int r = r_first; r < n_rows; r += col_step) {
      const int y = lo0 + r;
      if (y < lo || y >= hi) continue;
      const int a = r * nw + w;
      const int row_at[3] = {y - 1 >= src_lo ? a - nw : a, a,
                             y + 1 <= src_hi ? a + nw : a};
      const bool row_ok[3] = {y - 1 >= src_lo, y >= src_lo && y <= src_hi,
                              y + 1 <= src_hi};
      uint32_t side[3], src[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const uint32_t rm = row_ok[i] ? ~0u : 0u;
        const uint32_t c = cur[row_at[i]] & m_c & rm;
        const uint32_t lw = cur[row_at[i] + to_l] & m_l & rm;
        const uint32_t rw = cur[row_at[i] + to_r] & m_r & rm;
        src[i] = c;
        side[i] = __funnelshift_l(lw, c, 1) | __funnelshift_r(c, rw, 1);
      }
      const uint32_t now = cur[a] | side[1] | src[0] | src[2] |
                           ((side[0] | side[2]) & diag);
      nxt[a] = now;
      if (y >= y0 && y < y1) hk[(y - y0) * nw + w] = now;
    }
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  // Each band cell: the least k with the cell in R_k, by bisection over the
  // nested sets, the same number of steps for every cell. The band's rows
  // are contiguous in `out`, so the stores are coalesced.
  int steps = 0;
  while ((1 << steps) < max_k) ++steps;
  const int n_out = (y1 - y0) * W;
  float* o = out + static_cast<size_t>(y0) * W;
  for (int i0 = tid; i0 < n_out; i0 += kOutCells * kThreads) {
    int at[kOutCells], a[kOutCells], b[kOutCells];
    uint32_t bit[kOutCells];
#pragma unroll
    for (int c = 0; c < kOutCells; ++c) {
      const int i = min(i0 + c * kThreads, n_out - 1);
      const int r = i / W;
      const int x = i - r * W;
      at[c] = r * nw + (x >> 5);
      bit[c] = 1u << (x & 31);
      a[c] = 0;
      b[c] = max_k - 1;
    }
    for (int it = 0; it < steps; ++it) {
#pragma unroll
      for (int c = 0; c < kOutCells; ++c) {
        const int m = (a[c] + b[c]) >> 1;
        const bool in = (hist[m * band_words + at[c]] & bit[c]) != 0;
        b[c] = in ? m : b[c];
        a[c] = in ? a[c] : m + 1;
      }
    }
#pragma unroll
    for (int c = 0; c < kOutCells; ++c) {
      const int i = i0 + c * kThreads;
      if (i < n_out) {
        const bool reached =
            (hist[(max_k - 1) * band_words + at[c]] & bit[c]) != 0;
        o[i] = reached ? static_cast<float>(b[c]) : 1000.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

// occ: (H, W) uint8 (nonzero = occupied), out: (H, W) float32, both
// contiguous on the current device; launches ceil(H / band) blocks with
// `smem` bytes of dynamic shared memory each on `stream` and returns the
// launch's cudaError_t (0 on success). 1 <= max_k <= 255, 1 <= band <= H;
// `band` and `smem` come from the wrapper's plan
// (ops/cuda_kernels.distance_plan), the one place that knows the size of
// a block's state, and smem must be within 48 KB.
int ldso_distance_transform(const void* occ, void* out, int H, int W,
                            int max_k, int band, int smem, void* stream) {
  if (H < 1 || W < 1 || W > 32 * kThreads || max_k < 1 || max_k > 255 ||
      band < 1 || band > H || smem < 1 || smem > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dist_bits_kernel<<<(H + band - 1) / band, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(occ), static_cast<float*>(out), H, W,
      max_k, band);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
