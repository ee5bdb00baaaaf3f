// K12: the nullspace projector of the windowed BA's orthogonalization,
// hand-written for Hopper (sm_90a). One launch per BA call (per S windows
// under vmap), from ldso_tpu_torch/backend/ba_device.nullspace_projector.
//
// Replaces the SVD in the JAX package's `_orthogonalize_dev`
// (ldso_tpu/backend/ba_device.py:94, `jnp.linalg.svd` inside the BA's one
// device program) and the port's plain version
// (ba_device.nullspace_projector_ref, torch.linalg.svd). It has no
// `pallas_call`. On the card torch.linalg.svd reads its convergence flag on
// the host, so the BA could be neither captured in a CUDA graph nor run
// without a host read; this kernel reads nothing back.
//
// Function: for each window s, the (n, k) column-normalised basis Nn of
// the pose + scale nullspace (k = 7, n = 4 + 8F rows, zero rows for
// empty frame slots) gives the symmetric (n, n) projector
//     P = U_r U_r^T,  r = the singular values S > delta * max(S)
// (EnergyFunctional::orthogonalize's N (N^T N)^+ N^T with the reference's
// singular-value gate), written as float32.
//
// What bounds it on this card: neither bytes nor operations. A window is
// n k floats in and n^2 out (20,400 B at n = 68) and some 4 * 10^4
// operations: nanoseconds of the card's rates. The time is the launch and
// the serial chain of dependent steps that finds the singular vectors: on
// an H100 at n = 68 the Jacobi below is 20,694 of some 27,000 SM cycles
// (tests/tools/projector_turns.py --stamps), 28 rounds of two float64
// square roots and a division in a row and three levels of shuffles.
//
// What the design does about that: it shortens the chain. The earlier
// kernel ran one-sided Jacobi on the 68-row columns: some 40 rounds, each
// three float64 reductions over 68 rows in half of the block's warps and a
// block-wide barrier. Here the block
//   1. loads Nn once into shared memory as float64;
//   2. forms the Gram matrix G = Nn^T Nn: k (k + 1) / 2 = 28 dot products
//      over n rows, 8 lanes each, lane l summing rows l, l + 8, ... in
//      order and then the 8 lanes' xor tree, so every launch gives the
//      same bits;
//   3. solves the 8x8 (padded) eigenproblem G = V diag(lambda) V^T in warp
//      0 alone by cyclic two-sided Jacobi, V accumulated beside it: lane
//      4 x + c holds G's and V's entries (x, 2c) and (x, 2c + 1). Each
//      round rotates the same 4 disjoint round-robin pairs as the earlier
//      one-sided Jacobi (two-sided Jacobi on G makes its rotations), held
//      at seats (0,1), (2,3), (4,5), (6,7), the seats moved by shuffles
//      after each round. A round is an update in registers: each lane
//      computes its column pair's rotation, takes its row pair's by a
//      shuffle and its partner row by an xor shuffle. The warp's shuffles
//      are its only synchronisation. A sweep starts by testing every
//      off-diagonal |g_pq| <= kOrthTol sqrt(|g_pp g_qq|) (squared), the
//      test that would make the sweep rotate nothing, and stops there;
//   4. keeps the directions with lambda > delta^2 max(lambda), the same
//      gate as S > delta max(S) since S = sqrt(lambda), and forms
//      U' = Nn V_r lambda_r^(-1/2) (n, r) in shared memory;
//   5. writes P[i][j] = sum over the kept columns, in column order, of
//      U'[i][c] U'[j][c]: each thread a 4x4 tile of the upper triangle and
//      its mirror, in 16-byte rows where n is a multiple of 4. Products
//      commute, so P is symmetric bit for bit (what the plain version's
//      0.5 (P + P^T) makes of its own). Padding columns and dropped columns
//      take no work.
// Every float64 sum and product is one IEEE operation (__dadd_rn,
// __dmul_rn: no multiply-add is contracted), so the CPU emulation
// tests/torch_kernel_checks.projector_emulated follows it exactly.
//
// Precision: the Gram route squares the condition number kappa of the kept
// columns, so its error is about eps64 kappa^2, where the plain version's
// float32 SVD is held to 8 eps32 kappa (torch_kernel_checks.projector_err).
// The first is below the second while kappa <= 8 eps32 / eps64 (about
// 8.6e9); the gate keeps kappa <= 1 / delta = 1e5. A dropped direction's
// eigenvalue carries noise of about 1e-15 lambda_max, far below the gate's
// delta^2 = 1e-10, so the gate drops what the SVD's drops.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;          // columns, padded
constexpr int kMaxRows = 256;
constexpr int kMaxSweeps = 30;
constexpr double kOrthTol = 1e-15;
constexpr int kGroup = 8;         // lanes that sum one Gram entry
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double shfl(double x, int lane) {
  return __shfl_sync(kFull, x, lane);
}

// The round-robin tournament: pair w (0..3) of round t plays first(w, t)
// against second(w, t); player 0 stays, the others move one seat a round.
// Seat 2w holds first(w, t), seat 2w + 1 second(w, t).
__device__ __forceinline__ int player(int seat, int t) {
  const int w = seat >> 1;
  if (seat & 1) return 1 + (kCols - 2 - w + t) % (kCols - 1);
  return w == 0 ? 0 : 1 + (w - 1 + t) % (kCols - 1);
}

// The seat whose round-0 player sits at `seat` in round 1: after a round,
// seat x takes what seat next_seat(x) held.
__device__ __forceinline__ int next_seat(int seat) {
  int y = 0;
  for (int z = 0; z < kCols; ++z) {
    if (player(z, 0) == player(seat, 1)) y = z;
  }
  return y;
}

struct Rotation {
  double c, s, t;
  bool on;
};

// The rotation that zeroes g_pq (new column p = c p - s q, new column
// q = s p + c q; t = s / c), or none where |g_pq| <= kOrthTol
// sqrt(|g_pp g_qq|), tested squared. With d = g_qq - g_pp, r = sqrt(d^2 +
// 4 g_pq^2), D = |d| + r and w = 1 / sqrt(2 r D): c = D w, s = sign(d)
// 2 g_pq w and t = sign(d) 2 g_pq (2 r w^2) (1 / D = 2 r w^2): two square
// roots and one division in a row, with no branch, so the warp does not
// diverge.
__device__ __forceinline__ Rotation rotation(double a, double b, double g) {
  const bool on = mul(g, g) > mul(kOrthTol * kOrthTol, fabs(mul(a, b)));
  const double d = sub(b, a);
  const double g2 = d >= 0.0 ? mul(2.0, g) : mul(-2.0, g);
  const double r = sqrt(add(mul(d, d), mul(g2, g2)));
  const double den = add(fabs(d), r);
  const double r2 = mul(2.0, r);
  const double w = 1.0 / sqrt(mul(r2, den));
  const double c = mul(den, w), s = mul(g2, w);
  const double t = mul(g2, mul(r2, mul(w, w)));
  return on ? Rotation{c, s, t, true} : Rotation{1.0, 0.0, 0.0, false};
}

__global__ void __launch_bounds__(kThreads)
ba_projector_kernel(const float* __restrict__ Nn, float* __restrict__ out,
                    int* __restrict__ work_out, int n, int k,
                    float delta) {
  __shared__ double A[kCols][kMaxRows];   // Nn, column c, row r
  __shared__ __align__(16) double U[kCols][kMaxRows];  // U', kept columns
  __shared__ double G[kCols][kCols];
  __shared__ double V[kCols][kCols];
  __shared__ double lam[kCols];
  __shared__ double scale[kCols];         // of the j-th kept column
  __shared__ int kept[kCols];             // the j-th kept column
  __shared__ int r_kept;
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* src = Nn + static_cast<size_t>(s) * n * k;

  // 1. Nn once, as float64
  for (int i = tid; i < k * n; i += kThreads) {
    const int r = i / k, c = i - r * k;
    A[c][r] = static_cast<double>(src[i]);
  }
  if (tid < kCols * kCols) G[tid / kCols][tid % kCols] = 0.0;
  __syncthreads();

  // 2. the Gram matrix: every 8 lanes sum one entry of the upper triangle
  // (numbered row by row), lane l its rows l, l + 8, ... in order, then
  // the xor tree over the 8; a warp's 4 groups take 4 consecutive entries
  {
    const int n_entries = k * (k + 1) / 2;
    const int l8 = tid & (kGroup - 1);
    for (int e0 = warp * 4; e0 < n_entries; e0 += kThreads / kGroup) {
      int e = e0 + ((tid >> 3) & 3), i = 0;
      const bool live = e < n_entries;
      while (i < k && e >= k - i) {
        e -= k - i;
        ++i;
      }
      const int j = i + e;
      double acc = 0.0;
      if (live) {
#pragma unroll 4
        for (int r = l8; r < n; r += kGroup) {
          acc = add(acc, mul(A[i][r], A[j][r]));
        }
      }
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) {
        acc = add(acc, __shfl_xor_sync(kFull, acc, off));
      }
      if (live && l8 == 0) {
        G[i][j] = acc;
        G[j][i] = acc;
      }
    }
  }
  __syncthreads();

  // 3. the eigenproblem in warp 0; the other warps wait at the barrier
  if (warp == 0) {
    const int x = lane >> 2;              // row seat
    const int cp = lane & 3;              // column pair: seats 2cp, 2cp + 1
    const int rp = x >> 1;                // the row seat's pair
    double g[2], v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int y = player(2 * cp + e, 0);
      g[e] = G[player(x, 0)][y];
      v[e] = x == y ? 1.0 : 0.0;          // V's rows are Nn's columns
    }
    // where the moved seats come from, and where the diagonal lies
    const int tx = next_seat(x);
    int src_g[2], src_v[2], slot[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ty = next_seat(2 * cp + e);
      src_g[e] = 4 * tx + (ty >> 1);
      src_v[e] = 4 * x + (ty >> 1);
      slot[e] = ty & 1;
    }
    const int diag_lane = 4 * x + (x >> 1);
    int sweeps = kMaxSweeps, rotations = 0;
    for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
      // the sweep would rotate nothing: stop
      const double d0 = shfl(g[0], diag_lane), d1 = shfl(g[1], diag_lane);
      const double dx = x & 1 ? d1 : d0;
      const double dy0 = shfl(g[0], 9 * cp), dy1 = shfl(g[1], 9 * cp + 4);
      const double tol2 = kOrthTol * kOrthTol;
      const bool ok0 = x == 2 * cp ||
          mul(g[0], g[0]) <= mul(tol2, fabs(mul(dx, dy0)));
      const bool ok1 = x == 2 * cp + 1 ||
          mul(g[1], g[1]) <= mul(tol2, fabs(mul(dx, dy1)));
      if (__all_sync(kFull, ok0 && ok1)) {
        sweeps = sweep + 1;
        break;
      }
      for (int round = 0; round < kCols - 1; ++round) {
        // pair cp's g_pp, g_qq, g_pq sit at lanes 9cp (slots 0, 1) and
        // 9cp + 4 (slot 1); lane rp computed the row pair's rotation
        const double a = shfl(g[0], 9 * cp), b = shfl(g[1], 9 * cp + 4);
        const double gpq = shfl(g[1], 9 * cp);
        const Rotation rc = rotation(a, b, gpq);
        const double cr = shfl(rc.c, rp), sr = shfl(rc.s, rp);
        rotations += __popc(__ballot_sync(kFull, rc.on && lane < 4));
        // seat z's coefficients: alpha on itself, beta on its partner
        const double ax = cr, bx = x & 1 ? sr : -sr;
        const double ay = rc.c, by[2] = {-rc.s, rc.s};
        double h[2];                      // the partner row x ^ 1
#pragma unroll
        for (int e = 0; e < 2; ++e) h[e] = __shfl_xor_sync(kFull, g[e], 4);
        double gn[2], vn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const double t1 = mul(mul(ax, ay), g[e]);
          const double t4 = mul(mul(bx, by[e]), h[e ^ 1]);
          const double t2 = mul(mul(ax, by[e]), g[e ^ 1]);
          const double t3 = mul(mul(bx, ay), h[e]);
          gn[e] = add(add(t1, t4), add(t2, t3));
          vn[e] = add(mul(ay, v[e]), mul(by[e], v[e ^ 1]));
        }
        if (rc.on && rp == cp) {          // the rotated pair's own block
          const bool first = (x & 1) == 0;
          gn[0] = first ? sub(a, mul(rc.t, gpq)) : 0.0;
          gn[1] = first ? 0.0 : add(b, mul(rc.t, gpq));
        }
        // move the seats for the next round
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const double g0 = shfl(gn[0], src_g[e]), g1 = shfl(gn[1], src_g[e]);
          const double v0 = shfl(vn[0], src_v[e]), v1 = shfl(vn[1], src_v[e]);
          g[e] = slot[e] ? g1 : g0;
          v[e] = slot[e] ? v1 : v0;
        }
      }
    }
    // after whole sweeps every seat holds its round-0 player again
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int y = player(2 * cp + e, 0);
      V[x][y] = v[e];
      if (x == 2 * cp + e) lam[y] = g[e];
    }
    if (lane == 0 && work_out != nullptr) {
      work_out[2 * s] = sweeps;
      work_out[2 * s + 1] = rotations;
    }
    __syncwarp();
    // 4a. the gate lambda > delta^2 max(lambda): lane c < 8 for column c
    double lmax = lam[0];
#pragma unroll
    for (int c = 1; c < kCols; ++c) lmax = fmax(lmax, lam[c]);
    const double d = static_cast<double>(delta);
    const double gate = mul(mul(d, d), lmax);
    const int c = lane & (kCols - 1);
    const bool keep = lane < kCols && lam[c] > gate && lam[c] > 0.0;
    const unsigned mask = __ballot_sync(kFull, keep);
    if (keep) {
      const int j = __popc(mask & ((1u << c) - 1u));
      kept[j] = c;
      scale[j] = 1.0 / sqrt(lam[c]);
    }
    if (lane == 0) r_kept = __popc(mask);
  }
  __syncthreads();

  // 4b. U' = Nn V_r lambda_r^(-1/2): one (row, kept column) per thread
  const int nk = r_kept;
  for (int it = tid; it < n * nk; it += kThreads) {
    const int j = it / n, r = it - j * n;
    const int c = kept[j];
    double acc = 0.0;
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      if (m < k) acc = add(acc, mul(A[m][r], V[m][c]));
    }
    U[j][r] = mul(acc, scale[j]);
  }
  __syncthreads();

  // 5. P: each thread one 4x4 tile of the upper triangle, written with its
  // mirror in 16-byte rows, where n allows; else one entry per thread
  float* dst = out + static_cast<size_t>(s) * n * n;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const int nt = n >> 2;
    for (int it = tid; it < nt * (nt + 1) / 2; it += kThreads) {
      int ti = 0, tj = it;                // tile (ti, tj), ti <= tj
      while (tj >= nt - ti) {
        tj -= nt - ti;
        ++ti;
      }
      tj += ti;
      double p[4][4] = {};
      for (int c = 0; c < nk; ++c) {
        double ui[4], uj[4];             // two 16-byte loads each
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const double2 a =
              *reinterpret_cast<const double2*>(&U[c][4 * ti + e]);
          const double2 b =
              *reinterpret_cast<const double2*>(&U[c][4 * tj + e]);
          ui[e] = a.x;
          ui[e + 1] = a.y;
          uj[e] = b.x;
          uj[e + 1] = b.y;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            p[a][b] = add(p[a][b], mul(ui[a], uj[b]));
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float4* row = reinterpret_cast<float4*>(
            dst + static_cast<size_t>(4 * ti + a) * n + 4 * tj);
        *row = make_float4(p[a][0], p[a][1], p[a][2], p[a][3]);
        if (ti != tj) {                   // the mirror tile's row a
          float4* col = reinterpret_cast<float4*>(
              dst + static_cast<size_t>(4 * tj + a) * n + 4 * ti);
          *col = make_float4(p[0][a], p[1][a], p[2][a], p[3][a]);
        }
      }
    }
  } else {
    for (int it = tid; it < n * n; it += kThreads) {
      const int i = it / n, j = it - i * n;
      double p = 0.0;
      for (int c = 0; c < nk; ++c) p = add(p, mul(U[c][i], U[c][j]));
      dst[it] = static_cast<float>(p);
    }
  }
}

}  // namespace

extern "C" {

// Nn (S, n, k) float32 row-major, out (S, n, n) float32, work (S, 2) int32
// or null (the Jacobi sweeps each window took, the last one rotating
// nothing, and the rotations it made: the work its data needed). k <= 8,
// 1 <= n <= 256. Launches one block per window on `stream` and returns the
// launch error (cudaError_t, 0 on success).
int ldso_ba_projector(const float* Nn, float* out, int* work, int S, int n,
                      int k, float delta, void* stream) {
  if (Nn == nullptr || out == nullptr || S < 1 || S > 65535 || n < 1 ||
      n > kMaxRows || k < 1 || k > kCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ba_projector_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Nn, out, work, n, k, delta);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
