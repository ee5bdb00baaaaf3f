// K12: the nullspace projector of the windowed BA's orthogonalization,
// hand-written for Hopper (sm_90a). One launch per BA call (per S windows
// under vmap), from ldso_tpu_torch/backend/ba_device.nullspace_projector.
//
// Replaces the SVD in the JAX package's `_orthogonalize_dev`
// (ldso_tpu/backend/ba_device.py:85-93), which XLA runs inside the BA's one
// device program, and the port's plain version
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
// Algorithm: one-sided (Hestenes) Jacobi on the columns, in float64: pairs
// of columns are rotated until every pair is orthogonal to 1e-15 of their
// norms; the columns are then U S, so S is their norms and U_r the kept
// columns over their norms. The columns are padded to 8 with zeros, and
// each sweep is 7 rounds of 4 disjoint pairs (a round-robin tournament),
// one warp per pair; a sweep that rotates nothing ends the loop (at most
// kMaxSweeps). P[i][j] sums the kept columns' u[i] u[j] in column order, so
// it is symmetric bit for bit (what the plain version's 0.5 (P + P^T)
// makes of its own).
//
// What bounds it on this card: neither bytes nor operations. A window is
// n k floats in and n^2 out (16 KB at n = 60) and some 10^5 float64
// operations: nanoseconds of the card's rates. The time is the launch and
// the serial chain of a few sweeps of dependent warp reductions, which is
// why one block per window works on all of it in shared memory, with no
// second pass and no scratch. The rotation order is fixed, so every
// launch gives the same bits.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;          // columns, padded
constexpr int kMaxRows = 256;
constexpr int kMaxSweeps = 30;
constexpr double kOrthTol = 1e-15;

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
ba_projector_kernel(const float* __restrict__ Nn, float* __restrict__ out,
                    int* __restrict__ work_out, int n, int k,
                    float delta) {
  __shared__ double A[kCols][kMaxRows];   // column c, row r
  __shared__ double norm[kCols];
  __shared__ int rotated;
  __shared__ int rotations;
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* src = Nn + static_cast<size_t>(s) * n * k;

  for (int i = tid; i < kCols * n; i += kThreads) {
    const int c = i / n, r = i % n;
    A[c][r] = c < k ? static_cast<double>(src[r * k + c]) : 0.0;
  }
  __syncthreads();

  if (tid == 0) rotations = 0;
  int sweeps = 0;
  for (; sweeps < kMaxSweeps; ++sweeps) {
    if (tid == 0) rotated = 0;
    __syncthreads();
    for (int round = 0; round < kCols - 1; ++round) {
      if (warp < kCols / 2) {
        // the round-robin pairing: player 0 fixed, the others rotate
        const int a = warp == 0 ? 0 : 1 + (warp - 1 + round) % (kCols - 1);
        const int b = 1 + (kCols - 2 - warp + round) % (kCols - 1);
        double alpha = 0.0, beta = 0.0, gamma = 0.0;
        for (int r = lane; r < n; r += 32) {
          const double x = A[a][r], y = A[b][r];
          alpha += x * x;
          beta += y * y;
          gamma += x * y;
        }
        alpha = warp_sum(alpha);
        beta = warp_sum(beta);
        gamma = warp_sum(gamma);
        if (gamma != 0.0 && fabs(gamma) > kOrthTol * sqrt(alpha * beta)) {
          const double zeta = (beta - alpha) / (2.0 * gamma);
          const double t = (zeta >= 0.0 ? 1.0 : -1.0) /
                           (fabs(zeta) + sqrt(1.0 + zeta * zeta));
          const double c = 1.0 / sqrt(1.0 + t * t);
          const double sn = c * t;
          for (int r = lane; r < n; r += 32) {
            const double x = A[a][r], y = A[b][r];
            A[a][r] = c * x - sn * y;
            A[b][r] = sn * x + c * y;
          }
          if (lane == 0) {
            rotated = 1;
            atomicAdd(&rotations, 1);
          }
        }
      }
      __syncthreads();
    }
    if (!rotated) break;
    __syncthreads();     // everyone has read `rotated` before it resets
  }

  // the singular values are the columns' norms
  if (warp < kCols) {
    double x = 0.0;
    for (int r = lane; r < n; r += 32) x += A[warp][r] * A[warp][r];
    x = warp_sum(x);
    if (lane == 0) norm[warp] = sqrt(x);
  }
  __syncthreads();
  double smax = 0.0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) smax = fmax(smax, norm[c]);
  const double gate = static_cast<double>(delta) * smax;
  double inv[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    inv[c] = norm[c] > gate && norm[c] > 0.0 ? 1.0 / norm[c] : 0.0;
  }
  float* dst = out + static_cast<size_t>(s) * n * n;
  for (int i = tid; i < n * n; i += kThreads) {
    const int r = i / n, q = i % n;
    double x = 0.0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      x += (A[c][r] * inv[c]) * (A[c][q] * inv[c]);
    }
    dst[i] = static_cast<float>(x);
  }
  if (tid == 0 && work_out != nullptr) {
    work_out[2 * s] = sweeps < kMaxSweeps ? sweeps + 1 : kMaxSweeps;
    work_out[2 * s + 1] = rotations;
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
