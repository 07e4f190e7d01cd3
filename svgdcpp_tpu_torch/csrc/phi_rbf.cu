// RBF phi with one full, fixed precision matrix, for Hopper (sm_90a): the
// square sweep, no counts.
//
//   k(x_i, x_j) = exp(-d^T P d),  d = x_i - x_j,
//   phi_i = (1/n) sum_j [k_ij s_j + k_ij (P + P^T)(x_i - x_j)],
//
// for a P fixed over the step: a CONSTANT scale, a HESSIAN scale (which may
// be indefinite) or a median's gamma I.
//
// Replaces svgdcpp_tpu/ops/pallas_phi.py:_phi_kernel (K15, called through
// _phi_rbf_pallas_impl; the opt-in phi_impl='pallas' route, 'cuda' here).
//
// The quadratic form. _phi_kernel builds it with the Gram identity
// q_i + q_j - x_i P_sym x_j. P may be indefinite, so Cholesky does not
// apply: the wrapper (ops/cuda_phi.py) decomposes P_sym/2 = V diag(lam) V^T
// and passes z = X_c V and lam, so d^T P d = sum_k lam_k (z_ik - z_jk)^2:
// the difference form, exact 0 at the self pair, no cancellation. psd != 0
// clamps it at 0, as _phi_kernel does. Since x_i - x_j = (z_i - z_j) V^T,
// the gradient direction is
// sum_j k (x_i - x_j) P_sym = 2 (sum_j k (z_i - z_j)) diag(lam) V^T:
// the kernel accumulates KS and D_z = sum_j k (z_i - z_j), and the wrapper
// applies 2 diag(lam) V^T.
//
// Work per ordered pair, as this design runs it: 4m FP32 ops for the form
// (a subtraction, a multiplication and an FMA per coordinate), a clamp and
// one ex2 on the special function unit, 2m for KS and 3m for D_z (an FMA
// counted as 2, the difference taken again; the function needs it once,
// and chip_smoke.py's sweep_bound counts it so). The operands are a few
// hundred KB, so the sweep is compute-bound.
//
// Design: fused_phi_counts_square's (fused_phi.cu): one thread owns one
// target row and keeps z_i, KS and D_z (3m values) in registers; a block of
// kSqThreads targets walks sources in shared-memory tiles (SqTile rows),
// with lam log2(e) broadcast from shared memory. One block per 128 targets
// alone would leave most of the card idle (80 blocks for 132 SMs at
// n = 10240), so the sources are split into chunks of whole tiles over the
// grid's second dimension, about kTargetBlocks blocks in all; each block
// adds its partial sums into a zeroed (2m, n) buffer [KS | D_z] with float32
// atomics (neighbouring threads, neighbouring particles). The entry point
// returns cudaGetLastError() after the launch.

#include "sweep_common.cuh"

namespace {

using namespace svgd;

// Blocks a launch aims at: a few waves of 132 SMs.
constexpr int kTargetBlocks = 1024;

template <int MM, bool kExact>
__global__ void __launch_bounds__(kSqThreads)
    phi_rbf_square_kernel(const float* __restrict__ z,
                          const float* __restrict__ scores,
                          const float* __restrict__ lam, int n, int m_arg,
                          int psd, int chunk, float* __restrict__ out) {
  constexpr int kTile = SqTile<MM>::value;
  __shared__ float sh_z[kTile * MM];
  __shared__ float sh_s[kTile * MM];
  __shared__ float sh_lam[MM];

  const int m = kExact ? MM : m_arg;
  const int i = blockIdx.x * kSqThreads + threadIdx.x;
  const bool row_ok = i < n;
  for (int k = threadIdx.x; k < m; k += kSqThreads) sh_lam[k] = lam[k] * kLog2e;

  float zi[MM];
  float acc_s[MM];
  float acc_d[MM];
#pragma unroll
  for (int k = 0; k < MM; ++k) {
    zi[k] = (row_ok && (kExact || k < m)) ? z[static_cast<size_t>(i) * m + k]
                                          : 0.0f;
    acc_s[k] = 0.0f;
    acc_d[k] = 0.0f;
  }

  const int j_begin = static_cast<int>(blockIdx.y) * chunk;
  const int j_end = min(n, j_begin + chunk);
  for (int j0 = j_begin; j0 < j_end; j0 += kTile) {
    const int tile_n = min(kTile, j_end - j0);
    __syncthreads();  // the previous tile is consumed (and lam loaded)
    for (int e = threadIdx.x; e < tile_n * m; e += kSqThreads) {
      sh_z[e] = z[static_cast<size_t>(j0) * m + e];
      sh_s[e] = scores[static_cast<size_t>(j0) * m + e];
    }
    __syncthreads();
    if (row_ok) {
      for (int jj = 0; jj < tile_n; ++jj) {
        const float* zj = sh_z + jj * m;
        const float* sj = sh_s + jj * m;
        float q = 0.0f;  // log2(e) d^T P d
#pragma unroll
        for (int k = 0; k < MM; ++k) {
          if (kExact || k < m) {
            const float d = __fsub_rn(zi[k], zj[k]);
            q = fmaf(sh_lam[k] * d, d, q);
          }
        }
        if (psd) q = fmaxf(q, 0.0f);
        const float kv = exp2f(-q);
#pragma unroll
        for (int k = 0; k < MM; ++k) {
          if (kExact || k < m) {
            acc_s[k] = fmaf(kv, sj[k], acc_s[k]);
            acc_d[k] = fmaf(kv, __fsub_rn(zi[k], zj[k]), acc_d[k]);
          }
        }
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      if (kExact || k < m) {
        atomicAdd(out + static_cast<size_t>(k) * n + i, acc_s[k]);
        atomicAdd(out + static_cast<size_t>(m + k) * n + i, acc_d[k]);
      }
    }
  }
}

}  // namespace

extern "C" {

// [KS | D_z] (2m, n) of the fixed-P square sweep. z (n, m) the rows
// z = X_c V, scores (n, m), lam (m,) the eigenvalues of P_sym/2, all float32
// row-major on the device; psd != 0 clamps the form at 0; out a zeroed
// (2m, n) float32 buffer. 1 <= m <= 64.
int svgd_phi_rbf_square(const float* z, const float* scores, const float* lam,
                        int n, int m, int psd, float* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int row_blocks = (n + kSqThreads - 1) / kSqThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVGD_LAUNCH_PHI_RBF(MM_, EX_)                                   \
  {                                                                     \
    constexpr int tile = SqTile<MM_>::value;                            \
    const int tiles = (n + tile - 1) / tile;                            \
    const int want = (kTargetBlocks + row_blocks - 1) / row_blocks;     \
    const int splits = tiles < want ? tiles : want;                     \
    const int chunk = tile * ((tiles + splits - 1) / splits);           \
    const dim3 grid(row_blocks, (n + chunk - 1) / chunk);               \
    phi_rbf_square_kernel<MM_, EX_><<<grid, kSqThreads, 0, s>>>(        \
        z, scores, lam, n, m, psd, chunk, out);                         \
  }
  SVGD_DISPATCH_M_2_11(m, SVGD_LAUNCH_PHI_RBF)
#undef SVGD_LAUNCH_PHI_RBF
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
