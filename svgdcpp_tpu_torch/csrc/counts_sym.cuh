// The single-RBF upper-triangle sweep's one-row-a-thread body, for the
// widths whose rows the micro-tile body (micro_tile.cuh) would spill: m = 9,
// 10 and 12-64 (the instances of 16, 32, 50 and 64). Included by
// fused_phi.cu twice: as fused_phi_counts_sym_kernel (K2's port, the whole
// triangle) and as fused_phi_counts_sym_chunk_kernel (K4's port, one rank's
// range of the tile list), beside the micro-tile instances of the same
// names. Each include names the kernel by defining SVGD_COUNTS_SYM_KERNEL
// first; the header undefines it, so a profiler trace tells the two apart
// and neither carries a flag for the other.
//
// One block per upper-triangle tile pair (bi <= bj) of kTile x kTile
// particles: tile t0 + blockIdx.x of the linear tile list (t0 = 0 for the
// whole triangle). On the diagonal tile only pairs j >= i are entered.
// Thread r owns row i = bi*kTile + r: it computes k_ij for the tile's
// columns, accumulates the row direction in registers, and stores k_ij to a
// padded shared tile (stride kTile+1: conflict-free by rows and by columns).
// Then thread r owns column j = bj*kTile + r and accumulates the column
// direction from that tile (pair (i, j) adds k s_i and k (x_j - x_i) to
// particle j). Both directions are flushed with float32 atomicAdd into a
// zeroed (2m, n) accumulator [KS | D] (coalesced: neighbouring threads,
// neighbouring particles). The diagonal pairs enter both directions: their D
// term is 0, and the wrapper's epilogue subtracts s_i once from KS
// (k_ii = 1 exactly). The count buffer receives U, the upper count including
// the diagonal; the wrapper forms 2U - n once, after any sum over ranks.
// Float atomics make phi's summation order vary from run to run; the counts
// are integers and do not. Tiles: SymRowTile (sweep_common.cuh).

#include "sweep_common.cuh"

#ifndef SVGD_COUNTS_SYM_KERNEL
#error "define SVGD_COUNTS_SYM_KERNEL, the kernel's name, before the include"
#endif

// Internal linkage: each source that includes this header compiles its own
// instances.
namespace {

using namespace svgd;

template <int MM, bool kExact>
__global__ void __launch_bounds__(SymRowTile<MM>::value)
    SVGD_COUNTS_SYM_KERNEL(const float* __restrict__ coords,
                           const float* __restrict__ scores,
                           const float* __restrict__ gamma,
                           const float* __restrict__ thr, int n, int m_arg,
                           int T, int nb, long long t0,
                           float* __restrict__ acc,
                           unsigned long long* __restrict__ counts) {
  constexpr int kTile = SymRowTile<MM>::value;
  __shared__ float sh_k[kTile][kTile + 1];
  __shared__ float sh_xi[kTile * MM];
  __shared__ float sh_si[kTile * MM];
  __shared__ float sh_xj[kTile * MM];
  __shared__ float sh_sj[kTile * MM];

  const int m = kExact ? MM : m_arg;
  int bi, bj;
  decode_upper_pair(t0 + static_cast<long long>(blockIdx.x), nb, &bi, &bj);
  const int r = threadIdx.x;
  const int i0 = bi * kTile;
  const int j0 = bj * kTile;

  for (int e = r; e < kTile * m; e += kTile) {
    const int p = e / m;
    const bool ok_i = i0 + p < n;
    const bool ok_j = j0 + p < n;
    sh_xi[e] = ok_i ? coords[static_cast<size_t>(i0) * m + e] : 0.0f;
    sh_si[e] = ok_i ? scores[static_cast<size_t>(i0) * m + e] : 0.0f;
    sh_xj[e] = ok_j ? coords[static_cast<size_t>(j0) * m + e] : 0.0f;
    sh_sj[e] = ok_j ? scores[static_cast<size_t>(j0) * m + e] : 0.0f;
  }
  __syncthreads();

  const float g2 = gamma[0] * kLog2e;
  float th[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) th[t] = (t < T) ? thr[t] : 0.0f;

  // Row direction: thread r owns particle i.
  const int i = i0 + r;
  const bool row_ok = i < n;
  float xi[MM];
  float acc_s[MM];
  float acc_d[MM];
#pragma unroll
  for (int k = 0; k < MM; ++k) {
    xi[k] = (kExact || k < m) ? sh_xi[r * m + k] : 0.0f;
    acc_s[k] = 0.0f;
    acc_d[k] = 0.0f;
  }
  unsigned int cnt[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) cnt[t] = 0u;

  for (int jj = 0; jj < kTile; ++jj) {
    const int j = j0 + jj;
    float kv = 0.0f;
    if (row_ok && j < n && j >= i) {
      const float* xj = sh_xj + jj * m;
      const float* sj = sh_sj + jj * m;
      const float sq = pair_sq<MM, kExact>(xi, xj, m);
      kv = exp2f(-g2 * sq);
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        if (kExact || k < m) {
          acc_s[k] = fmaf(kv, sj[k], acc_s[k]);
          acc_d[k] = fmaf(kv, __fsub_rn(xi[k], xj[k]), acc_d[k]);
        }
      }
      count_pair(sq, th, T, cnt);
    }
    sh_k[r][jj] = kv;
  }
  if (row_ok) {
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      if (kExact || k < m) {
        atomicAdd(acc + static_cast<size_t>(k) * n + i, acc_s[k]);
        atomicAdd(acc + static_cast<size_t>(m + k) * n + i, acc_d[k]);
      }
    }
  }
  flush_counts(cnt, T, counts);
  __syncthreads();  // the k tile is complete

  // Column direction: thread r owns particle j. Masked pairs hold k = 0.
  const int j = j0 + r;
  if (j < n) {
    float xj[MM];
    float col_s[MM];
    float col_d[MM];
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      xj[k] = (kExact || k < m) ? sh_xj[r * m + k] : 0.0f;
      col_s[k] = 0.0f;
      col_d[k] = 0.0f;
    }
    for (int ii = 0; ii < kTile; ++ii) {
      const float kv = sh_k[ii][r];
      const float* x_i = sh_xi + ii * m;
      const float* s_i = sh_si + ii * m;
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        if (kExact || k < m) {
          col_s[k] = fmaf(kv, s_i[k], col_s[k]);
          col_d[k] = fmaf(kv, xj[k] - x_i[k], col_d[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      if (kExact || k < m) {
        atomicAdd(acc + static_cast<size_t>(k) * n + j, col_s[k]);
        atomicAdd(acc + static_cast<size_t>(m + k) * n + j, col_d[k]);
      }
    }
  }
}

}  // namespace

#undef SVGD_COUNTS_SYM_KERNEL
