// The composed kernels' one-row-a-thread upper-triangle sweep, shared by
// fused_phi_terms.cu (fused_phi_terms_sym, K8/K9's port: one term group; and
// fused_phi_terms_sym_chunk, K10/K11's port: one rank's range of the tile
// list; both at the widths the micro-tile body would spill, m = 9, 10 and
// 12-64: fused_phi_terms.cu takes micro_tile.cuh's body at m = 1-8 and 11)
// and fused_phi_aniso.cu (the term-group kernel of K14's port, for
// compositions past the one-pass kernel's: one group per anisotropic term
// besides the Euclidean one).
//
// fused_phi_counts_sym's design (fused_phi.cu) with TWO padded shared
// tiles, k_c and w, in place of k: one block per upper-triangle tile pair
// (bi <= bj) from a linear block index, diagonal tile masked to j >= i.
// The block's tile is t0 + blockIdx.x of the tile list (t0 = 0 for the whole
// triangle). Thread r accumulates row i = bi*kTile + r in registers and
// stores the
// pair's (k_c, w) to the shared tiles; then thread r owns column
// j = bj*kTile + r and accumulates k_c s_i and w (x_j - x_i) from them.
// Both directions flush with float32 atomicAdd into the group's zeroed
// (2m, n) accumulator [KS_g | D_g]. Tiles: SymTermsTile (sweep_common.cuh).
//
// The term group is the grid's second dimension, uniform over a block, in
// the kGroups instances (the anisotropic sweep's); without kGroups there
// is one group and the group logic compiles away. Each source names the
// kernel by defining SVGD_TERMS_SYM_KERNEL before it includes this header
// (fused_phi_terms_sym_kernel, fused_phi_aniso_terms_groups_kernel), so a
// profiler trace tells the two apart; the body stays a __global__ function
// (as a __device__ one called from two thin entries, the one-group
// instance ran 3% slower). Group 0 sweeps the Euclidean coordinates with
// the isotropic terms' (k_c, w) and counts the pair squared distances at or
// below each threshold (with no isotropic term it only counts). Group 1 + t
// sweeps the rows z_t with one term of gamma 1 and sign s_t, so
// k_c = w = s_t k_t and its D is sum_j s_t k_t (z_ti - z_tj). Each group writes its own
// accumulator, at acc + g (2m n).
//
// The self pair (k = 1 for every term) enters KS in both directions, so the
// wrapper subtracts (sum of every sign) s_i once: the JAX epilogue's per-term
// "acc - B" (pallas_phi.py:2514-2528) summed over the terms. The counts
// receive U, the upper count with the diagonal; the wrapper forms 2U - n.
// Float atomics make phi's summation order vary from run to run; the counts
// are integers and do not.

#include "sweep_common.cuh"

#ifndef SVGD_TERMS_SYM_KERNEL
#error "define SVGD_TERMS_SYM_KERNEL, the kernel's name, before the include"
#endif

// Internal linkage: each source that includes this header compiles its own
// instances.
namespace {

using namespace svgd;

template <int MM, bool kExact, bool kGroups>
__global__ void __launch_bounds__(SymTermsTile<MM>::value)
    SVGD_TERMS_SYM_KERNEL(
        const float* __restrict__ coords, const float* __restrict__ z,
        const float* __restrict__ scores, const float* __restrict__ gammas,
        TermSigns iso_signs, int n_iso, AnisoSigns aniso_signs,
        const float* __restrict__ thr, int n, int m_arg, int T, int nb,
        long long t0, float* __restrict__ acc,
        unsigned long long* __restrict__ counts) {
  constexpr int kTile = SymTermsTile<MM>::value;
  __shared__ float sh_kc[kTile][kTile + 1];
  __shared__ float sh_w[kTile][kTile + 1];
  __shared__ float sh_xi[kTile * MM];
  __shared__ float sh_si[kTile * MM];
  __shared__ float sh_xj[kTile * MM];
  __shared__ float sh_sj[kTile * MM];
  __shared__ float sh_g2[kMaxTerms];
  __shared__ float sh_sn[kMaxTerms];
  __shared__ float sh_sg[kMaxTerms];

  const int m = kExact ? MM : m_arg;
  // The term group (uniform over the block): 0 is the Euclidean sweep of
  // the isotropic terms and the counts, 1 + t the sweep of z_t.
  const int group = kGroups ? static_cast<int>(blockIdx.y) : 0;
  const bool euclid = group == 0;
  const float* rows =
      euclid ? coords : z + static_cast<size_t>(group - 1) * n * m;
  const int nterms = euclid ? n_iso : 1;
  const bool has_phi = !kGroups || nterms > 0;  // one group: n_iso >= 1
  if (euclid) {
    load_terms(gammas, iso_signs, n_iso, sh_g2, sh_sn, sh_sg);
  } else if (threadIdx.x == 0) {
    const float s = aniso_signs.s[group - 1];
    sh_g2[0] = -kLog2e;
    sh_sn[0] = s;
    sh_sg[0] = s;
  }
  float* acc_g = acc + static_cast<size_t>(group) * 2 * m * n;

  int bi, bj;
  decode_upper_pair(t0 + static_cast<long long>(blockIdx.x), nb, &bi, &bj);
  const int r = threadIdx.x;
  const int i0 = bi * kTile;
  const int j0 = bj * kTile;

  for (int e = r; e < kTile * m; e += kTile) {
    const int p = e / m;
    const bool ok_i = i0 + p < n;
    const bool ok_j = j0 + p < n;
    sh_xi[e] = ok_i ? rows[static_cast<size_t>(i0) * m + e] : 0.0f;
    sh_si[e] = ok_i ? scores[static_cast<size_t>(i0) * m + e] : 0.0f;
    sh_xj[e] = ok_j ? rows[static_cast<size_t>(j0) * m + e] : 0.0f;
    sh_sj[e] = ok_j ? scores[static_cast<size_t>(j0) * m + e] : 0.0f;
  }
  __syncthreads();

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
    float kc = 0.0f;
    float w = 0.0f;
    if (row_ok && j < n && j >= i) {
      const float* xj = sh_xj + jj * m;
      const float sq = pair_sq<MM, kExact>(xi, xj, m);
      if (has_phi) {
        const float* sj = sh_sj + jj * m;
        combine_terms(sq, nterms, sh_g2, sh_sn, sh_sg, &kc, &w);
#pragma unroll
        for (int k = 0; k < MM; ++k) {
          if (kExact || k < m) {
            acc_s[k] = fmaf(kc, sj[k], acc_s[k]);
            acc_d[k] = fmaf(w, __fsub_rn(xi[k], xj[k]), acc_d[k]);
          }
        }
      }
      if (euclid) count_pair(sq, th, T, cnt);
    }
    sh_kc[r][jj] = kc;
    sh_w[r][jj] = w;
  }
  if (row_ok && has_phi) {
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      if (kExact || k < m) {
        atomicAdd(acc_g + static_cast<size_t>(k) * n + i, acc_s[k]);
        atomicAdd(acc_g + static_cast<size_t>(m + k) * n + i, acc_d[k]);
      }
    }
  }
  if (euclid) flush_counts(cnt, T, counts);
  if (!has_phi) return;  // uniform over the block: no barrier is skipped
  __syncthreads();       // the pair tiles are complete

  // Column direction: thread r owns particle j. Masked pairs hold 0.
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
      const float kc = sh_kc[ii][r];
      const float w = sh_w[ii][r];
      const float* x_i = sh_xi + ii * m;
      const float* s_i = sh_si + ii * m;
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        if (kExact || k < m) {
          col_s[k] = fmaf(kc, s_i[k], col_s[k]);
          col_d[k] = fmaf(w, xj[k] - x_i[k], col_d[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      if (kExact || k < m) {
        atomicAdd(acc_g + static_cast<size_t>(k) * n + j, col_s[k]);
        atomicAdd(acc_g + static_cast<size_t>(m + k) * n + j, col_d[k]);
      }
    }
  }
}

}  // namespace

#undef SVGD_TERMS_SYM_KERNEL
