// Panel triangle sweeps for Hopper (sm_90a): the fused phi + median-count
// sweep over one particle set, laid out as pairs of super-blocks.
//
// Replaces three Pallas kernels of svgdcpp_tpu/ops/pallas_phi.py, the
// triangle sweeps the JAX package runs past its VMEM accumulator budget:
//
//   * fused_phi_counts_sympanel replaces _sym_panel_kernel (K3, called
//     through _phi_rbf_fused_pallas_sympanel_impl): one isotropic RBF,
//     KS = sum k s_j and D = sum k (x_i - x_j);
//   * fused_phi_terms_sympanel replaces _sym_panel_terms_direct_kernel
//     (K12, through _phi_rbf_terms_fused_pallas_sympanel_direct_impl) and
//     _sym_panel_terms_kernel (K13, through
//     _phi_rbf_terms_fused_pallas_sympanel_impl): a signed sum of isotropic
//     RBF terms, k_c = sum s_t k_t for KS and w = sum s_t gamma_t k_t for D
//     (fused_phi_terms.cu). The TPU's split of K12 and K13 into one or two
//     rotating windows is a VMEM compile-envelope choice with no
//     counterpart here, so one kernel stands for both;
//   * fused_phi_counts_sympanel_chunk replaces _sym_panel_kernel as
//     phi_rbf_fused_pallas_sympanel_sharded calls it (K5): one device's
//     chunk of the GLOBAL panel list, here a contiguous range
//     [p0, p0 + count) of it (ops/sym_plan.panel_chunk) with one window
//     each; the caller scatters the windows, sums the accumulators over the
//     ranks and runs one epilogue.
//
// Layout. The particles are cut into nb super-blocks of W (a multiple of
// 64; ops/sym_plan.card_panel_plan chooses them for the card, not for the
// TPU's VMEM). Panel p is the super-block pair (I, J), I <= J, in the order
// of sym_plan.panel_pairs: the off-diagonal pairs row by row, then the
// diagonal ones, decoded here from p0 + blockIdx.y (p0 = 0 for the whole
// list). Each panel of the launch has its own output window, blockIdx.y, in
// the zeroed buffer `panels` (P, 2, 2m, W): half 0 holds
// [KS | D] of the rows of I over the columns of J, half 1 [KS | D] of the
// columns of J over the rows of I (pair (i, j) adds k s_i and
// k (x_j - x_i), or w (x_j - x_i), to j). The wrapper's epilogue
// (ops/phi.sympanel_epilogue) scatter-adds the halves onto the full
// accumulator, subtracts the self pairs' second entry into KS and forms
// 2U - n from the upper count U, as for the full-width triangle kernels.
//
// Design. One block of kTile threads owns a strip of kTile rows of I
// (blockIdx.x) and sweeps ALL columns of J in chunks of kTile: thread r
// keeps its row's 2m sums and T counts in registers across the whole strip
// and stores them once, with a plain store, at the end (the block is the
// only writer of those rows of the panel), where fused_phi_counts_sym
// flushes them with float32 atomicAdd after every 64 columns. The row tiles
// are loaded once per strip. Per chunk, the pair values go to a padded
// shared tile and thread r then owns column j of the chunk and flushes its
// 2m column sums with float32 atomicAdd into half 1: every strip of the
// panel adds into the same columns. So the column direction uses atomics
// and the row direction does not; phi's summation order, and so its last
// bits, vary from run to run through the column direction; the counts are
// integers and do not. On a diagonal panel a strip starts at its own chunk
// (the chunks before it hold no pair j >= i) and masks j < i on it; the
// self pairs enter both halves. Rows and columns past n are bounds checks.
//
// Bound on this card: the same per-pair work as fused_phi_counts_sym
// (3m+1 FP32 ops for sq, one ex2 per term on the special function unit, T
// compares, 4m FMAs for the two directions), once per unordered pair; the
// operands and the window are a few hundred MB at most, so the sweep is
// bound by the FP32 pipes and the SFU, not by memory. What this layout
// removes against fused_phi_counts_sym is per-tile overhead: the row
// direction's atomics, a block launch, the tile-pair decode and the row
// tiles' loads per 64 x 64 tile.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <limits.h>

#include "sweep_common.cuh"

namespace {

using namespace svgd;

// Strip height and chunk width: 64 up to m = 16 (one term) or m = 12
// (terms, which keep two pair tiles), 32 above, so the shared tiles stay
// within 48 KB of static shared memory. Both divide the 64 that W is a
// multiple of.
template <int MM>
struct CountsPanelTile {
  static constexpr int value = MM <= 16 ? 64 : 32;
};

template <int MM, bool kTerms>
struct PanelTile {
  static constexpr int value =
      kTerms ? SymTermsTile<MM>::value : CountsPanelTile<MM>::value;
};

constexpr int kPanelAlign = 64;  // sym_plan.CARD_PANEL_ALIGN

template <int MM, bool kExact, bool kTerms>
__device__ __forceinline__ void sympanel_body(
    const float* __restrict__ coords, const float* __restrict__ scores,
    const float* __restrict__ gammas, const TermSigns& signs, int nterms,
    const float* __restrict__ thr, int n, int m_arg, int T, int nb, int w,
    int p0, float* __restrict__ panels,
    unsigned long long* __restrict__ counts) {
  constexpr int kTile = PanelTile<MM, kTerms>::value;
  __shared__ float sh_kc[kTile][kTile + 1];
  __shared__ float sh_w[kTerms ? kTile : 1][kTile + 1];
  __shared__ float sh_xi[kTile * MM];
  __shared__ float sh_si[kTile * MM];
  __shared__ float sh_xj[kTile * MM];
  __shared__ float sh_sj[kTile * MM];
  __shared__ float sh_g2[kMaxTerms];
  __shared__ float sh_sn[kMaxTerms];
  __shared__ float sh_sg[kMaxTerms];

  const int m = kExact ? MM : m_arg;
  // The panel's super-blocks (I, J): off-diagonal pairs first, in the
  // order of the upper triangle of nb - 1 blocks shifted one column right.
  const int n_off = nb * (nb - 1) / 2;
  const int p = static_cast<int>(blockIdx.y);  // the window
  const int pg = p0 + p;                        // the panel in the list
  int bi, bj;
  if (pg < n_off) {
    decode_upper_pair(pg, nb - 1, &bi, &bj);
    ++bj;
  } else {
    bi = bj = pg - n_off;
  }
  const bool diag = bi == bj;
  const int r = threadIdx.x;
  const int li0 = static_cast<int>(blockIdx.x) * kTile;  // strip, local
  const int gi0 = bi * w + li0;
  const int gj_base = bj * w;
  const int ncols = min(w, n - gj_base);
  // Block-uniform: a strip or a super-block wholly past n has no pair.
  if (gi0 >= n || ncols <= 0) return;

  if (kTerms) {
    load_terms(gammas, signs, nterms, sh_g2, sh_sn, sh_sg);
  }
  const float g2 = kTerms ? 0.0f : gammas[0] * kLog2e;
  for (int e = r; e < kTile * m; e += kTile) {
    const bool ok = gi0 + e / m < n;
    sh_xi[e] = ok ? coords[static_cast<size_t>(gi0) * m + e] : 0.0f;
    sh_si[e] = ok ? scores[static_cast<size_t>(gi0) * m + e] : 0.0f;
  }
  __syncthreads();

  float th[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) th[t] = (t < T) ? thr[t] : 0.0f;

  // Row direction: thread r owns particle i for the whole strip.
  const int i = gi0 + r;
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

  const size_t plane = static_cast<size_t>(w);
  float* half0 = panels + (static_cast<size_t>(p) * 2) * 2 * m * plane;
  float* half1 = half0 + 2 * m * plane;
  const int n_chunks = (ncols + kTile - 1) / kTile;
  for (int c = diag ? static_cast<int>(blockIdx.x) : 0; c < n_chunks; ++c) {
    const int lj0 = c * kTile;
    const int gj0 = gj_base + lj0;
    __syncthreads();  // the previous chunk's tiles are consumed
    for (int e = r; e < kTile * m; e += kTile) {
      const bool ok = gj0 + e / m < n;
      sh_xj[e] = ok ? coords[static_cast<size_t>(gj0) * m + e] : 0.0f;
      sh_sj[e] = ok ? scores[static_cast<size_t>(gj0) * m + e] : 0.0f;
    }
    __syncthreads();

    // Pairs (i, j) of the chunk; on the diagonal chunk only j >= i.
    const int jj_min = (diag && c == static_cast<int>(blockIdx.x)) ? r : 0;
    for (int jj = 0; jj < kTile; ++jj) {
      float kc = 0.0f;
      float wv = 0.0f;
      if (row_ok && gj0 + jj < n && jj >= jj_min) {
        const float* xj = sh_xj + jj * m;
        const float* sj = sh_sj + jj * m;
        const float sq = pair_sq<MM, kExact>(xi, xj, m);
        if (kTerms) {
          combine_terms(sq, nterms, sh_g2, sh_sn, sh_sg, &kc, &wv);
        } else {
          kc = exp2f(-g2 * sq);
          wv = kc;
        }
#pragma unroll
        for (int k = 0; k < MM; ++k) {
          if (kExact || k < m) {
            acc_s[k] = fmaf(kc, sj[k], acc_s[k]);
            acc_d[k] = fmaf(wv, __fsub_rn(xi[k], xj[k]), acc_d[k]);
          }
        }
        count_pair(sq, th, T, cnt);
      }
      sh_kc[r][jj] = kc;
      if (kTerms) sh_w[r][jj] = wv;
    }
    __syncthreads();  // the pair tile is complete

    // Column direction: thread r owns column j of the chunk. Masked pairs
    // hold 0.
    const int lj = lj0 + r;
    if (gj_base + lj < n) {
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
        const float wv = kTerms ? sh_w[ii][r] : kc;
        const float* x_i = sh_xi + ii * m;
        const float* s_i = sh_si + ii * m;
#pragma unroll
        for (int k = 0; k < MM; ++k) {
          if (kExact || k < m) {
            col_s[k] = fmaf(kc, s_i[k], col_s[k]);
            col_d[k] = fmaf(wv, xj[k] - x_i[k], col_d[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        if (kExact || k < m) {
          atomicAdd(half1 + static_cast<size_t>(k) * plane + lj, col_s[k]);
          atomicAdd(half1 + static_cast<size_t>(m + k) * plane + lj,
                    col_d[k]);
        }
      }
    }
  }

  // The strip's rows: this block is their only writer in this panel.
  if (row_ok) {
    const int li = li0 + r;
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      if (kExact || k < m) {
        half0[static_cast<size_t>(k) * plane + li] = acc_s[k];
        half0[static_cast<size_t>(m + k) * plane + li] = acc_d[k];
      }
    }
  }
  flush_counts(cnt, T, counts);
}

template <int MM, bool kExact>
__global__ void __launch_bounds__(CountsPanelTile<MM>::value)
    fused_phi_counts_sympanel_kernel(const float* __restrict__ coords,
                                     const float* __restrict__ scores,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ thr, int n,
                                     int m_arg, int T, int nb, int w,
                                     float* __restrict__ panels,
                                     unsigned long long* __restrict__ counts) {
  const TermSigns none{};
  sympanel_body<MM, kExact, false>(coords, scores, gamma, none, 1, thr, n,
                                   m_arg, T, nb, w, 0, panels, counts);
}

template <int MM, bool kExact>
__global__ void __launch_bounds__(CountsPanelTile<MM>::value)
    fused_phi_counts_sympanel_chunk_kernel(
        const float* __restrict__ coords, const float* __restrict__ scores,
        const float* __restrict__ gamma, const float* __restrict__ thr, int n,
        int m_arg, int T, int nb, int w, int p0, float* __restrict__ panels,
        unsigned long long* __restrict__ counts) {
  const TermSigns none{};
  sympanel_body<MM, kExact, false>(coords, scores, gamma, none, 1, thr, n,
                                   m_arg, T, nb, w, p0, panels, counts);
}

template <int MM, bool kExact>
__global__ void __launch_bounds__(SymTermsTile<MM>::value)
    fused_phi_terms_sympanel_kernel(const float* __restrict__ coords,
                                    const float* __restrict__ scores,
                                    const float* __restrict__ gammas,
                                    TermSigns signs, int nterms,
                                    const float* __restrict__ thr, int n,
                                    int m_arg, int T, int nb, int w,
                                    float* __restrict__ panels,
                                    unsigned long long* __restrict__ counts) {
  sympanel_body<MM, kExact, true>(coords, scores, gammas, signs, nterms, thr,
                                  n, m_arg, T, nb, w, 0, panels, counts);
}

// The plan's checks, shared by both entry points: nb super-blocks of w
// particles (w a positive multiple of 64) covering n, at most 65535 panels
// (the grid's y limit) and nb * w within an int.
bool plan_ok(int n, int nb, int w) {
  if (n <= 0 || nb < 1 || w < kPanelAlign || w % kPanelAlign) return false;
  const long long n_pad = static_cast<long long>(nb) * w;
  const long long panels = static_cast<long long>(nb) * (nb + 1) / 2;
  return n_pad >= n && n_pad <= INT_MAX && panels <= 65535;
}

}  // namespace

extern "C" {

// Panel triangle sweep of one RBF. coords (n, m) centered, scores (n, m),
// gamma (1,), thr (T,) float32 on the device; panels a zeroed float32
// (nb (nb + 1) / 2, 2, 2m, w) buffer; counts a zeroed int64 (T,) buffer
// that receives the upper count U (diagonal included). 1 <= m <= 64,
// 1 <= T <= 8.
int svgd_fused_phi_counts_sympanel(const float* coords, const float* scores,
                                   const float* gamma, const float* thr,
                                   int n, int m, int T, int nb, int w,
                                   float* panels, long long* counts,
                                   void* stream) {
  if (!plan_ok(n, nb, w) || T < 1 || T > kMaxT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const unsigned int num_p = static_cast<unsigned int>(nb) * (nb + 1) / 2;
#define SVGD_LAUNCH_SYMPANEL(MM_, EX_)                                      \
  {                                                                         \
    constexpr int tile = PanelTile<MM_, false>::value;                      \
    fused_phi_counts_sympanel_kernel<MM_, EX_>                              \
        <<<dim3(w / tile, num_p), tile, 0, s>>>(coords, scores, gamma, thr, \
                                                n, m, T, nb, w, panels, c); \
  }
  SVGD_DISPATCH_M_2_11(m, SVGD_LAUNCH_SYMPANEL)
#undef SVGD_LAUNCH_SYMPANEL
  return static_cast<int>(cudaGetLastError());
}

// One rank's chunk of the panel triangle sweep of one RBF: panels
// [p0, p0 + count) of the nb super-blocks' panel list, one window each in
// panels, a zeroed float32 (count, 2, 2m, w) buffer; the arguments otherwise
// as svgd_fused_phi_counts_sympanel's (coords and scores are the GLOBAL set,
// centered on its mean). counts receives this chunk's upper count. count = 0
// launches nothing.
int svgd_fused_phi_counts_sympanel_chunk(const float* coords,
                                         const float* scores,
                                         const float* gamma, const float* thr,
                                         int n, int m, int T, int nb, int w,
                                         int p0, int count, float* panels,
                                         long long* counts, void* stream) {
  const long long num_p = static_cast<long long>(nb) * (nb + 1) / 2;
  if (!plan_ok(n, nb, w) || T < 1 || T > kMaxT || p0 < 0 || count < 0 ||
      p0 + static_cast<long long>(count) > num_p) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (count == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_SYMPANEL_CHUNK(MM_, EX_)                                \
  {                                                                         \
    constexpr int tile = PanelTile<MM_, false>::value;                      \
    fused_phi_counts_sympanel_chunk_kernel<MM_, EX_>                        \
        <<<dim3(w / tile, static_cast<unsigned int>(count)), tile, 0, s>>>( \
            coords, scores, gamma, thr, n, m, T, nb, w, p0, panels, c);     \
  }
  SVGD_DISPATCH_M_2_11(m, SVGD_LAUNCH_SYMPANEL_CHUNK)
#undef SVGD_LAUNCH_SYMPANEL_CHUNK
  return static_cast<int>(cudaGetLastError());
}

// Panel triangle sweep of a composed kernel: as above, with gammas
// (nterms,) float32 on the device and signs (nterms,) a HOST array, passed
// by value to the kernel. 1 <= nterms <= 16.
int svgd_fused_phi_terms_sympanel(const float* coords, const float* scores,
                                  const float* gammas, const float* signs,
                                  int nterms, const float* thr, int n, int m,
                                  int T, int nb, int w, float* panels,
                                  long long* counts, void* stream) {
  if (!plan_ok(n, nb, w) || T < 1 || T > kMaxT || nterms < 1 ||
      nterms > kMaxTerms) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TermSigns sg = make_signs(signs, nterms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const unsigned int num_p = static_cast<unsigned int>(nb) * (nb + 1) / 2;
#define SVGD_LAUNCH_TERMS_SYMPANEL(MM_, EX_)                                \
  {                                                                         \
    constexpr int tile = PanelTile<MM_, true>::value;                       \
    fused_phi_terms_sympanel_kernel<MM_, EX_>                               \
        <<<dim3(w / tile, num_p), tile, 0, s>>>(coords, scores, gammas, sg, \
                                                nterms, thr, n, m, T, nb,   \
                                                w, panels, c);              \
  }
  SVGD_DISPATCH_M_2_11(m, SVGD_LAUNCH_TERMS_SYMPANEL)
#undef SVGD_LAUNCH_TERMS_SYMPANEL
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
