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
// Bound on this card. Per unordered pair the function needs the difference
// and sq (3m FP32 operations, sq rounded term by term so that the counts
// equal the plain version's), one ex2 on the special function unit per
// term, T compares and 4m FMAs (k s and k d into both directions). The
// operands are 2nm floats and the windows a few hundred MB at most, so the
// sweep is bound by instruction issue, not by memory: at m = 2, T = 3 with
// one RBF the floor is 21 instructions a pair (5 for sq, a multiply and the
// ex2, 8 FMAs, a compare and an add per threshold); at m = 11, T = 3 with
// two terms 91 (33 for sq, 8 for the terms, 44 FMAs, 6 for the counts).
//
// The micro-tile body: one RBF up to m = 8 (micro_panel_body; K3's and
// K5's port).
// A block of 4 warps owns a strip of 128 kRows rows of I (8 rows a thread
// at m = 2) and sweeps all columns of J, 32 a chunk. Lane l of a warp holds
// its rows' x, s and sums in registers and at step s of a chunk takes
// column (l + s) mod 32, so the pair's value never leaves registers: it
// feeds the rows' partials and the column's sums, the latter with -k d,
// d = x_i - x_j computed once (IEEE subtraction is antisymmetric, so -d is
// x_j - x_i exactly). The column sums are the warp's own records in shared
// memory, read and written once per step for kRows pairs. Interior chunks
// run without bounds or diagonal masks; only a chunk that crosses n, a strip
// that does, or a chunk that meets the strip's rows on a diagonal panel
// takes them. The counts are compare + predicated add per threshold at a
// compile-time T (3, the fused path's edges; a runtime T <= 8 runs the
// 8-threshold instance). Per chunk the block sums its warps' column records
// in warp order and adds each column's 2m sums to half 1 with one float32
// atomicAdd, and each thread adds its rows' chunk partials to their strip
// totals (a two-level row sum, against one register across the strip);
// operands and records are double-buffered, one barrier a chunk. The strip
// totals go to half 0 with plain stores (the block is their only writer),
// the counts through flush_counts' deterministic integer sums. phi's last
// bits vary from run to run through the column atomics; the counts do not.
// What the compiler makes of it (chip_profile.py --sass): at m = 2, T = 3
// the unmasked step loop issues 22.5 instructions a pair and 3
// shared-memory accesses per 8 pairs, where sympanel_body's instance issues
// about 85 and 5 a pair (the row pass: bounds checks, 8 predicated compare+add
// pairs for a runtime T, exp2f's range handling, the pair value to shared
// memory; the column pass: the value back, x_i and s_i, the difference
// again).
//
// The terms kernel at m = 1-8 and 11 (K12/K13's port, replacing
// _sym_panel_terms_direct_kernel, pallas_phi.py:2718, and
// _sym_panel_terms_kernel, :2925) runs the same micro-tile body with the
// pair's weights from its terms: k_c = sum_t s_t k_t for KS and
// w = sum_t s_t gamma_t k_t for D, each k_t one ex2.approx.ftz, the terms'
// constants -gamma_t log2(e), s_t and s_t gamma_t in registers for two
// terms (the hierarchical BLR's kernel) and in shared memory for any other
// count. At m = 11 a row's x, s, strip totals and chunk partials take 66
// registers and a column's records 22 floats each, padded to 24. What
// binds there is not FP32 issue alone: with 2 rows a thread a lane's 18
// 16-byte shared accesses a step (its column's operands, and its sums read
// and written) take about 72 of the shared-memory pipe's clocks a
// warp-step, against about 45 of issue. Two ways out were measured on the
// card (chip_profile.py; PERF.md section 6): 3 rows a thread, which
// spreads the same accesses over 3 pairs, and keeping the column's sums in
// registers, passed one lane down after each step with __shfl_sync (the
// lane rotation visits the columns in that order). At (131072, 11, two
// terms, T = 3) on an NVIDIA H100 80GB HBM3 (700 W) the rotation took
// 41.8-44.3 ms, 2 rows with records 46.2, and 3 rows with records spill
// (255 registers, 104 B) and took 46.1-46.2, against 83.2-83.8 for
// sympanel_body. So past m = 8 (kRotate) 2 rows a thread keep their
// column's sums in registers: 22 shuffles and 6 16-byte shared reads a
// step for 2 pairs, and after a chunk the warp writes its sums to its
// records by plane, so that the block's atomics cover 32 consecutive
// columns of one plane a warp. At m = 2 and 5 the records are faster
// (41.7-42.0 and 39.6-39.8 ms against 44.0 and 41.2 at (262144, 2) and
// (131072, 5), two terms) and stay. The m = 11 step loop then issues
// about 109 instructions a pair (82 of them FP32) at 249 registers, 2
// blocks an SM, and the kernel reaches about 66% of the card's issue
// rate: it is bound by instruction issue with two warps a scheduler to
// hide latency, not by shared memory or the special function unit.
//
// The body for wider m (sympanel_body; one RBF at m > 8 and the terms
// kernel at m = 9, 10 and 12-64, whose registers the micro-tile would
// spill): one block of kTile threads owns a strip of kTile rows of I and
// sweeps all columns of J in chunks of kTile; thread r keeps its row's 2m
// sums and T counts in registers across the strip and stores them once at
// the end. Per chunk the pair values go to a padded shared tile, thread r
// then owns column j and flushes its 2m column sums with float32 atomicAdd
// into half 1. On a diagonal panel a strip starts at its own chunk (the
// chunks before it hold no pair j >= i) and masks j < i on it; the self
// pairs enter both halves. Rows and columns past n are bounds checks.
//
// Past m = 64 (kMaxM) the bodies above would hold m values a row in
// registers and spill, so the three kernels take entries of their own,
// svgd_fused_phi_counts_sympanel_wide, ..._chunk_wide and
// svgd_fused_phi_terms_sympanel_wide, on the float32 wide triangles' body
// (wide_tri_sm90.cuh's wide_tri_sm90_body: tiles of 128, persistent blocks
// one an SM, a producer warp feeding a cp.async ring, 3xTF32 mma.sync, the
// norms from the staged Gram slices; one weight tile for one RBF, 196,640
// B of shared memory, two for terms, 225,312 B, with K8/K9's weights). With
// super-blocks a multiple of 128 (sym_plan.card_panel_plan(...,
// tile128=True)) the panels' tile pairs are the triangle's in another
// order: the blocks walk them (WidePanelWork: the whole list, or the
// panels [p0, p0 + count) of a rank's chunk; decode_panel_item, which K3's
// bf16 instance shares), the self pairs pinned on a diagonal panel's a == b
// only, tiles wholly past n skipped, and flush both directions into the
// (2m, n) accumulator [KS | D], as K2's wide instance does. The per-panel
// windows of the bodies above, which the TPU's VMEM budget called for,
// would only be scattered onto it: at (10000, 123) they took 91 MB, past
// the card's 50 MB L2, and at N = 262,144 2.3 GB. The rows must pass
// wide_rows_ok (16-byte aligned, m % 4 == 0: the wrapper pads them); the
// old entries refuse m > 64.
//
// The bfloat16 opt-in's K3 instance (fused_phi_counts_sympanel_bf16, any
// m) runs bf16_tri_sm90.cuh's body: persistent blocks walk the tile pairs
// of every panel (Bf16PanelWork: 128 x 128 tile pairs, so the plan's
// super-blocks are multiples of 128, sym_plan.card_panel_plan(...,
// bf16=True)), and flush [KS | KX | rowsum] into the (2m + 1, n)
// accumulator, as K2's bf16 instance does (the windows would only be
// scattered onto it); the wrapper forms D = rowsum x - KX in float32.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <limits.h>

#include <type_traits>

#include "bf16_tri_sm90.cuh"
#include "micro_tile.cuh"
#include "wide_tri_sm90.cuh"

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

// The super-blocks (I, J) of panel p of the list: the off-diagonal pairs
// first, in the order of the upper triangle of nb - 1 blocks shifted one
// column right, then the diagonal ones.
__device__ __forceinline__ void panel_blocks(int p, int nb, int* bi, int* bj) {
  const int n_off = nb * (nb - 1) / 2;
  if (p < n_off) {
    decode_upper_pair(p, nb - 1, bi, bj);
    ++*bj;
  } else {
    *bi = *bj = p - n_off;
  }
}

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
  const int p = static_cast<int>(blockIdx.y);  // the window
  int bi, bj;
  panel_blocks(p0 + p, nb, &bi, &bj);
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

// ---------------------------------------------------------------------------
// The micro-tile body: one RBF up to m = 8 (K3's and K5's port), and the
// terms kernel (K12/K13's port) at m = 2, 1-8 and 11.
// ---------------------------------------------------------------------------

// The micro-tile body's shape for an instance of width MM, one RBF or
// terms (kTerms). It serves one RBF up to MM = 8 and the terms kernel at
// MM = 2, 8 and 11; wider instances keep sympanel_body, whose registers
// the micro-tile would spill. A thread holds the coordinates, scores and
// strip totals of kRows rows, and their chunk partials: 6 kRows MM
// registers, 8 rows at MM = 2, 2 above (3 rows spill at MM = 11); a
// column's records as micro_tile.cuh's MicroShape lays them out.
template <int MM, bool kTerms>
struct MicroPanel : MicroShape<MM, (MM <= 2 ? 8 : 2)> {
  static constexpr bool enabled =
      kTerms ? MM == 2 || MM == 8 || MM == 11 : MM <= 8;
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStrip =
      kThreads * MicroShape<MM, (MM <= 2 ? 8 : 2)>::kRows;  // rows of a block
};

// Block size and strip height of a panel kernel instance.
template <int MM, bool kTerms>
struct PanelThreads {
  static constexpr int value = MicroPanel<MM, kTerms>::enabled
                                   ? MicroPanel<MM, kTerms>::kThreads
                                   : PanelTile<MM, kTerms>::value;
};

template <int MM, bool kTerms>
struct PanelStrip {
  static constexpr int value = MicroPanel<MM, kTerms>::enabled
                                   ? MicroPanel<MM, kTerms>::kStrip
                                   : PanelTile<MM, kTerms>::value;
};

// One block sweeps a strip of kStrip rows of super-block I against all
// columns of J (on a diagonal panel from the strip's own chunk on), 32
// columns a chunk. Per chunk: the block stages the chunk's x and s in
// shared memory; each warp sweeps it against its rows (micro_panel_chunk);
// the block sums the warps' column records in a fixed order and adds each
// column's 2m sums to half 1 with one float32 atomicAdd, and each thread
// adds its rows' chunk partials to their strip totals (a two-level row
// sum: 32 columns, then the chunks). The strip totals go to half 0 with
// plain stores at the end (the block is their only writer), the counts
// through flush_counts. kT is the number of thresholds, or kMaxT for a
// runtime T padded with the first threshold.
template <int MM, bool kExact, int kT, bool kTerms, class Weights>
__device__ __forceinline__ void micro_panel_body(
    const float* __restrict__ coords, const float* __restrict__ scores,
    const Weights& weights, const float* __restrict__ thr, int n, int m_arg,
    int T, int nb, int w, int p0, float* __restrict__ panels,
    unsigned long long* __restrict__ counts) {
  using P = MicroPanel<MM, kTerms>;
  constexpr int RI = P::kRows;
  constexpr int NT = P::kThreads;
  constexpr int STR = P::kStride;
  constexpr int REC = 2 * MM;
  constexpr int kColFloats = kPanelChunk * STR;
  __shared__ __align__(16) float sh_op[2 * kColFloats];
  __shared__ __align__(16) float sh_col[2 * P::kWarps * kColFloats];

  const int m = kExact ? MM : m_arg;
  const int p = static_cast<int>(blockIdx.y);  // the window
  int bi, bj;
  panel_blocks(p0 + p, nb, &bi, &bj);
  const bool diag = bi == bj;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int li0 = static_cast<int>(blockIdx.x) * P::kStrip;
  const int gi_base = bi * w;
  const int gj_base = bj * w;
  const int nrows = min(w, n - gi_base);  // rows of I below n
  const int ncols = min(w, n - gj_base);
  // Block-uniform: a strip or a super-block wholly past n has no pair.
  if (li0 >= nrows || ncols <= 0) return;

  float th[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) th[t] = thr[t < T ? t : 0];

  // Thread (warp, lane) holds rows row0 + 32 q of the strip.
  const int row0 = li0 + warp * 32 * RI + lane;
  float xi[RI][MM];
  float si[RI][MM];
  float ts[RI][MM];
  float td[RI][MM];
#pragma unroll
  for (int q = 0; q < RI; ++q) {
    const int li = row0 + q * 32;
    const size_t base = static_cast<size_t>(gi_base + li) * m;
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      const bool ld = li < nrows && (kExact || k < m);
      xi[q][k] = ld ? coords[base + k] : 0.0f;
      si[q][k] = ld ? scores[base + k] : 0.0f;
      ts[q][k] = 0.0f;
      td[q][k] = 0.0f;
    }
  }
  unsigned int cnt[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) cnt[t] = 0u;

  using Stage = ChunkStage<MM, kExact, NT, STR>;
  const size_t plane = static_cast<size_t>(w);
  float* half0 = panels + (static_cast<size_t>(p) * 2) * 2 * m * plane;
  float* half1 = half0 + 2 * m * plane;
  const int n_chunks = (ncols + kPanelChunk - 1) / kPanelChunk;
  // On a diagonal panel the chunks before the strip's own hold no j >= i.
  const int c_begin = diag ? li0 / kPanelChunk : 0;
  const bool rows_full = li0 + P::kStrip <= nrows;

  // Two buffers of each: chunk c sweeps sh_op[c & 1] into sh_col[c & 1]
  // while the block stages chunk c + 1 into the other operand buffer and
  // sums chunk c - 1's column records in the other record buffer, so one
  // barrier a chunk orders them.
  for (int e = tid; e < 2 * P::kWarps * kColFloats; e += NT) sh_col[e] = 0.0f;
  {
    float v[Stage::kCount];
    Stage::fetch(coords, scores, tid, m, gj_base, ncols, c_begin, v);
    Stage::store(v, tid, sh_op + (c_begin & 1) * kColFloats);
  }
  __syncthreads();
  for (int c = c_begin; c < n_chunks; ++c) {
    const int lj0 = c * kPanelChunk;
    const int buf = c & 1;
    const bool more = c + 1 < n_chunks;
    float next[Stage::kCount];
    if (more) Stage::fetch(coords, scores, tid, m, gj_base, ncols, c + 1, next);
    float ps[RI][MM];
    float pd[RI][MM];
#pragma unroll
    for (int q = 0; q < RI; ++q) {
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        ps[q][k] = 0.0f;
        pd[q][k] = 0.0f;
      }
    }
    const float* op = sh_op + buf * kColFloats;
    float* cols = sh_col + buf * P::kWarps * kColFloats;
    // Block-uniform: the chunk needs masks where it crosses n, where the
    // strip does, or where it meets the strip's rows on the diagonal.
    const bool masked = !rows_full || lj0 + kPanelChunk > ncols ||
                        (diag && lj0 < li0 + P::kStrip - 1);
    if (masked) {
      micro_panel_chunk<P, MM, kExact, kT, true>(
          xi, si, ps, pd, cnt, th, weights, m, op, cols + warp * kColFloats,
          lane, row0, nrows, lj0, ncols, diag);
    } else {
      micro_panel_chunk<P, MM, kExact, kT, false>(
          xi, si, ps, pd, cnt, th, weights, m, op, cols + warp * kColFloats,
          lane, row0, nrows, lj0, ncols, diag);
    }
#pragma unroll
    for (int q = 0; q < RI; ++q) {
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        ts[q][k] += ps[q][k];
        td[q][k] += pd[q][k];
      }
    }
    if (more) Stage::store(next, tid, sh_op + (buf ^ 1) * kColFloats);
    __syncthreads();  // chunk c's records are complete, c + 1 is staged
    // The columns: the warps' records summed in warp order, one atomic per
    // column and sum, and the records zeroed for chunk c + 2; records by
    // plane where the sums rotate, so a warp's atomics cover 32
    // consecutive columns of one plane.
    for (int e = tid; e < kPanelChunk * REC; e += NT) {
      int slot, kk, at;
      if constexpr (P::kRotate) {
        kk = e / kPanelChunk;
        slot = e - kk * kPanelChunk;
        at = e;
      } else {
        slot = e / REC;
        kk = e - slot * REC;
        at = slot * STR + kk;
      }
      const bool is_d = kk >= MM;
      const int k = is_d ? kk - MM : kk;
      float sum = 0.0f;
#pragma unroll
      for (int wp = 0; wp < P::kWarps; ++wp) {
        sum += cols[wp * kColFloats + at];
        if constexpr (!P::kRotate) cols[wp * kColFloats + at] = 0.0f;
      }
      if (lj0 + slot < ncols && (kExact || k < m)) {
        atomicAdd(half1 + static_cast<size_t>(is_d ? m + k : k) * plane +
                      lj0 + slot,
                  sum);
      }
    }
  }

  // The strip's rows: this block is their only writer in this panel.
#pragma unroll
  for (int q = 0; q < RI; ++q) {
    const int li = row0 + q * 32;
    if (li < nrows) {
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        if (kExact || k < m) {
          half0[static_cast<size_t>(k) * plane + li] = ts[q][k];
          half0[static_cast<size_t>(m + k) * plane + li] = td[q][k];
        }
      }
    }
  }
  flush_counts(cnt, T, counts);
}

// The single-RBF kernels' body: the micro-tile body up to MM = 8 at kT
// thresholds (3, or kMaxT for a runtime T), sympanel_body above.
template <int MM, bool kExact, int kT>
__device__ __forceinline__ void counts_sympanel(
    const float* __restrict__ coords, const float* __restrict__ scores,
    const float* __restrict__ gamma, const float* __restrict__ thr, int n,
    int m_arg, int T, int nb, int w, int p0, float* __restrict__ panels,
    unsigned long long* __restrict__ counts) {
  if constexpr (MicroPanel<MM, false>::enabled) {
    const OneRbf weights{-gamma[0] * kLog2e};
    micro_panel_body<MM, kExact, kT, false>(coords, scores, weights, thr, n,
                                            m_arg, T, nb, w, p0, panels,
                                            counts);
  } else {
    const TermSigns none{};
    sympanel_body<MM, kExact, false>(coords, scores, gamma, none, 1, thr, n,
                                     m_arg, T, nb, w, p0, panels, counts);
  }
}

template <int MM, bool kExact, int kT>
__global__ void __launch_bounds__(PanelThreads<MM, false>::value)
    fused_phi_counts_sympanel_kernel(const float* __restrict__ coords,
                                     const float* __restrict__ scores,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ thr, int n,
                                     int m_arg, int T, int nb, int w,
                                     float* __restrict__ panels,
                                     unsigned long long* __restrict__ counts) {
  counts_sympanel<MM, kExact, kT>(coords, scores, gamma, thr, n, m_arg, T, nb,
                                  w, 0, panels, counts);
}

template <int MM, bool kExact, int kT>
__global__ void __launch_bounds__(PanelThreads<MM, false>::value)
    fused_phi_counts_sympanel_chunk_kernel(
        const float* __restrict__ coords, const float* __restrict__ scores,
        const float* __restrict__ gamma, const float* __restrict__ thr, int n,
        int m_arg, int T, int nb, int w, int p0, float* __restrict__ panels,
        unsigned long long* __restrict__ counts) {
  counts_sympanel<MM, kExact, kT>(coords, scores, gamma, thr, n, m_arg, T, nb,
                                  w, p0, panels, counts);
}

// K3's bf16 instance (every m): bf16_tri_sm90.cuh's body over the tile
// pairs of the whole panel list (Bf16PanelWork), on the packed operands,
// into the (2m + 1, n) accumulator [KS | KX | rowsum].
template <int kT>
__global__ void __launch_bounds__(kBf16Threads, 1)
    fused_phi_counts_sympanel_bf16_kernel(
        Bf16Operands ops, const float* __restrict__ gamma,
        const float* __restrict__ thr, int n, int m, int T, long long items,
        Bf16PanelWork work, unsigned long long* __restrict__ counts) {
  bf16_tri_body<kT>(ops, -gamma[0] * kLog2e, thr, n, m, T, items, work,
                    counts);
}

// Launch of the single-RBF panel sweep over panels [p0, p0 + num_p) of the
// list (p0 = 0 and the whole list for fused_phi_counts_sympanel): the
// instance for T = 3 where the micro-tile body serves MM, else the one that
// takes a runtime T.
template <int MM, bool kExact>
void launch_counts_sympanel(bool chunk, const float* coords,
                            const float* scores, const float* gamma,
                            const float* thr, int n, int m, int T, int nb,
                            int w, int p0, unsigned int num_p, float* panels,
                            unsigned long long* counts, cudaStream_t s) {
  constexpr int strip = PanelStrip<MM, false>::value;
  const dim3 grid((w + strip - 1) / strip, num_p);
  const int threads = PanelThreads<MM, false>::value;
  auto go = [&](auto kt) {
    constexpr int kT = decltype(kt)::value;
    if (chunk) {
      fused_phi_counts_sympanel_chunk_kernel<MM, kExact, kT>
          <<<grid, threads, 0, s>>>(coords, scores, gamma, thr, n, m, T, nb,
                                    w, p0, panels, counts);
    } else {
      fused_phi_counts_sympanel_kernel<MM, kExact, kT>
          <<<grid, threads, 0, s>>>(coords, scores, gamma, thr, n, m, T, nb,
                                    w, panels, counts);
    }
  };
  if constexpr (MicroPanel<MM, false>::enabled) {
    if (T == 3) {
      go(std::integral_constant<int, 3>{});
      return;
    }
  }
  go(std::integral_constant<int, kMaxT>{});
}

// The terms kernel: the micro-tile body where it serves MM, at kT
// thresholds (3, or kMaxT for a runtime T) and NTerms terms (a
// compile-time count, or 0 for a runtime one); sympanel_body above.
template <int MM, bool kExact, int kT, int NTerms>
__global__ void __launch_bounds__(PanelThreads<MM, true>::value)
    fused_phi_terms_sympanel_kernel(const float* __restrict__ coords,
                                    const float* __restrict__ scores,
                                    const float* __restrict__ gammas,
                                    TermSigns signs, int nterms,
                                    const float* __restrict__ thr, int n,
                                    int m_arg, int T, int nb, int w,
                                    float* __restrict__ panels,
                                    unsigned long long* __restrict__ counts) {
  if constexpr (!MicroPanel<MM, true>::enabled) {
    sympanel_body<MM, kExact, true>(coords, scores, gammas, signs, nterms,
                                    thr, n, m_arg, T, nb, w, 0, panels,
                                    counts);
  } else if constexpr (NTerms > 0) {
    const FixedTerms<NTerms> weights(gammas, signs);
    micro_panel_body<MM, kExact, kT, true>(coords, scores, weights, thr, n,
                                           m_arg, T, nb, w, 0, panels, counts);
  } else {
    __shared__ float sh_g2[kMaxTerms];
    __shared__ float sh_sn[kMaxTerms];
    __shared__ float sh_sg[kMaxTerms];
    // The body's first barrier comes before its first pair.
    load_terms(gammas, signs, nterms, sh_g2, sh_sn, sh_sg);
    const AnyTerms weights{sh_g2, sh_sn, sh_sg, nterms};
    micro_panel_body<MM, kExact, kT, true>(coords, scores, weights, thr, n,
                                           m_arg, T, nb, w, 0, panels, counts);
  }
}

// Launch of the terms panel sweep: where the micro-tile body serves MM, the
// instance for T = 3 or any T <= 8, each for two terms (the hierarchical
// BLR's kernel) or any count; else sympanel_body's.
template <int MM, bool kExact>
void launch_terms_sympanel(const float* coords, const float* scores,
                           const float* gammas, const TermSigns& signs,
                           int nterms, const float* thr, int n, int m, int T,
                           int nb, int w, unsigned int num_p, float* panels,
                           unsigned long long* counts, cudaStream_t s) {
  constexpr int strip = PanelStrip<MM, true>::value;
  const dim3 grid((w + strip - 1) / strip, num_p);
  const int threads = PanelThreads<MM, true>::value;
  auto go = [&](auto kt, auto nt) {
    fused_phi_terms_sympanel_kernel<MM, kExact, decltype(kt)::value,
                                    decltype(nt)::value>
        <<<grid, threads, 0, s>>>(coords, scores, gammas, signs, nterms, thr,
                                  n, m, T, nb, w, panels, counts);
  };
  if constexpr (MicroPanel<MM, true>::enabled) {
    auto terms = [&](auto kt) {
      if (nterms == 2) {
        go(kt, std::integral_constant<int, 2>{});
      } else {
        go(kt, std::integral_constant<int, 0>{});
      }
    };
    if (T == 3) {
      terms(std::integral_constant<int, 3>{});
    } else {
      terms(std::integral_constant<int, kMaxT>{});
    }
  } else {
    go(std::integral_constant<int, kMaxT>{},
       std::integral_constant<int, 0>{});
  }
}

// ---------------------------------------------------------------------------
// Past kMaxM: wide_tri_sm90.cuh's body over the panel list's tile pairs
// (see the top of the file).
// ---------------------------------------------------------------------------

// K3's and K5's float32 instance past kMaxM: one RBF, kT thresholds (3, or
// kMaxT for a runtime T). The whole sweep and a rank's chunk run the same
// body under two names, so a profiler trace tells them apart.
template <int kT>
__global__ void __launch_bounds__(kWideSymThreads)
    fused_phi_counts_sympanel_wide_kernel(
        const float* __restrict__ coords, const float* __restrict__ scores,
        const float* __restrict__ gamma, const float* __restrict__ thr, int n,
        int m, int T, WidePanelWork work, float* __restrict__ acc,
        unsigned long long* __restrict__ counts) {
  wide_tri_sm90_body<kT>(coords, scores, OneRbf{-gamma[0] * kLog2e}, thr, n,
                         m, T, work, acc, counts);
}

template <int kT>
__global__ void __launch_bounds__(kWideSymThreads)
    fused_phi_counts_sympanel_chunk_wide_kernel(
        const float* __restrict__ coords, const float* __restrict__ scores,
        const float* __restrict__ gamma, const float* __restrict__ thr, int n,
        int m, int T, WidePanelWork work, float* __restrict__ acc,
        unsigned long long* __restrict__ counts) {
  wide_tri_sm90_body<kT>(coords, scores, OneRbf{-gamma[0] * kLog2e}, thr, n,
                         m, T, work, acc, counts);
}

// K12/K13's float32 instance past kMaxM, with K8/K9's wide weights: two
// terms in registers (NTerms = 2) or any count in shared memory (0).
template <int kT, int NTerms>
__global__ void __launch_bounds__(kWideSymThreads)
    fused_phi_terms_sympanel_wide_kernel(
        const float* __restrict__ coords, const float* __restrict__ scores,
        const float* __restrict__ gammas, TermSigns signs, int nterms,
        const float* __restrict__ thr, int n, int m, int T,
        WidePanelWork work, float* __restrict__ acc,
        unsigned long long* __restrict__ counts) {
  if constexpr (NTerms > 0) {
    wide_tri_sm90_body<kT>(coords, scores, FixedTerms<NTerms>(gammas, signs),
                           thr, n, m, T, work, acc, counts);
  } else {
    __shared__ float sh_g2[kMaxTerms];
    __shared__ float sh_sn[kMaxTerms];
    __shared__ float sh_sg[kMaxTerms];
    // The body's first barrier comes before its first pair.
    load_terms(gammas, signs, nterms, sh_g2, sh_sn, sh_sg);
    wide_tri_sm90_body<kT>(coords, scores,
                           AnyTerms{sh_g2, sh_sn, sh_sg, nterms}, thr, n, m,
                           T, work, acc, counts);
  }
}

// The wide panels' work: the tile pairs of panels [p0, p0 + num_p) of the
// list of nb super-blocks of w particles (w a multiple of kWideSymTile).
WidePanelWork wide_panel_work(int nb, int w, long long p0, long long num_p) {
  const int tw = w / kWideSymTile;
  const long long u0 = panel_first_item(p0, nb, tw);
  return WidePanelWork{nb, tw, u0,
                       panel_first_item(p0 + num_p, nb, tw) - u0};
}

// One persistent block an SM (wide_sym_prepare) over the work's items,
// with kTwo weight tiles.
template <bool kTwo, class Kernel, class... Args>
void launch_wide_panel(Kernel* kernel, const WidePanelWork& work,
                       cudaStream_t s, Args... args) {
  const unsigned int blocks = wide_sym_prepare<kTwo>(kernel, work.count);
  kernel<<<blocks, kWideSymThreads, WideSym<kTwo>::kSmemBytes, s>>>(args...);
}

// The plan's checks, shared by every entry point: nb super-blocks of w
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
// that receives the upper count U (diagonal included). 1 <= m <= 64 (past
// it svgd_fused_phi_counts_sympanel_wide), 1 <= T <= 8.
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
#define SVGD_LAUNCH_SYMPANEL(MM_, EX_)                                  \
  launch_counts_sympanel<MM_, EX_>(false, coords, scores, gamma, thr, n, m, \
                                   T, nb, w, 0, num_p, panels, c, s);
  SVGD_DISPATCH_M_2_11(m, SVGD_LAUNCH_SYMPANEL)
#undef SVGD_LAUNCH_SYMPANEL
  return static_cast<int>(cudaGetLastError());
}

// K3's float32 instance past m = 64 (see the top of the file): coords,
// scores, gamma, thr, n, T, nb and counts as
// svgd_fused_phi_counts_sympanel's; m > 64 a multiple of 4, coords and
// scores on 16-byte boundaries (wide_rows_ok: the wrapper pads the rows
// with zero columns); w a multiple of 128 (sym_plan.card_panel_plan(...,
// tile128=True)); acc a zeroed float32 (2m, n) accumulator that receives
// [KS | D] of the whole triangle, as svgd_fused_phi_counts_sym's.
int svgd_fused_phi_counts_sympanel_wide(const float* coords,
                                        const float* scores,
                                        const float* gamma, const float* thr,
                                        int n, int m, int T, int nb, int w,
                                        float* acc, long long* counts,
                                        void* stream) {
  if (!plan_ok(n, nb, w) || w % kWideSymTile ||
      w / kWideSymTile > kPanelMaxTiles || m <= kMaxM || T < 1 ||
      T > kMaxT || !wide_rows_ok(m, coords, scores)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const WidePanelWork work =
      wide_panel_work(nb, w, 0, static_cast<long long>(nb) * (nb + 1) / 2);
  auto go = [&](auto* kernel) {
    launch_wide_panel<false>(kernel, work, s, coords, scores, gamma, thr, n,
                             m, T, work, acc, c);
  };
  if (T == 3) {
    go(&fused_phi_counts_sympanel_wide_kernel<3>);
  } else {
    go(&fused_phi_counts_sympanel_wide_kernel<kMaxT>);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3's bf16 instance (the bfloat16 opt-in), at any m >= 1: coords, scores,
// gamma, thr, n, T, nb and counts as svgd_fused_phi_counts_sympanel's, the
// plan's w a multiple of kBf16Tile (sym_plan.card_panel_plan(...,
// tile128=True)); work, the pack and acc, a zeroed (2m + 1, n) float32
// accumulator that receives [KS | KX | rowsum], as
// svgd_fused_phi_counts_sym_bf16's.
int svgd_fused_phi_counts_sympanel_bf16(const float* coords,
                                        const float* scores,
                                        const float* gamma, const float* thr,
                                        int n, int m, int T, int nb, int w,
                                        void* work, float* acc,
                                        long long* counts, void* stream) {
  if (!plan_ok(n, nb, w) || w % kBf16Tile ||
      w / kBf16Tile > kPanelMaxTiles || m < 1 || T < 1 || T > kMaxT ||
      (reinterpret_cast<uintptr_t>(work) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const int tw = w / kBf16Tile;
  const long long items =
      panel_first_item(static_cast<long long>(nb) * (nb + 1) / 2, nb, tw);
  const Bf16PanelWork wk{nb, tw, w, n, acc};
  const Bf16Operands ops = bf16_tri_pack(coords, scores, n, m, work, s);
  auto go = [&](auto* kernel) {
    const unsigned int blocks = bf16_tri_prepare(kernel, items);
    kernel<<<blocks, kBf16Threads, Bf16Tri::kSmemBytes, s>>>(
        ops, gamma, thr, n, m, T, items, wk, c);
    return static_cast<int>(cudaGetLastError());
  };
  return T == 3 ? go(&fused_phi_counts_sympanel_bf16_kernel<3>)
                : go(&fused_phi_counts_sympanel_bf16_kernel<kMaxT>);
}

// One rank's chunk of the panel triangle sweep of one RBF: panels
// [p0, p0 + count) of the nb super-blocks' panel list, one window each in
// panels, a zeroed float32 (count, 2, 2m, w) buffer; the arguments otherwise
// as svgd_fused_phi_counts_sympanel's (coords and scores are the GLOBAL set,
// centered on its mean; 1 <= m <= 64). counts receives this chunk's upper
// count. count = 0 launches nothing.
int svgd_fused_phi_counts_sympanel_chunk(const float* coords,
                                         const float* scores,
                                         const float* gamma, const float* thr,
                                         int n, int m, int T, int nb, int w,
                                         int p0, int count, float* panels,
                                         long long* counts, void* stream) {
  const long long num_p = static_cast<long long>(nb) * (nb + 1) / 2;
  if (!plan_ok(n, nb, w) || T < 1 || T > kMaxT || p0 < 0 || count < 0 ||
      p0 + static_cast<long long>(count) > num_p || m < 1 || m > kMaxM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (count == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_SYMPANEL_CHUNK(MM_, EX_)                               \
  launch_counts_sympanel<MM_, EX_>(true, coords, scores, gamma, thr, n, m, T, \
                                   nb, w, p0,                                 \
                                   static_cast<unsigned int>(count), panels,  \
                                   c, s);
  SVGD_DISPATCH_M_2_11(m, SVGD_LAUNCH_SYMPANEL_CHUNK)
#undef SVGD_LAUNCH_SYMPANEL_CHUNK
  return static_cast<int>(cudaGetLastError());
}

// K5's float32 instance past m = 64: the tile pairs of panels
// [p0, p0 + count) of the list, the arguments otherwise as
// svgd_fused_phi_counts_sympanel_wide's (coords and scores the GLOBAL set,
// centered on its mean); acc, a zeroed (2m, n) accumulator, receives this
// chunk's share of [KS | D], counts its upper count. count = 0 launches
// nothing.
int svgd_fused_phi_counts_sympanel_chunk_wide(
    const float* coords, const float* scores, const float* gamma,
    const float* thr, int n, int m, int T, int nb, int w, int p0, int count,
    float* acc, long long* counts, void* stream) {
  const long long num_p = static_cast<long long>(nb) * (nb + 1) / 2;
  if (!plan_ok(n, nb, w) || w % kWideSymTile ||
      w / kWideSymTile > kPanelMaxTiles || m <= kMaxM || T < 1 ||
      T > kMaxT || !wide_rows_ok(m, coords, scores) || p0 < 0 || count < 0 ||
      p0 + static_cast<long long>(count) > num_p) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (count == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const WidePanelWork work = wide_panel_work(nb, w, p0, count);
  auto go = [&](auto* kernel) {
    launch_wide_panel<false>(kernel, work, s, coords, scores, gamma, thr, n,
                             m, T, work, acc, c);
  };
  if (T == 3) {
    go(&fused_phi_counts_sympanel_chunk_wide_kernel<3>);
  } else {
    go(&fused_phi_counts_sympanel_chunk_wide_kernel<kMaxT>);
  }
  return static_cast<int>(cudaGetLastError());
}

// Panel triangle sweep of a composed kernel: as above, with gammas
// (nterms,) float32 on the device and signs (nterms,) a HOST array, passed
// by value to the kernel. 1 <= nterms <= 16, 1 <= m <= 64.
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
#define SVGD_LAUNCH_TERMS_SYMPANEL(MM_, EX_)                             \
  launch_terms_sympanel<MM_, EX_>(coords, scores, gammas, sg, nterms, thr, \
                                  n, m, T, nb, w, num_p, panels, c, s);
  SVGD_DISPATCH_M_2_11(m, SVGD_LAUNCH_TERMS_SYMPANEL)
#undef SVGD_LAUNCH_TERMS_SYMPANEL
  return static_cast<int>(cudaGetLastError());
}

// K12/K13's float32 instance past m = 64: gammas, signs and nterms as
// svgd_fused_phi_terms_sympanel's, the rest as
// svgd_fused_phi_counts_sympanel_wide's; D in acc weighted by
// w = sum s gamma k.
int svgd_fused_phi_terms_sympanel_wide(const float* coords,
                                       const float* scores,
                                       const float* gammas,
                                       const float* signs, int nterms,
                                       const float* thr, int n, int m, int T,
                                       int nb, int w, float* acc,
                                       long long* counts, void* stream) {
  if (!plan_ok(n, nb, w) || w % kWideSymTile ||
      w / kWideSymTile > kPanelMaxTiles || m <= kMaxM || T < 1 ||
      T > kMaxT || nterms < 1 || nterms > kMaxTerms ||
      !wide_rows_ok(m, coords, scores)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TermSigns sg = make_signs(signs, nterms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const WidePanelWork work =
      wide_panel_work(nb, w, 0, static_cast<long long>(nb) * (nb + 1) / 2);
  auto go = [&](auto kt, auto nt) {
    auto* kernel = &fused_phi_terms_sympanel_wide_kernel<decltype(kt)::value,
                                                         decltype(nt)::value>;
    launch_wide_panel<true>(kernel, work, s, coords, scores, gammas, sg,
                            nterms, thr, n, m, T, work, acc, c);
  };
  auto terms = [&](auto kt) {
    if (nterms == 2) {
      go(kt, std::integral_constant<int, 2>{});
    } else {
      go(kt, std::integral_constant<int, 0>{});
    }
  };
  if (T == 3) {
    terms(std::integral_constant<int, 3>{});
  } else {
    terms(std::integral_constant<int, kMaxT>{});
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
