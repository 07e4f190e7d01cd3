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
// equal the plain version's), one ex2 on the special function unit, T
// compares and 4m FMAs (k s and k d into both directions). The operands are
// 2nm floats and the windows a few hundred MB at most, so the sweep is
// bound by instruction issue on the FP32 pipes, not by memory: at m = 2,
// T = 3 the floor is 21 instructions a pair (5 for sq, a multiply and the
// ex2, 8 FMAs, a compare and an add per threshold).
//
// The single-RBF body up to m = 8 (micro_panel_body; K3's and K5's port).
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
// The body for wider m (sympanel_body; the terms kernel, and one RBF at
// m > 8, whose registers the micro-tile would spill): one block of kTile
// threads owns a strip of kTile rows of I and sweeps all columns of J in
// chunks of kTile; thread r keeps its row's 2m sums and T counts in
// registers across the strip and stores them once at the end. Per chunk
// the pair values go to a padded shared tile, thread r then owns column j
// and flushes its 2m column sums with float32 atomicAdd into half 1. On a
// diagonal panel a strip starts at its own chunk (the chunks before it
// hold no pair j >= i) and masks j < i on it; the self pairs enter both
// halves. Rows and columns past n are bounds checks.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <limits.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// The single-RBF body (K3's and K5's port) up to m = 8: register micro-tiles.
// ---------------------------------------------------------------------------

// Columns per chunk: one per lane. Steps of a chunk unrolled together.
constexpr int kPanelChunk = 32;
constexpr int kPanelUnroll = 2;

// The micro-tile body's shape for an instance of width MM. It serves
// MM <= 8 (the instances of m = 2 and of 1 <= m <= 8): a thread holds the
// coordinates, scores and both sums of kRows rows, 4 kRows MM registers
// and 2 kRows MM more for the chunk's row partials, which wider m would
// spill. Wider instances keep sympanel_body.
template <int MM>
struct MicroPanel {
  static constexpr bool enabled = MM <= 8;
  static constexpr int kRows = MM <= 2 ? 8 : 2;
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStrip = kThreads * kRows;  // rows of a block
  // A column's record in shared memory: [x (MM) | s (MM)] for the operands,
  // [KS (MM) | D (MM)] for the partial sums; padded by 4 floats where 2 MM
  // is a multiple of 8, so that 8 lanes' 16-byte reads of 8 consecutive
  // records fall in distinct banks.
  static constexpr int kRec = 2 * MM;
  static constexpr int kStride = kRec % 8 == 0 ? kRec + 4 : kRec;
  static_assert(!enabled || kRec % 4 == 0, "records are read as float4");
};

template <int MM>
struct CountsPanelThreads {
  static constexpr int value = MicroPanel<MM>::enabled
                                   ? MicroPanel<MM>::kThreads
                                   : CountsPanelTile<MM>::value;
};

template <int MM>
struct CountsPanelStrip {
  static constexpr int value = MicroPanel<MM>::enabled
                                   ? MicroPanel<MM>::kStrip
                                   : CountsPanelTile<MM>::value;
};

// 2^x on the special function unit, subnormal results flushed to zero: a
// weight below 2^-126 is far below the float32 resolution of a row's KS,
// which holds the self pair's k = 1.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One warp's sweep of one chunk: lane l holds rows R(l, q), q < RI, and at
// step s takes column slot (l + s) mod 32 of the chunk, so the warp's 32
// lanes hold 32 distinct columns at every step. The pair's value k stays in
// registers and feeds both directions: the rows' chunk partials (k s_j and
// k d, d = x_i - x_j) and the column's running sums (k s_i and -k d, which
// is k (x_j - x_i) exactly: IEEE subtraction is antisymmetric). The column
// sums live in the warp's own shared records, read and written once per
// step; __syncwarp orders a slot's write by one lane before the next
// step's read by its neighbour. kMasked adds the per-pair validity (rows
// and columns below n, j >= i on a diagonal panel); interior chunks run
// without it.
template <int MM, bool kExact, int kT, bool kMasked>
__device__ __forceinline__ void micro_panel_chunk(
    const float (&xi)[MicroPanel<MM>::kRows][MM],
    const float (&si)[MicroPanel<MM>::kRows][MM],
    float (&ps)[MicroPanel<MM>::kRows][MM],
    float (&pd)[MicroPanel<MM>::kRows][MM], unsigned int* cnt,
    const float* th, float ng2, int m, const float* sh_op, float* sh_col,
    int lane, int row0, int nrows, int lj0, int ncols, bool diag) {
  using P = MicroPanel<MM>;
  constexpr int RI = P::kRows;
  constexpr int STR = P::kStride;
#pragma unroll kPanelUnroll
  for (int s = 0; s < kPanelChunk; ++s) {
    const int slot = (lane + s) & (kPanelChunk - 1);
    float op[P::kRec];
    float col[P::kRec];
    const float4* op4 = reinterpret_cast<const float4*>(sh_op + slot * STR);
    float4* col4 = reinterpret_cast<float4*>(sh_col + slot * STR);
#pragma unroll
    for (int v = 0; v < P::kRec / 4; ++v) {
      const float4 a = op4[v];
      const float4 b = col4[v];
      op[4 * v] = a.x;
      op[4 * v + 1] = a.y;
      op[4 * v + 2] = a.z;
      op[4 * v + 3] = a.w;
      col[4 * v] = b.x;
      col[4 * v + 1] = b.y;
      col[4 * v + 2] = b.z;
      col[4 * v + 3] = b.w;
    }
    const int lj = lj0 + slot;
#pragma unroll
    for (int q = 0; q < RI; ++q) {
      float d[MM];
      float sq = 0.0f;
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        if (kExact || k < m) {
          d[k] = __fsub_rn(xi[q][k], op[k]);
          sq = k == 0 ? __fmul_rn(d[k], d[k])
                      : __fadd_rn(sq, __fmul_rn(d[k], d[k]));
        }
      }
      bool ok = true;
      if (kMasked) {
        const int li = row0 + q * 32;
        ok = li < nrows && lj < ncols && (!diag || lj >= li);
      }
      float kc = ex2_ftz(ng2 * sq);
      if (kMasked) kc = ok ? kc : 0.0f;
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        if (kExact || k < m) {
          ps[q][k] = fmaf(kc, op[MM + k], ps[q][k]);
          pd[q][k] = fmaf(kc, d[k], pd[q][k]);
          col[k] = fmaf(kc, si[q][k], col[k]);
          col[MM + k] = fmaf(-kc, d[k], col[MM + k]);
        }
      }
      count_pair_fixed<kT, kMasked>(sq, th, ok, cnt);
    }
#pragma unroll
    for (int v = 0; v < P::kRec / 4; ++v) {
      col4[v] = make_float4(col[4 * v], col[4 * v + 1], col[4 * v + 2],
                            col[4 * v + 3]);
    }
    __syncwarp();
  }
}

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
// runtime T padded with thresholds below zero.
template <int MM, bool kExact, int kT>
__device__ __forceinline__ void micro_panel_body(
    const float* __restrict__ coords, const float* __restrict__ scores,
    const float* __restrict__ gamma, const float* __restrict__ thr, int n,
    int m_arg, int T, int nb, int w, int p0, float* __restrict__ panels,
    unsigned long long* __restrict__ counts) {
  using P = MicroPanel<MM>;
  constexpr int RI = P::kRows;
  constexpr int NT = P::kThreads;
  constexpr int STR = P::kStride;
  constexpr int REC = P::kRec;
  constexpr int kColFloats = kPanelChunk * STR;
  __shared__ __align__(16) float sh_op[2 * kColFloats];
  __shared__ __align__(16) float sh_col[2 * P::kWarps * kColFloats];

  const int m = kExact ? MM : m_arg;
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

  const float ng2 = -gamma[0] * kLog2e;
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

  // Chunk c's x and s, zero past n: fetched into registers a chunk ahead,
  // stored to shared memory once the current chunk is swept.
  constexpr int kStage = (kPanelChunk * REC + NT - 1) / NT;
  auto fetch = [&](int c, float (&v)[kStage]) {
    const int lj0 = c * kPanelChunk;
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = tid + u * NT;
      const int slot = e / REC;
      const int kk = e - slot * REC;
      const bool is_s = kk >= MM;
      const int k = is_s ? kk - MM : kk;
      v[u] = 0.0f;
      if (e < kPanelChunk * REC && lj0 + slot < ncols &&
          (kExact || k < m)) {
        const size_t at = static_cast<size_t>(gj_base + lj0 + slot) * m + k;
        v[u] = is_s ? scores[at] : coords[at];
      }
    }
  };
  auto store = [&](const float (&v)[kStage], float* buf) {
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = tid + u * NT;
      const int slot = e / REC;
      if (e < kPanelChunk * REC) buf[slot * STR + e - slot * REC] = v[u];
    }
  };

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
    float v[kStage];
    fetch(c_begin, v);
    store(v, sh_op + (c_begin & 1) * kColFloats);
  }
  __syncthreads();
  for (int c = c_begin; c < n_chunks; ++c) {
    const int lj0 = c * kPanelChunk;
    const int buf = c & 1;
    const bool more = c + 1 < n_chunks;
    float next[kStage];
    if (more) fetch(c + 1, next);
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
      micro_panel_chunk<MM, kExact, kT, true>(
          xi, si, ps, pd, cnt, th, ng2, m, op, cols + warp * kColFloats, lane,
          row0, nrows, lj0, ncols, diag);
    } else {
      micro_panel_chunk<MM, kExact, kT, false>(
          xi, si, ps, pd, cnt, th, ng2, m, op, cols + warp * kColFloats, lane,
          row0, nrows, lj0, ncols, diag);
    }
#pragma unroll
    for (int q = 0; q < RI; ++q) {
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        ts[q][k] += ps[q][k];
        td[q][k] += pd[q][k];
      }
    }
    if (more) store(next, sh_op + (buf ^ 1) * kColFloats);
    __syncthreads();  // chunk c's records are complete, c + 1 is staged
    // The columns: the warps' records summed in warp order, one atomic per
    // column and sum, and the records zeroed for chunk c + 2.
    for (int e = tid; e < kPanelChunk * REC; e += NT) {
      const int slot = e / REC;
      const int kk = e - slot * REC;
      const bool is_d = kk >= MM;
      const int k = is_d ? kk - MM : kk;
      const int at = slot * STR + kk;
      float sum = 0.0f;
#pragma unroll
      for (int wp = 0; wp < P::kWarps; ++wp) {
        sum += cols[wp * kColFloats + at];
        cols[wp * kColFloats + at] = 0.0f;
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
  if constexpr (MicroPanel<MM>::enabled) {
    micro_panel_body<MM, kExact, kT>(coords, scores, gamma, thr, n, m_arg, T,
                                     nb, w, p0, panels, counts);
  } else {
    const TermSigns none{};
    sympanel_body<MM, kExact, false>(coords, scores, gamma, none, 1, thr, n,
                                     m_arg, T, nb, w, p0, panels, counts);
  }
}

template <int MM, bool kExact, int kT>
__global__ void __launch_bounds__(CountsPanelThreads<MM>::value)
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
__global__ void __launch_bounds__(CountsPanelThreads<MM>::value)
    fused_phi_counts_sympanel_chunk_kernel(
        const float* __restrict__ coords, const float* __restrict__ scores,
        const float* __restrict__ gamma, const float* __restrict__ thr, int n,
        int m_arg, int T, int nb, int w, int p0, float* __restrict__ panels,
        unsigned long long* __restrict__ counts) {
  counts_sympanel<MM, kExact, kT>(coords, scores, gamma, thr, n, m_arg, T, nb,
                                  w, p0, panels, counts);
}

// Launch of the single-RBF panel sweep over panels [p0, p0 + num_p) of the
// list (p0 = 0 and the whole list for fused_phi_counts_sympanel): the
// instance for T = 3 where the micro-tile body serves MM, else the one
// that takes a runtime T.
template <int MM, bool kExact>
void launch_counts_sympanel(bool chunk, const float* coords,
                            const float* scores, const float* gamma,
                            const float* thr, int n, int m, int T, int nb,
                            int w, int p0, unsigned int num_p, float* panels,
                            unsigned long long* counts, cudaStream_t s) {
  constexpr int strip = CountsPanelStrip<MM>::value;
  const dim3 grid((w + strip - 1) / strip, num_p);
  const int threads = CountsPanelThreads<MM>::value;
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
  if constexpr (MicroPanel<MM>::enabled) {
    if (T == 3) {
      go(std::integral_constant<int, 3>{});
      return;
    }
  }
  go(std::integral_constant<int, kMaxT>{});
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
#define SVGD_LAUNCH_SYMPANEL(MM_, EX_)                                  \
  launch_counts_sympanel<MM_, EX_>(false, coords, scores, gamma, thr, n, m, \
                                   T, nb, w, 0, num_p, panels, c, s);
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
#define SVGD_LAUNCH_SYMPANEL_CHUNK(MM_, EX_)                               \
  launch_counts_sympanel<MM_, EX_>(true, coords, scores, gamma, thr, n, m, T, \
                                   nb, w, p0,                                 \
                                   static_cast<unsigned int>(count), panels,  \
                                   c, s);
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
