// The micro-tile body, shared by the panel kernels (fused_phi_panel.cu:
// K3's, K5's and K12/K13's ports), the terms triangle kernels
// (fused_phi_terms.cu: K8/K9's and K10/K11's) and the fixed-P triangle
// kernel (phi_rbf.cu: K15's): a chunk's operand staging (ChunkStage), one
// warp's sweep of one 32-column chunk (micro_panel_chunk), and the
// triangle's block body over one tile pair of the upper triangle
// (micro_tri_body).
//
// A thread holds the coordinates, scores and running sums of kRows rows in
// registers. A warp sweeps a chunk of 32 columns: at step s lane l takes
// column (l + s) mod 32, so the pair's weights never leave registers and
// feed both directions, the rows' partials and the column's sums (the
// column with -w d, d = x_i - x_j computed once: IEEE subtraction is
// antisymmetric, so -d is x_j - x_i exactly). The column's sums live in the
// warp's shared records, read and written once a step, or, past MM = 8
// (kRotate), in registers passed one lane down after each step.

#pragma once

#include "sweep_common.cuh"

namespace svgd {

// Columns per chunk: one per lane. Steps of a chunk unrolled together.
constexpr int kPanelChunk = 32;
constexpr int kPanelUnroll = 2;

// A thread's share of the micro-tile body for width MM: kRows rows, and a
// column's record in shared memory, [x (MM) | s (MM)] for the operands,
// [KS (MM) | D (MM)] for the partial sums, padded to kPad, a multiple of 4
// floats for float4 access, records kStride apart: 4 more where kPad is a
// multiple of 8, so that 8 lanes' 16-byte reads of 8 consecutive records
// fall in distinct banks. Past MM = 8 the column's sums rotate between
// lanes instead of passing through the records every step.
template <int MM, int kRowsT>
struct MicroShape {
  static constexpr int kRows = kRowsT;
  static constexpr bool kRotate = MM > 8;
  static constexpr int kPad = (2 * MM + 3) / 4 * 4;
  static constexpr int kStride = kPad % 8 == 0 ? kPad + 4 : kPad;
};

// The triangle kernels' shape (micro_tri_body): square tiles of kSide =
// 128 particles (TermsTriTile), a block per tile pair of kWarps warps, each
// warp 32 kRows consecutive rows of the row tile, kRows = 4 up to MM = 2
// and 2 above (1 and 2 warps a block). At n = 10,000 that is 3160 tile
// pairs; at m = 11 a block of 2 warps takes up to 255 registers a thread,
// 4 blocks an SM, 528 blocks at a time on 132 SMs: 6 waves.
template <int MM>
struct MicroTri : MicroShape<MM, (MM <= 2 ? 4 : 2)> {
  using Shape = MicroShape<MM, (MM <= 2 ? 4 : 2)>;
  static constexpr bool enabled = TermsTriTile<MM>::kMicro;
  static constexpr int kSide = 128;
  static constexpr int kWarps = kSide / (32 * Shape::kRows);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kChunks = kSide / kPanelChunk;
};

// The pair's weights (k_c, w) from its sq: k_c multiplies the scores into
// KS and w the differences into D. One RBF: k_c = w = 2^(-gamma log2(e) sq)
// (D is scaled by 2 gamma in the epilogue).
struct OneRbf {
  static constexpr bool kFixedP = false;
  float ng2;  // -gamma log2(e)

  __device__ __forceinline__ void operator()(float sq, float& kc,
                                             float& w) const {
    kc = ex2_ftz(ng2 * sq);
    w = kc;
  }
};

// The fixed-P kernel's pair (K15's port): in place of sq the form
// q = sum_k lam_k log2(e) dz_k^2 over the rows z = X_c V, clamped at 0 when
// P is taken as positive semidefinite (qmin = 0, else -inf), and
// k_c = w = 2^-q. Its self pair enters KS once, as in the square sweep:
// the column direction skips it.
template <int MM>
struct FixedPForm {
  static constexpr bool kFixedP = true;
  float lam2[MM];  // lam_k log2(e), 0 past m
  float qmin;

  __device__ __forceinline__ void operator()(float q, float& kc,
                                             float& w) const {
    kc = ex2_ftz(-q);
    w = kc;
  }
};

// A chunk's operand records [x (MM) | s (MM)] of the column tile, STR
// floats apart in shared memory, zero past n and past m: kCount values a
// thread of NT, fetched into registers a chunk ahead and stored once the
// current chunk is swept.
template <int MM, bool kExact, int NT, int STR>
struct ChunkStage {
  static constexpr int kRec = 2 * MM;
  static constexpr int kCount = (kPanelChunk * kRec + NT - 1) / NT;

  static __device__ __forceinline__ void fetch(
      const float* __restrict__ coords, const float* __restrict__ scores,
      int tid, int m, int gj_base, int ncols, int c, float (&v)[kCount]) {
    const int lj0 = c * kPanelChunk;
#pragma unroll
    for (int u = 0; u < kCount; ++u) {
      const int e = tid + u * NT;
      const int slot = e / kRec;
      const int kk = e - slot * kRec;
      const bool is_s = kk >= MM;
      const int k = is_s ? kk - MM : kk;
      v[u] = 0.0f;
      if (e < kPanelChunk * kRec && lj0 + slot < ncols && (kExact || k < m)) {
        const size_t at = static_cast<size_t>(gj_base + lj0 + slot) * m + k;
        v[u] = is_s ? scores[at] : coords[at];
      }
    }
  }

  static __device__ __forceinline__ void store(const float (&v)[kCount],
                                               int tid, float* buf) {
#pragma unroll
    for (int u = 0; u < kCount; ++u) {
      const int e = tid + u * NT;
      const int slot = e / kRec;
      if (e < kPanelChunk * kRec) buf[slot * STR + e - slot * kRec] = v[u];
    }
  }
};

// One warp's sweep of one chunk: lane l holds rows R(l, q), q < RI, and at
// step s takes column slot (l + s) mod 32, so the warp's 32 lanes hold 32
// distinct columns at every step. The pair's weights (k_c, w) stay in
// registers and feed both directions: the rows' chunk partials (k_c s_j
// and w d, d = x_i - x_j) and the column's running sums (k_c s_i and -w d,
// which is w (x_j - x_i) exactly). The column sums live in the warp's own
// shared records, read and written once per step; __syncwarp orders a
// slot's write by one lane before the next step's read by its neighbour.
// Where they rotate (P::kRotate), lane l takes over lane l + 1's sums after
// each step, its own column at the next one, so after the 32 steps lane l
// holds column l's and writes them to the records by plane. kMasked adds
// the per-pair validity (rows and columns below their counts, j >= i on a
// diagonal tile or panel); interior chunks run without it. A pair of
// Weights::kFixedP takes the fixed-P form and keeps its self pair out of
// the column direction. kT thresholds (0: no counts).
template <class P, int MM, bool kExact, int kT, bool kMasked, class Weights>
__device__ __forceinline__ void micro_panel_chunk(
    const float (&xi)[P::kRows][MM], const float (&si)[P::kRows][MM],
    float (&ps)[P::kRows][MM], float (&pd)[P::kRows][MM], unsigned int* cnt,
    const float* th, const Weights& weights, int m, const float* sh_op,
    float* sh_col, int lane, int row0, int nrows, int lj0, int ncols,
    bool diag) {
  constexpr int RI = P::kRows;
  constexpr int STR = P::kStride;
  float col[P::kPad];  // the column's sums, carried across steps if rotating
  if constexpr (P::kRotate) {
#pragma unroll
    for (int k = 0; k < P::kPad; ++k) col[k] = 0.0f;
  }
#pragma unroll kPanelUnroll
  for (int s = 0; s < kPanelChunk; ++s) {
    const int slot = (lane + s) & (kPanelChunk - 1);
    float op[P::kPad];
    const float4* op4 = reinterpret_cast<const float4*>(sh_op + slot * STR);
    float4* col4 = reinterpret_cast<float4*>(sh_col + slot * STR);
#pragma unroll
    for (int v = 0; v < P::kPad / 4; ++v) {
      const float4 a = op4[v];
      op[4 * v] = a.x;
      op[4 * v + 1] = a.y;
      op[4 * v + 2] = a.z;
      op[4 * v + 3] = a.w;
      if constexpr (!P::kRotate) {
        const float4 b = col4[v];
        col[4 * v] = b.x;
        col[4 * v + 1] = b.y;
        col[4 * v + 2] = b.z;
        col[4 * v + 3] = b.w;
      }
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
          if constexpr (Weights::kFixedP) {
            sq = fmaf(weights.lam2[k] * d[k], d[k], sq);
          } else {
            sq = k == 0 ? __fmul_rn(d[k], d[k])
                        : __fadd_rn(sq, __fmul_rn(d[k], d[k]));
          }
        }
      }
      if constexpr (Weights::kFixedP) sq = fmaxf(sq, weights.qmin);
      bool ok = true;
      bool self = false;
      if (kMasked) {
        const int li = row0 + q * 32;
        ok = li < nrows && lj < ncols && (!diag || lj >= li);
        self = Weights::kFixedP && diag && lj == li;
      }
      float kc, w;
      weights(sq, kc, w);
      if (kMasked) {
        kc = ok ? kc : 0.0f;
        w = ok ? w : 0.0f;
      }
      const float kc_col = self ? 0.0f : kc;  // the self pair's other half
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        if (kExact || k < m) {
          ps[q][k] = fmaf(kc, op[MM + k], ps[q][k]);
          pd[q][k] = fmaf(w, d[k], pd[q][k]);
          col[k] = fmaf(kc_col, si[q][k], col[k]);
          col[MM + k] = fmaf(-w, d[k], col[MM + k]);
        }
      }
      count_pair_fixed<kT, kMasked>(sq, th, ok, cnt);
    }
    if constexpr (P::kRotate) {
      const int next = (lane + 1) & (kPanelChunk - 1);
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        if (kExact || k < m) {
          col[k] = __shfl_sync(0xffffffffu, col[k], next);
          col[MM + k] = __shfl_sync(0xffffffffu, col[MM + k], next);
        }
      }
    } else {
#pragma unroll
      for (int v = 0; v < P::kPad / 4; ++v) {
        col4[v] = make_float4(col[4 * v], col[4 * v + 1], col[4 * v + 2],
                              col[4 * v + 3]);
      }
      __syncwarp();
    }
  }
  if constexpr (P::kRotate) {
#pragma unroll
    for (int k = 0; k < 2 * MM; ++k) sh_col[k * kPanelChunk + lane] = col[k];
  }
}

// The triangle's block body (MicroTri's shape): one block per tile pair
// (bi <= bj) of the upper triangle, the pair t0 + blockIdx.x of the tile
// list, and the chunks of the column tile split over the grid's second
// dimension (blockIdx.y of gridDim.y ranges). Per chunk: the block stages
// the chunk's x and s in shared memory (a chunk ahead, double-buffered, one
// barrier a chunk); each warp sweeps it against its rows
// (micro_panel_chunk); the block sums the warps' column records in warp
// order and adds each column's 2m sums to acc with one float32 atomicAdd;
// each thread adds its rows' chunk partials to their running totals. A
// warp whose rows lie wholly below a chunk on a diagonal tile skips it
// (warp-uniform); interior chunks run unmasked, masks apply only on the
// diagonal and at n. At the end the rows' totals go to acc with float32
// atomicAdd (a row is swept by every tile pair of its tile row and column)
// and the counts through flush_counts. acc is the zeroed (2m, n)
// accumulator [KS | D]; the self pairs enter both directions unless
// Weights::kFixedP. kT thresholds (3, or kMaxT for a runtime T padded with
// the first threshold; 0: no counts).
template <int MM, bool kExact, int kT, class Weights>
__device__ __forceinline__ void micro_tri_body(
    const float* __restrict__ coords, const float* __restrict__ scores,
    const Weights& weights, const float* __restrict__ thr, int n, int m_arg,
    int T, int nb, long long t0, float* __restrict__ acc,
    unsigned long long* __restrict__ counts) {
  using P = MicroTri<MM>;
  constexpr int RI = P::kRows;
  constexpr int NT = P::kThreads;
  constexpr int STR = P::kStride;
  constexpr int REC = 2 * MM;
  constexpr int kColFloats = kPanelChunk * STR;
  constexpr int kWarpRows = 32 * RI;
  __shared__ __align__(16) float sh_op[2 * kColFloats];
  __shared__ __align__(16) float sh_col[2 * P::kWarps * kColFloats];

  const int m = kExact ? MM : m_arg;
  int bi, bj;
  decode_upper_pair(t0 + static_cast<long long>(blockIdx.x), nb, &bi, &bj);
  const bool diag = bi == bj;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gi_base = bi * P::kSide;
  const int gj_base = bj * P::kSide;
  const int nrows = min(P::kSide, n - gi_base);
  const int ncols = min(P::kSide, n - gj_base);
  const int n_chunks = (ncols + kPanelChunk - 1) / kPanelChunk;
  const int per = (n_chunks + static_cast<int>(gridDim.y) - 1) /
                  static_cast<int>(gridDim.y);
  const int c_lo = static_cast<int>(blockIdx.y) * per;
  const int c_hi = min(n_chunks, c_lo + per);
  // Block-uniform: a split past the tile's chunks has no pair.
  if (c_lo >= c_hi) return;

  float th[kT > 0 ? kT : 1];
#pragma unroll
  for (int t = 0; t < kT; ++t) th[t] = thr[t < T ? t : 0];

  // Thread (warp, lane) holds rows row0 + 32 q of the row tile.
  const int wr0 = warp * kWarpRows;  // the warp's first row
  const int row0 = wr0 + lane;
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

  // Warp-uniform: the warp's rows below n, all of them or none.
  const bool rows_full = wr0 + kWarpRows <= nrows;
  const bool rows_none = wr0 >= nrows;
  const int wr_last = wr0 + kWarpRows - 1;

  using Stage = ChunkStage<MM, kExact, NT, STR>;
  for (int e = tid; e < 2 * P::kWarps * kColFloats; e += NT) sh_col[e] = 0.0f;
  {
    float v[Stage::kCount];
    Stage::fetch(coords, scores, tid, m, gj_base, ncols, c_lo, v);
    Stage::store(v, tid, sh_op + (c_lo & 1) * kColFloats);
  }
  __syncthreads();
  for (int c = c_lo; c < c_hi; ++c) {
    const int lj0 = c * kPanelChunk;
    const int buf = c & 1;
    const bool more = c + 1 < c_hi;
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
    float* mine = cols + warp * kColFloats;
    // Warp-uniform: no pair where the warp has no rows or, on a diagonal
    // tile, where its rows all lie past the chunk's columns; masks where
    // its rows or the chunk cross n, or the chunk meets its rows on the
    // diagonal.
    const bool skip = rows_none || (diag && lj0 + kPanelChunk - 1 < wr0);
    const bool masked = !rows_full || lj0 + kPanelChunk > ncols ||
                        (diag && lj0 < wr_last);
    if (skip) {
      if constexpr (P::kRotate) {  // records by plane, read by the block
#pragma unroll
        for (int k = 0; k < REC; ++k) mine[k * kPanelChunk + lane] = 0.0f;
      }
    } else if (masked) {
      micro_panel_chunk<P, MM, kExact, kT, true>(
          xi, si, ps, pd, cnt, th, weights, m, op, mine, lane, row0, nrows,
          lj0, ncols, diag);
    } else {
      micro_panel_chunk<P, MM, kExact, kT, false>(
          xi, si, ps, pd, cnt, th, weights, m, op, mine, lane, row0, nrows,
          lj0, ncols, diag);
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
        atomicAdd(acc + static_cast<size_t>(is_d ? m + k : k) * n + gj_base +
                      lj0 + slot,
                  sum);
      }
    }
  }

  // The rows' totals over this block's chunks.
#pragma unroll
  for (int q = 0; q < RI; ++q) {
    const int li = row0 + q * 32;
    if (li < nrows) {
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        if (kExact || k < m) {
          atomicAdd(acc + static_cast<size_t>(k) * n + gi_base + li,
                    ts[q][k]);
          atomicAdd(acc + static_cast<size_t>(m + k) * n + gi_base + li,
                    td[q][k]);
        }
      }
    }
  }
  if constexpr (kT > 0) flush_counts(cnt, T, counts);
}

// The grid's second dimension of a triangle launch over `pairs` tile pairs:
// splits of each tile pair's kChunks chunks, so that a small launch still
// puts kMinBlocks blocks on the card (several per SM; at n = 1500, 78 tile
// pairs take 4 splits each).
constexpr int kTriMinBlocks = 1056;

template <int MM>
inline unsigned int tri_splits(long long pairs) {
  const long long want = (kTriMinBlocks + pairs - 1) / pairs;
  return static_cast<unsigned int>(
      want < 1 ? 1 : (want > MicroTri<MM>::kChunks ? MicroTri<MM>::kChunks
                                                    : want));
}

}  // namespace svgd
