// The upper-triangle sweep's body past kMaxM (m > 64), shared by the wide
// kernels of K15 (phi_rbf.cu, its bfloat16 instance at any m too) and the
// panels' wide instances (fused_phi_panel.cu). The float32 triangle
// kernels (K2/K4, K8-K11) and K14's term groups run wide_tri_sm90.cuh's
// body past kMaxM instead, and K2's and K3's bfloat16 instances
// bf16_tri_sm90.cuh's at any m. The bodies
// below it hold a row of m coordinates, scores and sums in registers
// (micro_tile.cuh, counts_sym.cuh, terms_sym.cuh); past m = 64 they would
// spill, so this one holds nothing sized by m and runs on the tensor
// cores.
//
// One block (4 warps) works through one tile pair (I, J) of kWideTile = 64
// particles a side, the block's WideSpot: for the triangle kernels tile
// t0 + blockIdx.x of the upper triangle's linear tile list (t0 = 0 for the
// whole triangle, a rank's first tile for a chunk; tri_spot), for the
// panel kernels a tile pair of one panel (fused_phi_panel.cu's
// panel_spot). The spot also says where each direction flushes.
//
//   1. Gram tile G = X_I X_J^T (64 x 64; warp w rows 16w..16w+15 of I
//      against the 64 columns of J) in 3xTF32 mma.sync m16n8k8 over slices
//      of kWideK coordinates, each slice of both tiles staged as TF32 pairs
//      in shared memory;
//   2. sq = max(0, |x_i|^2 + |x_j|^2 - 2 G) (the self pair pinned to 0, as
//      the plain version pins it; WideForm below gives K15's forms), the
//      pair's weights and its counts, ONCE a pair, into shared memory as
//      TF32 pairs: W (k_c) and, for terms, a second tile (w). On the
//      diagonal tile only j >= i is kept (the self pair included), the rest
//      gets weight 0 and no count;
//   3. the row sums of the D weight over J and its column sums over I;
//   4. both contractions on the tensor cores, 64 columns of the operands
//      at a time (the scores' columns with k_c, then the coordinates' with
//      w): row i of I takes W [S_J | X_J], column j of J takes
//      W^T [S_I | X_I], W^T reaching the A operand by reading W's shared
//      tile transposed. D comes from the sums: D_i += rowsum_i x_i - (W X_J)_i,
//      D_j += colsum_j x_j - (W^T X_I)_j, as the plain version forms it at
//      these widths (ops/phi._pair_block);
//   5. each chunk is flushed with float32 atomics into the spot's zeroed
//      [KS | D] planes, the (2m, n) accumulator for the triangles, as the
//      narrower bodies flush.
//
// The conventions are the narrower bodies': each self pair enters both
// directions (k = 1 exactly: the wrapper subtracts s_i once), D is
// unscaled for one RBF (the wrapper multiplies it by 2 gamma) and weighted
// by w for terms, and the counts receive U, the upper count with the
// diagonal (the wrapper forms 2U - n). kT = 0 (with T = 0) counts nothing;
// T = 0 with kT > 0 counts nothing either.
//
// Shared memory (dynamic): 9216 floats for the Gram slices or the
// contraction's records, 8704 for each weight tile, 256 for norms and
// sums: 72.7 KB for one RBF, 107.5 KB for terms, at any m. Registers: the
// warp's 16 x 64 Gram values (64 a thread) during the Gram tile, 32
// accumulators during a contraction.
//
// kBf16 (the bfloat16 opt-in: K15's bf16 instance, at any m; K2's and
// K3's ran it until bf16_tri_sm90.cuh, and chip_profile.py --bf16 still
// times it as their parent design): the Gram operands, the weights and the
// contraction's records
// rounded to bf16, each product one TF32 pass (square_mma.cuh,
// operand_split and mma_pass); the norms stay those of the float32
// coordinates (or the caller's q), the self pair is pinned as above, and
// D_i = rowsum_i x_i - (W X_J)_i takes the float32 x_i beside the rounded
// X_J, as the JAX kernels' epilogue forms rowsum x - KX from the float32
// coordinates (pallas_phi.py:636-640, :707, :956-960).
//
// kAsym (with kBf16: K15's bf16 instance): bf16(x_i) . bf16(y_j) is not
// bf16(x_j) . bf16(y_i), as x_i^T (P_sym/2) x_j is in float32, so one
// weight tile cannot serve both directions: the rows of I take the JAX
// kernel's k(i <- j) from G = X_I Y_J^T and the columns of J k(j <- i)
// from G' = Y_I X_J^T, a second Gram tile (in the registers and the
// shared slices that 3xTF32's small parts take otherwise) and a second
// weight tile (107.5 KB).

#pragma once

#include "micro_tile.cuh"
#include "square_mma.cuh"

namespace svgd {

constexpr int kWideTriThreads = 128;        // 4 warps of 16 rows
constexpr int kWideLdW = kWideTile + 4;     // weight tiles' stride
constexpr int kWideTriCols = 64;            // operand columns of a chunk
constexpr int kWideTriLdR = kWideTriCols + 4;

struct WideTri {
  // floats: the union of the Gram slices ([2 tiles][64][kWideLdK], big and
  // small) and the records ([64][kWideTriLdR], big and small)
  static constexpr int kSlices = 4 * kWideTile * kWideLdK;
  static constexpr int kRecords = 2 * kWideTile * kWideTriLdR;
  static constexpr int kUnion = kSlices > kRecords ? kSlices : kRecords;
  static constexpr int kWeight = 2 * kWideTile * kWideLdW;  // big, small
  static constexpr int kSums = 4 * kWideTile;  // norms and sums of I, J

  static constexpr size_t smem_bytes(int weights) {
    return sizeof(float) * (kUnion + weights * kWeight + kSums);
  }
};

// The Gram tile's operands and the form of sq. The default is the
// Euclidean form: G = X_I X_J^T, the norms |x|^2 of the coordinates, sq
// clamped at 0. K15's fixed-P form (the JAX kernel's, pallas_phi.py:116)
// pairs X_I with Y_J, the rows of Y = X_c (P_sym/2), so G_ij = x_i^T
// (P_sym/2) x_j = G_ji and one weight tile serves both directions; its norms
// are q_i = x_i . y_i, so sq = q_i + q_j - 2 G = d^T P d, clamped only for a
// P taken as positive semidefinite. The contraction takes the coordinates
// either way. `phi` false leaves the contraction out (no kernel of the
// library sets it since K14's groups left this body; chip_profile.py
// --aniso-wide builds their earlier kernel, whose Euclidean group with no
// isotropic term only counted, against it). `pin` false (K15's bf16
// instance) forms the self pair's sq like any other pair's and halves its
// weights, exactly, so that it enters once over both directions: the
// square sweep's self pair, as the JAX kernel forms it (there the bf16
// Gram moves it off 0 visibly); the triangles pin it to sq = 0 and their
// wrappers take its second entry out.
struct WideForm {
  const float* y = nullptr;  // J's Gram operand (null: the coordinates)
  const float* q = nullptr;  // the norms (null: |x|^2 of the coordinates)
  bool clamp = true;         // sq = max(sq, 0)
  bool phi = true;           // the contraction and its flush
  bool pin = true;           // the self pair's sq = 0
};

// A block's tile pair and where it flushes: the first particles i0 of I's
// tile and j0 of J's; whether the pair lies on the diagonal (j >= i only,
// the self pair pinned to 0); and, for each direction (0: the rows of I,
// 1: the columns of J), the [KS | D] planes it adds to, 2m rows of ld
// floats whose column 0 is particle base.
struct WideSpot {
  int i0, j0;
  bool diag;
  float* out0;
  float* out1;
  int base0, base1;
  int ld;
};

// The triangles' spot: tile pair t of the upper triangle of nb tiles, both
// directions into the (2m, n) accumulator.
__device__ __forceinline__ WideSpot tri_spot(long long t, int nb, int n,
                                             float* acc) {
  int bi, bj;
  decode_upper_pair(t, nb, &bi, &bj);
  return WideSpot{bi * kWideTile, bj * kWideTile, bi == bj, acc, acc, 0, 0,
                  n};
}

// The body (see the top of the file) on the block's tile pair ``spot``.
// kT thresholds (3, or kMaxT for a runtime T, or 0 for none);
// weights(sq, k_c, w) the pair's weights: one tile of them where W is
// OneRbf (k_c = w), two otherwise. Composed kernels' constants in shared
// memory (AnyTerms) must be stored before the call: the body's first
// barrier comes before its first pair.
template <int kT, bool kBf16, bool kAsym, class W>
__device__ __forceinline__ void wide_pair_body(
    const float* __restrict__ coords, const float* __restrict__ scores,
    const W& weights, const float* __restrict__ thr, int n, int m, int T,
    const WideSpot& spot, unsigned long long* __restrict__ counts,
    const WideForm& form) {
  static_assert(!kAsym || (kBf16 && !kTwoBands<W>),
                "the second Gram tile takes the small parts' room");
  constexpr int NW = kTwoBands<W> || kAsym ? 2 : 1;
  constexpr int S = kWideTile;
  extern __shared__ __align__(16) float sh[];
  float* un = sh;                              // slices or records
  float* wt = sh + WideTri::kUnion;            // [NW][big | small][S][LdW]
  float* norm = wt + NW * WideTri::kWeight;    // [I | J]
  float* sums = norm + 2 * S;                  // [rows of I | columns of J]

  const int i0 = spot.i0;
  const int j0 = spot.j0;
  const bool diag = spot.diag;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  float th[kT > 0 ? kT : 1];
#pragma unroll
  for (int q = 0; q < kT; ++q) th[q] = thr[q < T ? q : 0];

  // The norms of the 64 + 64 particles: the caller's, or the squared
  // norms, 4 threads each.
  if (form.q != nullptr) {
    for (int p = tid; p < 2 * S; p += kWideTriThreads) {
      const int part = p < S ? i0 + p : j0 + p - S;
      norm[p] = part < n ? form.q[part] : 0.0f;
    }
  } else {
    for (int e = tid; e < 2 * S * 4; e += kWideTriThreads) {
      const int p = e >> 2;
      const int part = p < S ? i0 + p : j0 + p - S;
      float q = 0.0f;
      if (part < n) {
        for (int k = e & 3; k < m; k += 4) {
          const float v = coords[static_cast<size_t>(part) * m + k];
          q = fmaf(v, v, q);
        }
      }
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      if ((e & 3) == 0) norm[p] = q;
    }
  }
  const float* gram_j = form.y != nullptr ? form.y : coords;

  // 1. The Gram tile: slices [I | J][64][kWideLdK], big then small (under
  // kAsym G's operands X_I, Y_J, then G''s, Y_I, X_J).
  float gb[8][4];
  float gs[8][4];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      gb[c][q] = 0.0f;
      gs[c][q] = 0.0f;
    }
  }
  constexpr int kTileK = S * kWideLdK;      // floats of one tile's slice
  float* sl_big = un;
  float* sl_small = un + 2 * kTileK;
#pragma unroll 1
  for (int k0 = 0; k0 < m; k0 += kWideK) {
    const int kn = min(kWideK, m - k0);
    __syncthreads();  // the union is free
    for (int e = tid; e < 2 * S * kWideK; e += kWideTriThreads) {
      const int r = e / kWideK;  // 0..127: I's rows, then J's
      const int k = e - r * kWideK;
      const int part = r < S ? i0 + r : j0 + r - S;
      const float* src = r < S ? coords : gram_j;
      const bool in = part < n && k < kn;
      const size_t at = static_cast<size_t>(part) * m + k0 + k;
      const float v = in ? src[at] : 0.0f;
      uint32_t hi, lo;
      operand_split<kBf16>(v, hi, lo);
      if constexpr (kAsym) {
        const float* other = r < S ? gram_j : coords;
        lo = __float_as_uint(bf16_round(in ? other[at] : 0.0f));
      }
      sl_big[r * kWideLdK + k] = __uint_as_float(hi);
      sl_small[r * kWideLdK + k] = __uint_as_float(lo);
    }
    __syncthreads();  // the slices are complete
#pragma unroll
    for (int ks = 0; ks < kWideK / 8; ++ks) {
      if (8 * ks < kn) {
        const int ar = (16 * warp + g) * kWideLdK + 8 * ks + t;
        const uint32_t ab[4] = {
            __float_as_uint(sl_big[ar]),
            __float_as_uint(sl_big[ar + 8 * kWideLdK]),
            __float_as_uint(sl_big[ar + 4]),
            __float_as_uint(sl_big[ar + 8 * kWideLdK + 4])};
        const uint32_t as[4] = {
            __float_as_uint(sl_small[ar]),
            __float_as_uint(sl_small[ar + 8 * kWideLdK]),
            __float_as_uint(sl_small[ar + 4]),
            __float_as_uint(sl_small[ar + 8 * kWideLdK + 4])};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int br = kTileK + (8 * c + g) * kWideLdK + 8 * ks + t;
          const uint32_t bb0 = __float_as_uint(sl_big[br]);
          const uint32_t bb1 = __float_as_uint(sl_big[br + 4]);
          if constexpr (kAsym) {
            mma_tf32(gs[c], as, __float_as_uint(sl_small[br]),
                     __float_as_uint(sl_small[br + 4]));
          } else if constexpr (!kBf16) {
            mma_tf32(gs[c], as, bb0, bb1);
            mma_tf32(gs[c], ab, __float_as_uint(sl_small[br]),
                     __float_as_uint(sl_small[br + 4]));
          }
          mma_tf32(gb[c], ab, bb0, bb1);
        }
      }
    }
  }

  // 2. sq, the weights and the counts, once a pair; the weights into the
  // tiles W[il][jl] (row il of I, column jl of J).
  unsigned int cnt[kMaxT];
#pragma unroll
  for (int q = 0; q < kMaxT; ++q) cnt[q] = 0u;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int il = 16 * warp + g + (q >> 1) * 8;
      const int jl = 8 * c + 2 * t + (q & 1);
      const bool ok = i0 + il < n && j0 + jl < n && (!diag || jl >= il);
      const float nij = __fadd_rn(norm[il], norm[S + jl]);
      float sq = kAsym ? __fsub_rn(nij, 2.0f * gb[c][q])
                       : __fsub_rn(nij, 2.0f * (gb[c][q] + gs[c][q]));
      if (form.clamp) sq = fmaxf(sq, 0.0f);
      const bool self = diag && il == jl;
      if (self && form.pin) sq = 0.0f;
      // The unpinned self pair's weights enter each direction at half.
      const float half = self && !form.pin ? 0.5f : 1.0f;
      float a, b;
      weights(sq, a, b);
      if constexpr (kAsym) {  // the columns' weight, k(j <- i), from G'
        float sq2 = __fsub_rn(nij, 2.0f * gs[c][q]);
        if (form.clamp) sq2 = fmaxf(sq2, 0.0f);
        float a2;
        weights(sq2, b, a2);
      }
      count_pair_fixed<kT, true>(sq, th, ok, cnt);
      uint32_t hi, lo;
      operand_split<kBf16>(ok ? a : 0.0f, hi, lo);
      wt[il * kWideLdW + jl] = half * __uint_as_float(hi);
      wt[S * kWideLdW + il * kWideLdW + jl] = half * __uint_as_float(lo);
      if constexpr (NW == 2) {
        float* w1 = wt + WideTri::kWeight;
        operand_split<kBf16>(ok ? b : 0.0f, hi, lo);
        w1[il * kWideLdW + jl] = half * __uint_as_float(hi);
        w1[S * kWideLdW + il * kWideLdW + jl] = half * __uint_as_float(lo);
      }
    }
  }
  flush_counts(cnt, T, counts);
  if (!form.phi) return;  // uniform over the block: no barrier is skipped
  __syncthreads();        // the weight tiles are complete

  // 3. The D weight's row sums (threads 0-63, row tid of I) and column sums
  // (threads 64-127, column tid - 64 of J), from its TF32 pairs (under
  // kAsym the rows' from the first tile, the columns' from the second).
  {
    const float* wd_big =
        wt + (kAsym ? (tid < S ? 0 : 1) : NW - 1) * WideTri::kWeight;
    const float* wd_small = wd_big + S * kWideLdW;
    const int p = tid & (S - 1);
    float sum = 0.0f;
    for (int s = 0; s < S; ++s) {
      // Rows walk their columns rotated by p, so that the 32 lanes of a
      // warp read 32 distinct banks.
      const int at = tid < S ? p * kWideLdW + ((s + p) & (S - 1))
                             : s * kWideLdW + p;
      sum += wd_big[at] + wd_small[at];
    }
    sums[tid] = sum;
  }

  // 4-5. The contractions, chunk by chunk: the scores' columns c0 .. c0 +
  // 63 with k_c, then the coordinates' with w.
  const int nch = (m + kWideTriCols - 1) / kWideTriCols;
  float* rec_big = un;
  float* rec_small = un + S * kWideTriLdR;
#pragma unroll 1
  for (int ch = 0; ch < 2 * nch; ++ch) {
    const bool xband = ch >= nch;
    const int c0 = (xband ? ch - nch : ch) * kWideTriCols;
    const int cn = min(kWideTriCols, m - c0);
    const float* src = xband ? coords : scores;
#pragma unroll 1
    for (int dir = 0; dir < 2; ++dir) {
      const int tile = kAsym ? dir : (xband ? NW - 1 : 0);
      const float* w_big = wt + tile * WideTri::kWeight;
      const float* w_small = w_big + S * kWideLdW;
      // dir 0: the rows of I take W [S_J | X_J]; dir 1: the columns of J
      // take W^T [S_I | X_I].
      const int p0 = dir == 0 ? j0 : i0;  // the operand tile
      const int o0 = dir == 0 ? i0 : j0;  // the output tile
      __syncthreads();  // the union is free (and the sums are stored)
      for (int e = tid; e < S * kWideTriCols; e += kWideTriThreads) {
        const int p = e / kWideTriCols;
        const int c = e - p * kWideTriCols;
        const float v = p0 + p < n && c < cn
                            ? src[static_cast<size_t>(p0 + p) * m + c0 + c]
                            : 0.0f;
        uint32_t hi, lo;
        operand_split<kBf16>(v, hi, lo);
        rec_big[p * kWideTriLdR + c] = __uint_as_float(hi);
        rec_small[p * kWideTriLdR + c] = __uint_as_float(lo);
      }
      __syncthreads();  // the records are complete
      float out[8][4];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
#pragma unroll
        for (int q = 0; q < 4; ++q) out[b][q] = 0.0f;
      }
#pragma unroll
      for (int ks = 0; ks < S / 8; ++ks) {
        // A: rows 16 warp + g (+ 8) of W (dir 0) or of W^T (dir 1),
        // columns 8 ks + t (+ 4).
        const int ra = 16 * warp + g;
        const int ka = 8 * ks + t;
        int at[4];
        if (dir == 0) {
          at[0] = ra * kWideLdW + ka;
          at[1] = (ra + 8) * kWideLdW + ka;
          at[2] = ra * kWideLdW + ka + 4;
          at[3] = (ra + 8) * kWideLdW + ka + 4;
        } else {
          at[0] = ka * kWideLdW + ra;
          at[1] = ka * kWideLdW + ra + 8;
          at[2] = (ka + 4) * kWideLdW + ra;
          at[3] = (ka + 4) * kWideLdW + ra + 8;
        }
        uint32_t ab[4], as[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ab[q] = __float_as_uint(w_big[at[q]]);
          as[q] = __float_as_uint(w_small[at[q]]);
        }
        const int bk = ka * kWideTriLdR + g;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (8 * b < cn) {
            mma_pass<kBf16>(out[b], ab, as, rec_big, rec_small, bk + 8 * b,
                            bk + 4 * kWideTriLdR + 8 * b);
          }
        }
      }
      // Flush: row (dir 0) or column (dir 1) o0 + ol, operand column
      // c0 + cl, into KS (scores) or D = sum x - W X (coordinates), at the
      // spot's planes of that direction.
      float* dst = dir == 0 ? spot.out0 : spot.out1;
      const int base = dir == 0 ? spot.base0 : spot.base1;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ol = 16 * warp + g + (q >> 1) * 8;
          const int cl = 8 * b + 2 * t + (q & 1);
          const int o = o0 + ol;
          if (o < n && cl < cn) {
            const int k = c0 + cl;
            if (xband) {
              const float x = coords[static_cast<size_t>(o) * m + k];
              atomicAdd(
                  dst + static_cast<size_t>(m + k) * spot.ld + (o - base),
                  fmaf(sums[dir * S + ol], x, -out[b][q]));
            } else {
              atomicAdd(dst + static_cast<size_t>(k) * spot.ld + (o - base),
                        out[b][q]);
            }
          }
        }
      }
    }
  }
}

// The triangle sweeps' body: tile t0 + blockIdx.x of the upper triangle of
// nb tiles, into the (2m, n) accumulator acc (see wide_pair_body).
template <int kT, bool kBf16 = false, bool kAsym = false, class W>
__device__ __forceinline__ void wide_tri_body(
    const float* __restrict__ coords, const float* __restrict__ scores,
    const W& weights, const float* __restrict__ thr, int n, int m, int T,
    int nb, long long t0, float* __restrict__ acc,
    unsigned long long* __restrict__ counts, const WideForm& form = {}) {
  wide_pair_body<kT, kBf16, kAsym>(
      coords, scores, weights, thr, n, m, T,
      tri_spot(t0 + static_cast<long long>(blockIdx.x), nb, n, acc), counts,
      form);
}

// Allow a kernel on the wide body with `weights` weight tiles its dynamic
// shared memory, where that passes the default 48 KB. A refusal also fails
// the launch, which the entry's cudaGetLastError() reports.
template <class Kernel>
inline cudaError_t wide_tri_prepare(Kernel* kernel, int weights) {
  const size_t smem = WideTri::smem_bytes(weights);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace svgd
