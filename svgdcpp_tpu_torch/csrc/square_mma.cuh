// The square/cross sweep's bodies, shared by K1's port
// (fused_phi_counts_square, fused_phi.cu: one RBF) and K6/K7's
// (fused_phi_terms_square, fused_phi_terms.cu: a signed sum of isotropic
// RBF terms). Both compute, for n_t targets against n_s sources,
//
//   KS_i = sum_j k_c s_j,   D_i = sum_j w (x_i - x_j),   counts of sq <= thr,
//
// with the pair's weights from a policy (sweep_common.cuh): OneRbf (k_c = w
// = 2^(-gamma log2(e) sq), D scaled by 2 gamma in the finishing pass), or
// FixedTerms<2> / AnyTerms (k_c = sum_t s_t k_t, w = sum_t s_t gamma_t k_t,
// D scaled by 2). They replace the TPU's _fused_kernel (K1) and
// _fused_terms_direct_kernel / _fused_terms_kernel (K6, K7) in
// svgdcpp_tpu/ops/pallas_phi.py.
//
// Bound on this card: per ordered pair 3m FP32 operations for sq, one ex2
// a term, 4m for the two contractions and T compares; the operands are a
// few hundred KB, so the function is bound by its operations. The TPU
// sweeps its grid in order on one core; here a launch must fill 132 SMs
// from about 10^6 pairs (n = 1000-1500), and a row a thread holding 3m
// floats (the first bodies of both kernels) neither fills the card (12
// blocks at n = 1500) nor uses its tensor cores.
//
// Launch plan (square_chunk). The grid is (target blocks, source splits):
// a block sweeps its targets against one split (a range of whole
// kSquareGrain-source tiles, about kSquareBlocks blocks in all), writes its
// partial sums to its slice of the workspace (splits, n_t, 2m + 1) and adds
// its counts with integer atomics. The finishing pass (square_finish) sums
// each row's splits in split order, so phi carries no float atomics and is
// the same from run to run. svgd_square_splits exports the split count
// (ops/sym_plan.square_splits mirrors it); K1 and the terms kernel share
// the rule.
//
// Bodies, by width (kSquareTensorMinM; measured crossings in PERF.md):
//
//   * m <= 4, square_cuda_body (CUDA cores): one thread owns one target row
//     and keeps KS, D (2m values) and its T counts in registers; a block of
//     kSqThreads targets walks its split in shared-memory tiles. sq and D
//     come from differences in the plain version's order, so the counts
//     equal the plain version's. Partials [KS | D].
//   * m >= 5, square_mma_body (tensor cores): a block of kSqMmaWarps warps
//     owns kSqMmaRows = 64 target rows, 16 a warp. Per tile of 32 sources:
//
//       1. the tile's coordinates and scores arrive in shared memory by
//          cp.async, a tile ahead (double-buffered raw copies);
//       2. the block splits them into operand records, every value a TF32
//          pair (big = tf32(v), small = tf32(v - big)), and the sources'
//          squared norms;
//       3. per group of 8 sources each warp forms the Gram tile
//          G = X_t X_s^T (16 x 8) with mma.sync m16n8k8 in 3xTF32 (big*big +
//          big*small + small*big: float32-level products, never plain
//          TF32), sq = max(0, |x_i|^2 + |x_j|^2 - 2 G) and the weights on
//          the CUDA cores, counts sq against the thresholds once, and adds
//          the weights times the records into its accumulator fragments,
//          again in 3xTF32. The Gram tile's fragment (columns 2t, 2t+1 of
//          thread t of a quad) is the product's A fragment (columns t,
//          t+4) once the 8 sources are taken in the order 0, 2, 4, 6, 1, 3,
//          5, 7, so the weights never leave registers; the B fragment reads
//          the records in the same order.
//
//     One RBF has one weight: one A fragment and the packed record
//     [S | X | 1 | 0..] (K . [S | X | 1], ceil((2m + 1)/8) column blocks).
//     Terms have two: k_c feeds the scores and w the coordinates, and a
//     packed block (columns 8-15 hold both S and X at m = 11) could take
//     only one of them, so the record is two bands, [S | 0..] (ceil(m/8)
//     blocks, A = k_c) and [X | 1 | 0..] (ceil((m + 1)/8) blocks, A = w).
//     Partials [KS | KX | rowsum] or [KS | WX | rowsum_w]: the finishing
//     pass forms D = rowsum x_i - KX, as the plain version does at these
//     widths (ops/phi.phi_rbf_terms_cross_fused_counts): with the Gram sq
//     and the 3xTF32 products both agree with it at float32 level. On
//     grid inputs (multiples of 1/8) every product and sum is exact, so the
//     counts equal the plain version's.
//
//     The accumulators stay in MMA fragments, 4 floats a thread per 8
//     columns, the target rows in A fragments (TF32 pairs), so no thread
//     holds the 3m floats of a row.
//   * m > 64 (kMaxM), square_wide_sm90.cuh's square_wide_sm90_body: the
//     same arithmetic laid out for Hopper, with a launch plan of its own
//     (square_plan_chunk). K1's bfloat16 instance runs its own body at
//     every m (square_bf16_sm90.cuh), with this file's finishing pass.
//
// The body copies sources and scores 16 bytes at a time: both must start
// on a 16-byte boundary (the C entries refuse others).

#pragma once

#include <type_traits>

#include "sweep_common.cuh"

namespace svgd {

// ---------------------------------------------------------------------------
// Launch plan
// ---------------------------------------------------------------------------

constexpr int kSqMmaWarps = 4;
constexpr int kSqMmaThreads = 32 * kSqMmaWarps;
constexpr int kSqMmaRows = 16 * kSqMmaWarps;  // target rows a block
constexpr int kSqMmaCols = 32;                // sources a tile

// Blocks a square launch aims at: two an SM of the card's 132.
constexpr int kSquareBlocks = 264;
// Sources a split holds are a multiple of this: whole tiles of the
// tensor-core body.
constexpr int kSquareGrain = kSqMmaCols;
// The least m that the tensor-core body serves; the CUDA-core body takes
// the m below it. K1 at n = 1000 on an H100 80GB HBM3 (700 W): the tensor
// cores took 11.4-11.5 us a call at m = 8 against the CUDA cores'
// 16.0-16.1, 10.6-10.8 against 9.0-9.4 at m = 2 and tied at m = 4; the
// terms kernel's crossing at n = 1500 is in PERF.md (each body timed with
// this constant forced, chip_profile.py --square-crossover --forced).
// m <= 4 keeps the difference form, whose counts equal the plain
// version's.
constexpr int kSquareTensorMinM = 5;

// The sources of one split (a multiple of kSquareGrain) and the number of
// splits, for n_t targets in blocks of the body's rows.
inline int square_chunk(int n_t, int n_s, bool tensor, int* splits) {
  const int rows = tensor ? kSqMmaRows : kSqThreads;
  const int row_blocks = (n_t + rows - 1) / rows;
  const int grains = (n_s + kSquareGrain - 1) / kSquareGrain;
  const int want = (kSquareBlocks + row_blocks - 1) / row_blocks;
  const int parts = grains < want ? grains : want;
  const int chunk = kSquareGrain * ((grains + parts - 1) / parts);
  *splits = (n_s + chunk - 1) / chunk;
  return chunk;
}

// The SMs whose waves the wide and bf16 bodies' split rules fill: the
// H100's.
constexpr int kSquareWaveSms = 132;

// The tiles one split of such a launch sweeps, of `tiles` source tiles, and
// the split count: the count that minimises the waves of bps x
// kSquareWaveSms blocks (`blocks` a split: target blocks x passes; bps
// blocks an SM) times the tiles an SM's bps blocks sweep plus one each (a
// block's fixed cost: its targets, its partials), the fewest splits among
// equals. ops/sym_plan.square_wave_tiles mirrors it.
inline int square_wave_tiles(long long blocks, int tiles, int bps,
                             int* splits) {
  const long long slots = static_cast<long long>(kSquareWaveSms) * bps;
  const int most = tiles < kSquareWaveSms ? tiles : kSquareWaveSms;
  long long best = -1;
  int best_ct = tiles;
  int best_sp = 1;
  for (int s = 1; s <= most; ++s) {
    const int ct = (tiles + s - 1) / s;
    const int sp = (tiles + ct - 1) / ct;
    if (sp != s) continue;  // the plan of a smaller s
    const long long est = (blocks * sp + slots - 1) / slots * bps * (ct + 1);
    if (best < 0 || est < best) {
      best = est;
      best_ct = ct;
      best_sp = sp;
    }
  }
  *splits = best_sp;
  return best_ct;
}

// ---------------------------------------------------------------------------
// The CUDA-core body (m <= 4)
// ---------------------------------------------------------------------------

// Exactly MM coordinates; weights(sq, k_c, w) gives the pair's weights.
// work: the whole (splits, n_t, 2m + 1) workspace, this block's split
// blockIdx.y; its rows take [KS | D] (the last column unused).
template <int MM, class W>
__device__ __forceinline__ void square_cuda_body(
    const float* __restrict__ targets, const float* __restrict__ sources,
    const float* __restrict__ scores, const W& weights,
    const float* __restrict__ thr, int n_t, int n_s, int T, int chunk,
    float* __restrict__ work, unsigned long long* __restrict__ counts) {
  constexpr int kTile = SqTile<MM>::value;
  constexpr int m = MM;
  __shared__ float sh_x[kTile * MM];
  __shared__ float sh_s[kTile * MM];

  const int i = blockIdx.x * kSqThreads + threadIdx.x;
  const bool row_ok = i < n_t;

  float th[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) th[t] = (t < T) ? thr[t] : 0.0f;

  float xi[MM];
  float acc_s[MM];
  float acc_d[MM];
#pragma unroll
  for (int k = 0; k < MM; ++k) {
    xi[k] = row_ok ? targets[static_cast<size_t>(i) * m + k] : 0.0f;
    acc_s[k] = 0.0f;
    acc_d[k] = 0.0f;
  }
  unsigned int cnt[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) cnt[t] = 0u;

  const int j_begin = static_cast<int>(blockIdx.y) * chunk;
  const int j_end = min(n_s, j_begin + chunk);
  for (int j0 = j_begin; j0 < j_end; j0 += kTile) {
    const int tile_n = min(kTile, j_end - j0);
    __syncthreads();  // the previous tile is consumed (and terms loaded)
    for (int e = threadIdx.x; e < tile_n * m; e += kSqThreads) {
      sh_x[e] = sources[static_cast<size_t>(j0) * m + e];
      sh_s[e] = scores[static_cast<size_t>(j0) * m + e];
    }
    __syncthreads();
    if (row_ok) {
      for (int jj = 0; jj < tile_n; ++jj) {
        const float* xj = sh_x + jj * m;
        const float* sj = sh_s + jj * m;
        const float sq = pair_sq<MM, true>(xi, xj, m);
        float kc, w;
        weights(sq, kc, w);
#pragma unroll
        for (int k = 0; k < MM; ++k) {
          acc_s[k] = fmaf(kc, sj[k], acc_s[k]);
          acc_d[k] = fmaf(w, __fsub_rn(xi[k], xj[k]), acc_d[k]);
        }
        count_pair(sq, th, T, cnt);
      }
    }
  }

  if (row_ok) {
    const int wd = 2 * m + 1;
    float* out = work + (static_cast<size_t>(blockIdx.y) * n_t + i) * wd;
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      out[k] = acc_s[k];
      out[m + k] = acc_d[k];
    }
  }
  flush_counts(cnt, T, counts);
}

// ---------------------------------------------------------------------------
// The tensor-core body (m >= 5)
// ---------------------------------------------------------------------------

// Whether a weight policy gives two weights a pair (k_c != w: the terms'
// two bands) or one (OneRbf: K1's packed record).
template <class W>
constexpr bool kTwoBands = !std::is_same<W, OneRbf>::value;

// The body's shape for width MM: KS k-steps of 8 coordinates for the Gram
// tile; NB blocks of 8 accumulator columns, NBS of them the scores' band
// where the weights come in two bands (kTwo), and XO, the first column of
// the coordinates' band there (K1 packs X right after S, at column m);
// operand records kLd floats apart (kLd = 4 mod 8: the B fragments' reads,
// rows g or 2t, 2t + 1 of a group, fall in distinct banks); and the dynamic
// shared memory: two raw tiles of coordinates and scores, the big and small
// records, and the sources' squared norms.
template <int MM, bool kTwo = false>
struct SqMma {
  static constexpr int KS = (MM + 7) / 8;
  static constexpr int NBS = (MM + 7) / 8;
  static constexpr int XO = 8 * NBS;
  static constexpr int NB =
      kTwo ? NBS + (MM + 1 + 7) / 8 : (2 * MM + 1 + 7) / 8;
  static constexpr int kLd = 8 * NB + 4;
  static constexpr int kRaw = kSqMmaCols * MM;  // floats of one raw array
  static constexpr int kRec = kSqMmaCols * kLd;  // floats of one record set
  static constexpr size_t kSmemBytes =
      sizeof(float) * (4 * kRaw + 2 * kRec + kSqMmaCols);
};

__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x = big + small to about 2^-22 of x: the 3xTF32 operand pair.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_of(x);
  small = tf32_of(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two small products first, then big * big.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const float* rec_big,
                                           const float* rec_small, int off0,
                                           int off1) {
  const uint32_t bb0 = __float_as_uint(rec_big[off0]);
  const uint32_t bb1 = __float_as_uint(rec_big[off1]);
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, __float_as_uint(rec_small[off0]),
           __float_as_uint(rec_small[off1]));
  mma_tf32(d, ab, bb0, bb1);
}

// A fragment of TF32 pairs from one weight a pair: (g, t) <- source 2t,
// (g, t + 4) <- source 2t + 1, rows g and g + 8 (v: the pairs (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)).
__device__ __forceinline__ void weight_fragment(const float (&v)[4],
                                                uint32_t (&big)[4],
                                                uint32_t (&small)[4]) {
  tf32_split(v[0], big[0], small[0]);
  tf32_split(v[2], big[1], small[1]);
  tf32_split(v[1], big[2], small[2]);
  tf32_split(v[3], big[3], small[3]);
}

// 16 bytes from global to shared memory, the bytes past `valid` (0-16)
// zero-filled; committed by the caller.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int valid) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// The raw copies of one tile: the kSqMmaCols sources from j0 on, m floats
// each, coordinates and scores (zero past n_s).
__device__ __forceinline__ void sq_mma_fetch(const float* __restrict__ sources,
                                             const float* __restrict__ scores,
                                             int n_s, int m, int j0,
                                             float* raw_x, float* raw_s) {
  const long long total = static_cast<long long>(n_s) * m;
  const long long base = static_cast<long long>(j0) * m;
  const int vecs = kSqMmaCols * m / 4;
  for (int v = threadIdx.x; v < vecs; v += kSqMmaThreads) {
    const long long at = base + 4LL * v;
    const long long left = total - at;
    const int valid = left >= 4 ? 16 : (left > 0 ? 4 * static_cast<int>(left)
                                                 : 0);
    const long long src = valid > 0 ? at : 0;
    cp_async16(raw_x + 4 * v, sources + src, valid);
    cp_async16(raw_s + 4 * v, scores + src, valid);
  }
}

// The block body (see the top of the file). part: this split's (n_t, W)
// slice of the workspace, W = 2m + 1; kT thresholds (3, or kMaxT for a
// runtime T padded with the first threshold); weights(sq, k_c, w) the
// pair's weights (one band where W is OneRbf, two otherwise). Composed
// kernels' constants in shared memory (AnyTerms) must be stored before the
// call: the body's first barrier comes before its first pair.
template <int MM, bool kExact, int kT, class W>
__device__ __forceinline__ void square_mma_body(
    const float* __restrict__ targets, const float* __restrict__ sources,
    const float* __restrict__ scores, const W& weights,
    const float* __restrict__ thr, int n_t, int n_s, int m_arg, int T,
    int chunk, float* __restrict__ part,
    unsigned long long* __restrict__ counts) {
  constexpr bool kTwo = kTwoBands<W>;
  using S = SqMma<MM, kTwo>;
  constexpr int KS = S::KS;
  constexpr int NB = S::NB;
  constexpr int NK = kTwo ? S::NBS : NB;  // blocks the first weight feeds
  constexpr int LD = S::kLd;
  extern __shared__ __align__(16) float sh[];
  float* raw = sh;                   // [2][x | s][kRaw]
  float* rec_big = sh + 4 * S::kRaw;
  float* rec_small = rec_big + S::kRec;
  float* norm_s = rec_small + S::kRec;

  const int m = kExact ? MM : m_arg;
  const int xo = kTwo ? S::XO : m;  // the record's column of x_0
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the fragment's row (and B's column)
  const int t = lane & 3;   // the thread in the quad
  const int j_begin = static_cast<int>(blockIdx.y) * chunk;
  const int j_end = min(n_s, j_begin + chunk);
  const int tiles = (j_end - j_begin + kSqMmaCols - 1) / kSqMmaCols;

  float th[kT];
#pragma unroll
  for (int q = 0; q < kT; ++q) th[q] = thr[q < T ? q : 0];

  // The warp's 16 target rows as A fragments of TF32 pairs, and their
  // squared norms (each thread holds 2 of every 8 coordinates of rows g
  // and g + 8; the quad sums the rest).
  const int r0 = static_cast<int>(blockIdx.x) * kSqMmaRows + 16 * warp + g;
  const bool ok0 = r0 < n_t;
  const bool ok1 = r0 + 8 < n_t;
  uint32_t a_big[KS][4];
  uint32_t a_small[KS][4];
  float nt0 = 0.0f;
  float nt1 = 0.0f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 8 * ks + t + 4 * h;
      const bool kin = k < m;
      const float v0 =
          ok0 && kin ? targets[static_cast<size_t>(r0) * m + k] : 0.0f;
      const float v1 =
          ok1 && kin ? targets[static_cast<size_t>(r0 + 8) * m + k] : 0.0f;
      nt0 = fmaf(v0, v0, nt0);
      nt1 = fmaf(v1, v1, nt1);
      tf32_split(v0, a_big[ks][2 * h], a_small[ks][2 * h]);
      tf32_split(v1, a_big[ks][2 * h + 1], a_small[ks][2 * h + 1]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    nt0 += __shfl_xor_sync(0xffffffffu, nt0, off);
    nt1 += __shfl_xor_sync(0xffffffffu, nt1, off);
  }

  float acc[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[b][q] = 0.0f;
  }
  unsigned int cnt[kMaxT];
#pragma unroll
  for (int q = 0; q < kMaxT; ++q) cnt[q] = 0u;

  // The records' constant columns: 1 right after x, zeros elsewhere.
  const int one = kTwo ? S::XO + m : 2 * m;
  for (int e = tid; e < kSqMmaCols * LD; e += kSqMmaThreads) {
    const int c = e % LD;
    rec_big[e] = c == one ? 1.0f : 0.0f;
    rec_small[e] = 0.0f;
  }

  if (tiles > 0) {
    sq_mma_fetch(sources, scores, n_s, m, j_begin, raw, raw + S::kRaw);
  }
  cp_async_commit();
  for (int c = 0; c < tiles; ++c) {
    const int j0 = j_begin + c * kSqMmaCols;
    float* rx = raw + (c & 1) * 2 * S::kRaw;
    if (c + 1 < tiles) {
      float* nx = raw + ((c + 1) & 1) * 2 * S::kRaw;
      sq_mma_fetch(sources, scores, n_s, m, j0 + kSqMmaCols, nx,
                   nx + S::kRaw);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile c has landed; the records are free
    const float* rs = rx + S::kRaw;
    for (int e = tid; e < kSqMmaCols * m; e += kSqMmaThreads) {
      const int j = e / m;
      const int k = e - j * m;
      uint32_t hi, lo;
      tf32_split(rs[e], hi, lo);
      rec_big[j * LD + k] = __uint_as_float(hi);
      rec_small[j * LD + k] = __uint_as_float(lo);
      tf32_split(rx[e], hi, lo);
      rec_big[j * LD + xo + k] = __uint_as_float(hi);
      rec_small[j * LD + xo + k] = __uint_as_float(lo);
    }
    {  // the sources' squared norms, 4 threads a source
      const int j = tid >> 2;
      float q = 0.0f;
      for (int k = tid & 3; k < m; k += 4) {
        const float v = rx[j * m + k];
        q = fmaf(v, v, q);
      }
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      if ((tid & 3) == 0) norm_s[j] = q;
    }
    __syncthreads();  // the records are complete

#pragma unroll 1
    for (int n0 = 0; n0 < kSqMmaCols; n0 += 8) {
      // Gram tile: B(k, n) = x_s[n0 + n][k] at record column xo + k; the
      // three products in three chains of KS steps, summed small first.
      float gbb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float gbs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float gsb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int bg = (n0 + g) * LD + xo + t;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t bb0 = __float_as_uint(rec_big[bg + 8 * ks]);
        const uint32_t bb1 = __float_as_uint(rec_big[bg + 8 * ks + 4]);
        mma_tf32(gsb, a_small[ks], bb0, bb1);
        mma_tf32(gbs, a_big[ks], __float_as_uint(rec_small[bg + 8 * ks]),
                 __float_as_uint(rec_small[bg + 8 * ks + 4]));
        mma_tf32(gbb, a_big[ks], bb0, bb1);
      }
      float gr[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) gr[q] = gbb[q] + (gbs[q] + gsb[q]);
      const int jl = n0 + 2 * t;  // sources jl, jl + 1 of the fragment
      const float ns0 = norm_s[jl];
      const float ns1 = norm_s[jl + 1];
      const bool c0 = j0 + jl < n_s;
      const bool c1 = j0 + jl + 1 < n_s;
      const float sq[4] = {
          fmaxf(__fsub_rn(__fadd_rn(nt0, ns0), 2.0f * gr[0]), 0.0f),
          fmaxf(__fsub_rn(__fadd_rn(nt0, ns1), 2.0f * gr[1]), 0.0f),
          fmaxf(__fsub_rn(__fadd_rn(nt1, ns0), 2.0f * gr[2]), 0.0f),
          fmaxf(__fsub_rn(__fadd_rn(nt1, ns1), 2.0f * gr[3]), 0.0f)};
      const bool ok[4] = {ok0 && c0, ok0 && c1, ok1 && c0, ok1 && c1};
      // The weights where the source is real, else 0. One weight: the call
      // in the taken branch, a predicated ex2 (K1's code before the terms
      // shared the body, instruction for instruction). Two: both weights,
      // then a select each, 62.25 SASS instructions a thread-pair at
      // m = 11 against 67.5 in the predicated form (PERF.md, section 6).
      float kc[4], kw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float a, b;
        if constexpr (kTwo) {
          weights(sq[q], a, b);
          const bool cq = q & 1 ? c1 : c0;
          kc[q] = cq ? a : 0.0f;
          kw[q] = cq ? b : 0.0f;
        } else {
          const bool cq = q & 1 ? c1 : c0;
          kc[q] = cq ? (weights(sq[q], a, b), a) : 0.0f;
        }
        count_pair_fixed<kT, true>(sq[q], th, ok[q], cnt);
      }
      // The first weight (k, or k_c) on its blocks, then w on the
      // coordinates' band.
      uint32_t k_big[4], k_small[4];
      weight_fragment(kc, k_big, k_small);
      const int bk = jl * LD + g;
#pragma unroll
      for (int b = 0; b < NK; ++b) {
        mma_3xtf32(acc[b], k_big, k_small, rec_big, rec_small, bk + 8 * b,
                   bk + LD + 8 * b);
      }
      if constexpr (kTwo) {
        uint32_t w_big[4], w_small[4];
        weight_fragment(kw, w_big, w_small);
#pragma unroll
        for (int b = NK; b < NB; ++b) {
          mma_3xtf32(acc[b], w_big, w_small, rec_big, rec_small, bk + 8 * b,
                     bk + LD + 8 * b);
        }
      }
    }
  }
  cp_async_wait<0>();

  // The split's partial [KS | KX | rowsum] of the warp's rows: accumulator
  // column c of K1's packed record is workspace column c; in two bands the
  // scores' columns c < m stay, the coordinates' band's column XO + k goes
  // to m + k (k <= m, the row sum last).
  const int wd = 2 * m + 1;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + (q >> 1) * 8;
      const int cr = 8 * b + 2 * t + (q & 1);
      int col = cr;
      bool keep = cr < wd;
      if constexpr (kTwo) {
        col = b < S::NBS ? cr : m + (cr - S::XO);
        keep = b < S::NBS ? cr < m : cr - S::XO <= m;
      }
      if (row < n_t && keep) {
        part[static_cast<size_t>(row) * wd + col] = acc[b][q];
      }
    }
  }
  flush_counts(cnt, T, counts);
}

// ---------------------------------------------------------------------------
// The finishing pass
// ---------------------------------------------------------------------------

// phi (n_t, m) from the splits' partials, summed in split order: element
// e < n_t m of phi, one a thread. rowsum: the tensor-core body's
// [KS | KX | rowsum], whose D = rowsum x_i - KX; else [KS | D]. dscale: 2
// gamma for one RBF, 2 for terms (w carries gamma).
__device__ __forceinline__ void square_finish(
    const float* __restrict__ work, int splits, int n_t, int m, int rowsum,
    float dscale, const float* __restrict__ targets, int n_s,
    float* __restrict__ phi) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(n_t) * m) return;
  const int i = static_cast<int>(e / m);
  const int k = static_cast<int>(e - static_cast<long long>(i) * m);
  const int w = 2 * m + 1;
  float ks = 0.0f;
  float d = 0.0f;
  float r = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float* row = work + (static_cast<size_t>(s) * n_t + i) * w;
    ks += row[k];
    d += row[m + k];
    if (rowsum) r += row[2 * m];
  }
  if (rowsum) d = fmaf(r, targets[e], -d);
  phi[e] = (ks + dscale * d) / static_cast<float>(n_s);
}

constexpr int kSqFinishThreads = 256;

}  // namespace svgd

// The CUDA-core instance that serves m < kSquareTensorMinM.
#define SVGD_DISPATCH_SQ_CUDA_CORES(m, LAUNCH)                          \
  switch (m) {                                                          \
    case 1: LAUNCH(1); break;                                           \
    case 2: LAUNCH(2); break;                                           \
    case 3: LAUNCH(3); break;                                           \
    case 4: LAUNCH(4); break;                                           \
    default: return static_cast<int>(cudaErrorInvalidValue);            \
  }

// The tensor-core instance that serves m >= kSquareTensorMinM: MM = 8 up to
// m = 8, the exact ones at m = 11 and 50, 16, 32, 64 up to kMaxM, and the
// wide one (MM = kWideMM, square_wide_sm90.cuh's body) past it.
#define SVGD_DISPATCH_SQ_MMA(m, LAUNCH)                                 \
  switch (m) {                                                          \
    case 11: LAUNCH(11, true); break;                                   \
    case 50: LAUNCH(50, true); break;                                   \
    default:                                                            \
      if (m >= svgd::kSquareTensorMinM && m <= 8) {                     \
        LAUNCH(8, false);                                               \
      } else if (m >= 9 && m <= 16) {                                   \
        LAUNCH(16, false);                                              \
      } else if (m >= 17 && m <= 32) {                                  \
        LAUNCH(32, false);                                              \
      } else if (m >= 33 && m <= svgd::kMaxM) {                         \
        LAUNCH(64, false);                                              \
      } else if (m > svgd::kMaxM) {                                     \
        LAUNCH(svgd::kWideMM, false);                                   \
      } else {                                                          \
        return static_cast<int>(cudaErrorInvalidValue);                 \
      }                                                                 \
  }
