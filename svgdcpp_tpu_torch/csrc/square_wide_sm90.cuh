// The square/cross sweep's float32 body past kMaxM (m > 64): K1's port
// (fused_phi_counts_square, fused_phi.cu: one RBF, square and cross forms,
// the TPU's _fused_kernel via _phi_rbf_fused_pallas_cross_impl) and K6/K7's
// (fused_phi_terms_square, fused_phi_terms.cu: FixedTerms<2> and AnyTerms,
// the TPU's _fused_terms_direct_kernel and _fused_terms_kernel), the
// instance MM = kWideMM of each. It computes what the body before it
// (square_wide_body, whose text chip_profile.py's SQUARE_WIDE_PARENT_SOURCE
// keeps) computed for them: each split's partial
// [KS | KX | rowsum] (one RBF: k on both bands; terms: k_c on the scores,
// w on the coordinates and the row sum), the counts of each pair once, no
// pinned self pair (the square form has none), then the finishing pass
// square_finish (D = rowsum x_i - KX with the float32 x_i, the splits
// summed in split order). K1's bfloat16 instance runs its own body
// (square_bf16_sm90.cuh).
//
// What bounds it. At (1000, 123) the work is 10^6 pairs: about 2.2 GFLOP of
// 3xTF32 products (the Gram tile m deep, the contraction 2m + 1 wide),
// microseconds at mma.sync's rate, so the launch's fixed costs and how the
// body keeps the tensor cores fed decide its time. square_wide_body
// re-staged its 64 target rows with every 32-source tile, synchronously, an
// element a thread through a rounded split; cut the 2m + 1 accumulator
// columns into 128-column chunks along the grid's z, each recomputing the
// Gram tile, the weights and the staging; and ran 512 blocks of 4 warps,
// two source tiles each. What bounds this body is instruction issue around
// the mma.sync's: every operand is loaded and split where its fragment is
// formed, and the copies are issued by the same threads, so the products
// themselves take about a third of the time at (10000, 123) (PERF.md
// section 6; chip_profile.py --square-wide-breakdown). This body:
//
//   * Stages the block's target rows once for its whole source range
//     (resident, R x lt floats), with the first stage's copies, and splits
//     them where a warp loads its fragment; their norms come from the same
//     loads.
//   * Brings the sources in through a cp.async ring of kSqWideStages
//     stages, kSqWideStages - 1 ahead: per tile of kSqWideTile = 64
//     sources, ceil(w / 64) Gram slices (the 64 sources' coordinates, 64
//     columns each), then record slabs of 16 sources (8 past 256 columns a
//     pass), each holding every column of the pass's record [S | 0.. | X |
//     0..]. Every thread issues its share of a stage's copies right after
//     the barrier that frees its slot, so nothing is staged synchronously
//     and no slot is single-buffered; a producer warp (wide_tri_sm90.cuh's
//     way) would be a seventeenth warp past the 16 a block of 512 threads
//     allows. The copies are 16 bytes: rows of w floats, w a multiple
//     of 4 on 16-byte boundaries (wide_rows_ok; the wrapper pads the rows
//     with zero columns to ops/sym_plan.wide_row_width(m), which add
//     nothing to sq, KS or KX, and cuts phi back to m columns).
//   * Forms the Gram tile R x 64 once a pair of tiles (16-row warp tiles),
//     sq, the weights and the counts once a pair into shared weight tiles
//     (k_c, and w for terms), then contracts every accumulator column from
//     them: 8 sources of a slab are one k-step, and each warp feeds its A
//     fragment of W (its 16 rows) to its 8 accumulator blocks, the warps of
//     a row group taking every ccg_count-th block. The accumulators of
//     every column stay in registers over the block's whole source range
//     (8 blocks of 16 x 8 a warp, 128 a block), so the block's rows R follow
//     the record's width: 64 up to 32 column blocks (m <= 128), 32 up to 64
//     (m <= 256), 16 up to 128 (m <= 512). Past that (no driver path
//     reaches it; chip_smoke.py phase 43a holds it at m = 600) the columns
//     are cut into passes of 128 blocks along the grid's z, each
//     recomputing the Gram tile, and the target rows stream with each Gram
//     slice instead of staying resident (sq_wide_plan's `streamed`), so
//     that any m fits.
//   * No mma.sync sits under a branch: under a runtime condition the
//     compiler fences each one (a WARPSYNC, NOPs and branches). The Gram
//     tile's block count is taken once a slice, a warp's contraction runs
//     all 8 blocks (those past its last read block 0's columns and are
//     never flushed), and terms pick each block's A fragment (k_c's or w's)
//     by a select: the guarded form takes 6-11% longer.
//   * 16 warps, one block an SM: 128 registers a thread, which warp tiles
//     of 32 rows (two A fragments a B fragment) do not fit. The row sums of
//     w and the counts go to shared memory once a tile (the quad's and the
//     warp's sums) and the thresholds live there, so that none holds a
//     register over the sweep; the Gram k-steps are rolled (unrolled by
//     two, K1's instances spill 4 bytes). No instance spills.
//   * Every operand is split into its 3xTF32 pair by split_tf32_rn (a
//     rounded big part, three integer and float instructions): the
//     truncation of wide_tri_sm90.cuh's split_tf32 is 2-7% faster but has
//     2.5x the error at (1000, 123) on grid inputs about 100.
//   * Conflict-free fragment loads: the slices and the resident targets
//     are kSqWideSliceLd = 68 / lt floats a row (4 mod 32: rows g, columns
//     t read banks 4g + t), the weight tiles kSqWideWLd = 68 (4 mod 32),
//     the record slabs ldr (8 or 24 mod 32: rows t, columns g read banks
//     8t + g or 24t + g); the weights' stores take two ways.
//   * The launch plan is sized to the card: the grid (target blocks,
//     splits, passes), the split count chosen to fill whole waves of
//     kSquareWaveSms blocks (sq_wide_chunk): at (1000, 123) 16 x 8 = 128
//     blocks of two tiles, at (1500, 124) 24 x 5 of five. The workspace is
//     half the parent's there.
//
// 3xTF32 for the Gram tile and the contraction (never plain TF32); no float
// atomics (the workspace's partials are summed in split order by the
// finishing pass, and the row sums in a fixed order, so phi is the same
// from run to run); integer atomics for the counts, one a threshold a
// block. On grid inputs (multiples of 1/8) every product and sum is exact,
// so the counts equal the float64 plain version's.

#pragma once

#include "square_mma.cuh"
#include "wide_tri_sm90.cuh"

namespace svgd {

constexpr int kSqWideTile = 64;     // sources a tile: the split grain
constexpr int kSqWideSlice = 64;    // coordinates of a Gram slice
constexpr int kSqWideSliceLd = 68;  // slice rows' stride (4 mod 32)
constexpr int kSqWideWLd = 68;      // weight tiles' stride (4 mod 32)
constexpr int kSqWideStages = 4;    // the ring's stages (a power of 2)
constexpr int kSqWideWarps = 16;
constexpr int kSqWideThreads = 32 * kSqWideWarps;
// Accumulator blocks (16 x 8) a warp: 128 a block.
constexpr int kSqWideAcc = 8;
// The Gram warp tile's most blocks of 8 sources (2 at R = 64, else 1).
constexpr int kSqWideGramBlocks = 2;

// The layout of a launch at row width w (a multiple of 4), with one weight
// tile (one RBF) or two (terms, kTwo): the record's columns [S | 0.. | X |
// 0..] (X from column xo, a multiple of 8; nbc blocks of 8), the block's
// target rows, the column blocks a pass holds (cap) and the passes; the
// sources of a record slab (16, or 8 past 256 columns a pass); the strides
// of the resident targets (lt) and of a record slab (ldr); the floats of a
// ring stage and the dynamic shared memory.
struct SqWidePlan {
  int w, xo, nbc, rows, cap, passes, streamed, slab, lt, ldr, stage;
  int smem;  // bytes
};

__host__ __device__ inline SqWidePlan sq_wide_plan(int w, bool two) {
  SqWidePlan p;
  p.w = w;
  p.xo = 8 * ((w + 7) / 8);
  p.nbc = (p.xo + w + 7) / 8;
  p.rows = p.nbc <= 32 ? 64 : (p.nbc <= 64 ? 32 : 16);
  // 128 blocks of 16 rows a block: R / 16 row groups share them.
  p.cap = kSqWideWarps * kSqWideAcc * 16 / p.rows;
  p.passes = (p.nbc + p.cap - 1) / p.cap;
  p.streamed = p.passes > 1 ? 1 : 0;
  const int cols = 8 * (p.nbc < p.cap ? p.nbc : p.cap);
  p.slab = cols <= 256 ? 16 : 8;
  p.ldr = 16 * ((cols + 15) / 16) + 8;
  p.lt = p.xo + ((4 - p.xo) % 32 + 32) % 32;
  const int gram = (kSqWideTile + (p.streamed ? p.rows : 0)) *
                   kSqWideSliceLd;
  const int slab = p.slab * p.ldr;
  p.stage = gram > slab ? gram : slab;
  // the ring, the resident targets, the weight tiles, the row sums'
  // partials (the Gram warps' column groups x R, at most 256 floats), the
  // kMaxT thresholds and each warp's kMaxT 64-bit counts.
  p.smem = 4 * (kSqWideStages * p.stage + (p.streamed ? 0 : p.rows * p.lt) +
                (two ? 2 : 1) * p.rows * kSqWideWLd + 256 + kMaxT) +
           8 * kSqWideWarps * kMaxT;
  return p;
}

// The sources of one split of a launch at row width w (whole tiles of
// kSqWideTile; square_wave_tiles over target blocks x passes, one block an
// SM) and the split count. ops/sym_plan.square_wide_chunk mirrors it.
inline int sq_wide_chunk(int n_t, int n_s, int w, int* splits) {
  const SqWidePlan p = sq_wide_plan(w, false);
  const long long rb = (n_t + p.rows - 1) / p.rows;
  const int tiles = (n_s + kSqWideTile - 1) / kSqWideTile;
  return kSqWideTile * square_wave_tiles(rb * p.passes, tiles, 1, splits);
}

// The square/cross plan of K1 and the terms kernel at width m: past kMaxM
// this body's (m being the padded row width; an m that is not a multiple of
// 4 is planned at its padded width), else square_chunk's.
inline int square_plan_chunk(int n_t, int n_s, int m, int* splits) {
  if (m > kMaxM) return sq_wide_chunk(n_t, n_s, (m + 3) & ~3, splits);
  return square_chunk(n_t, n_s, m >= kSquareTensorMinM, splits);
}

// x = big + small, big x rounded to TF32 by an integer add and a mask (to
// nearest, ties away from zero; no cvt, whose conversion pipe would bound
// the fragment loads), small the exact float32 remainder, which the mma
// reads cut to TF32: the 3xTF32 pair to about 2^-22 of x in three
// instructions. Truncation (wide_tri_sm90.cuh's split_tf32, two
// instructions) leaves a value just below a TF32 number, such as a grid
// coordinate moved by the centring's rounding, a remainder of a whole TF32
// unit, whose cut loses 2^-21 of x with one sign for every such value.
__device__ __forceinline__ void split_tf32_rn(float x, uint32_t& big,
                                              uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// The value a TF32 mma.sync reads for a weight split by split_tf32_rn: the
// big part and the small one cut to TF32 (exact in float32). The row sums
// add these, so that D = rowsum x_i - KX cancels the weights' split error
// as a column of ones in the contraction would.
__device__ __forceinline__ float tf32_pair_value(float x) {
  uint32_t big, small;
  split_tf32_rn(x, big, small);
  return __uint_as_float(big) + __uint_as_float(small & 0xffffe000u);
}

// The body (see the top of the file). part: this split's (n_t, 2w + 1)
// slice of the workspace; the block writes its pass's (blockIdx.z)
// columns, pass 0 also the row sums and the counts. kT thresholds (3, or
// kMaxT for a runtime T padded with the first); weights(sq, k_c, w) the
// pair's weights. Composed kernels' constants in shared memory (AnyTerms)
// must be stored before the call: the body's first barrier comes before
// its first pair. Every thread issues its share of each stage's copies,
// kSqWideStages - 1 stages ahead, and computes.
template <int kT, class Wt>
__device__ __forceinline__ void square_wide_sm90_body(
    const float* __restrict__ targets, const float* __restrict__ sources,
    const float* __restrict__ scores, const Wt& weights,
    const float* __restrict__ thr, int n_t, int n_s, int w, int T, int chunk,
    float* __restrict__ part, unsigned long long* __restrict__ counts) {
  constexpr bool kTwo = kTwoBands<Wt>;
  constexpr int S = kSqWideStages;
  constexpr int LD = kSqWideSliceLd;
  constexpr int NB = kSqWideAcc;  // accumulator blocks a warp
  const SqWidePlan p = sq_wide_plan(w, kTwo);
  const int R = p.rows;
  extern __shared__ __align__(16) float sh[];
  float* ring = sh;
  float* tgt = ring + S * p.stage;                   // [R][lt], resident
  float* wc = tgt + (p.streamed ? 0 : R * p.lt);     // k_c (one RBF: k)
  float* ww = kTwo ? wc + R * kSqWideWLd : wc;       // w
  float* rowpart = ww + R * kSqWideWLd;              // [Gram column][row]
  float* th = rowpart + 256;                         // the thresholds
  auto* wcount = reinterpret_cast<unsigned long long*>(th + kMaxT);

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int rb = static_cast<int>(blockIdx.x) * R;
  const int j_begin = static_cast<int>(blockIdx.y) * chunk;
  const int j_end = min(n_s, j_begin + chunk);
  const int tiles = (j_end - j_begin + kSqWideTile - 1) / kSqWideTile;
  const int b0 = static_cast<int>(blockIdx.z) * p.cap;  // the pass's blocks
  const int nbp = min(p.cap, p.nbc - b0);
  const bool counting = blockIdx.z == 0;
  const int kg = (w + kSqWideSlice - 1) / kSqWideSlice;  // Gram slices
  const int ns = kg + kSqWideTile / p.slab;               // stages a tile
  const int total = tiles * ns;

  // The resident targets (xo columns a row, those past w zero-filled), with
  // the first stage's group.
  if (!p.streamed) {
    const int vr = p.xo / 4;
    for (int e = tid; e < R * vr; e += kSqWideThreads) {
      const int r = e / vr;
      const int k = 4 * (e - r * vr);
      const int i = rb + r;
      const bool ok = i < n_t && k < w;
      cp_async16(tgt + r * p.lt + k,
                 ok ? targets + static_cast<size_t>(i) * w + k : targets,
                 ok ? 16 : 0);
    }
  }

  // This thread's copies of stage qi of the block's stream (tile ic, stage
  // is of it) into ring slot qi % S: a Gram slice (the 64 sources' 16
  // vectors of 4 columns, with streamed targets R more rows), or a record
  // slab (its row tid % slab, every (512 / slab)-th vector of the pass's
  // 8 nbp columns).
  const int c0 = 8 * b0;
  const int slab_shift = p.slab == 16 ? 4 : 3;
  int ic = 0, is = 0;
  auto issue = [&](int qi) {
    const int j0 = j_begin + ic * kSqWideTile;
    float* stage = ring + (qi & (S - 1)) * p.stage;
    if (is < kg) {
      const int kv = 4 * (tid & 15);
      const int k = is * kSqWideSlice + kv;
      const bool kin = k < w;
      const int rows = kSqWideTile + (p.streamed ? R : 0);
      for (int r = tid >> 4; r < rows; r += kSqWideThreads / 16) {
        const bool src_row = r < kSqWideTile;
        const int row = src_row ? j0 + r : rb + r - kSqWideTile;
        const bool ok = kin && (src_row ? row < j_end : row < n_t);
        const float* base = src_row ? sources : targets;
        cp_async16(stage + r * LD + kv,
                   ok ? base + static_cast<size_t>(row) * w + k : base,
                   ok ? 16 : 0);
      }
    } else {
      const int u = tid & (p.slab - 1);
      const int j = j0 + (is - kg) * p.slab + u;
      const bool jin = j < j_end;
      const float* srow = scores + static_cast<size_t>(jin ? j : 0) * w;
      const float* xrow = sources + static_cast<size_t>(jin ? j : 0) * w;
      float* dst = stage + u * p.ldr;
      for (int v = tid >> slab_shift; v < 2 * nbp;
           v += kSqWideThreads >> slab_shift) {
        const int col = c0 + 4 * v;
        const float* src = nullptr;
        if (jin && col < w) {
          src = srow + col;
        } else if (jin && col >= p.xo && col < p.xo + w) {
          src = xrow + (col - p.xo);
        }
        cp_async16(dst + 4 * v, src ? src : sources, src ? 16 : 0);
      }
    }
    if (++is == ns) {
      is = 0;
      ++ic;
    }
  };
#pragma unroll
  for (int q = 0; q < S - 1; ++q) {
    if (q < total) issue(q);
    cp_async_commit();
  }

  // The thresholds in shared memory (read at each compare; visible after
  // the first stage's barrier), which keeps the registers within the 128
  // of 16 warps.
  // The row sums' partials and the warps' counts, in shared memory so
  // that they hold no register over the sweep (each slot added to by one
  // thread, in tile order).
  if (tid < kMaxT) th[tid] = thr[tid < T ? tid : 0];
  if (tid < 256) rowpart[tid] = 0.0f;
  if (tid < kSqWideWarps * kMaxT) wcount[tid] = 0ull;

  // The Gram warp tile: rows gr0 .. gr0 + 15 (row group grg of 16) and, of
  // each 64-source tile, the sources s0 .. s0 + 8 gcb - 1 (none for warps
  // 8-15 at R = 16, whose rows have only 8 blocks of sources).
  const int grg_count = R / 16;
  const int gcg_count = kSqWideWarps / grg_count;
  const int grg = warp / gcg_count;
  const int gcg = warp - grg * gcg_count;
  const int gcb = gcg_count >= 8 ? 1 : 8 / gcg_count;  // its source blocks
  const bool gram_on = gcg * gcb < 8;
  const int gr0 = 16 * grg;
  const int s0 = 8 * gcb * gcg;
  const bool row0 = rb + gr0 + g < n_t;
  const bool row1 = rb + gr0 + g + 8 < n_t;
  // The contraction warp tile: rows cr0 .. cr0 + 15 and the pass's blocks
  // ccg, ccg + ccg_count, ... (nbw of them).
  const int crg_count = R / 16;
  const int ccg_count = kSqWideWarps / crg_count;
  const int crg = warp / ccg_count;
  const int ccg = warp - crg * ccg_count;
  const int cr0 = 16 * crg;
  const int nbw = (nbp - ccg + ccg_count - 1) / ccg_count;
  // Its blocks below ix are in k_c's band (the record's columns below xo).
  const int ix = max(0, (p.xo / 8 - b0 - ccg + ccg_count - 1) / ccg_count);
  const int boff = t * p.ldr + 8 * ccg + g;  // B of its first block
  const int bstep = 8 * ccg_count;

  float acc[NB][4];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  }

  int q = 0;
  // The next stage of the block's stream, after the barrier that shows it
  // landed (and that every warp is done with the one before, whose slot
  // the copies issued here refill).
  auto next_stage = [&]() {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (q + S - 1 < total) issue(q + S - 1);
    cp_async_commit();
    return ring + (q++ & (S - 1)) * p.stage;
  };

#pragma unroll 1
  for (int c = 0; c < tiles; ++c) {
    const int j0 = j_begin + c * kSqWideTile;
    constexpr int GB = kSqWideGramBlocks;
    float acc_g[GB][4];
    float nsq[GB];  // |x_j|^2 of source 8b + g
#pragma unroll
    for (int b = 0; b < GB; ++b) {
      nsq[b] = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_g[b][e] = 0.0f;
    }
    float nt[2] = {0.0f, 0.0f};  // |x_i|^2 of rows g, g + 8
#pragma unroll 1
    for (int s = 0; s < kg; ++s) {
      const float* stage = next_stage();
      if (!gram_on) continue;
      const float* a = p.streamed
                           ? stage + (kSqWideTile + gr0) * LD
                           : tgt + gr0 * p.lt + s * kSqWideSlice;
      const int a_ld = p.streamed ? LD : p.lt;
      const float* bsrc = stage + s0 * LD;
      // 1. The Gram tile's slice s: the A fragment's values also give the
      // rows' norms, the B fragments' the sources'. The block count NG is
      // fixed for the launch (gcb) and taken once a slice, so that no
      // mma.sync sits under a branch of its own.
      const int kn = min(kSqWideSlice, w - s * kSqWideSlice);
      auto gram_slice = [&](auto ng) {
        constexpr int NG = decltype(ng)::value;
        auto gram_step = [&](int ks) {
          const int ka = 8 * ks + t;
          const float a00 = a[g * a_ld + ka];
          const float a10 = a[(g + 8) * a_ld + ka];
          const float a01 = a[g * a_ld + ka + 4];
          const float a11 = a[(g + 8) * a_ld + ka + 4];
          nt[0] = fmaf(a01, a01, fmaf(a00, a00, nt[0]));
          nt[1] = fmaf(a11, a11, fmaf(a10, a10, nt[1]));
          uint32_t ab[4], as[4];
          split_tf32_rn(a00, ab[0], as[0]);
          split_tf32_rn(a10, ab[1], as[1]);
          split_tf32_rn(a01, ab[2], as[2]);
          split_tf32_rn(a11, ab[3], as[3]);
          uint32_t bb[NG][2], bs[NG][2];
#pragma unroll
          for (int b = 0; b < NG; ++b) {
            const float* br = bsrc + (8 * b + g) * LD + ka;
            const float v0 = br[0];
            const float v1 = br[4];
            nsq[b] = fmaf(v1, v1, fmaf(v0, v0, nsq[b]));
            split_tf32_rn(v0, bb[b][0], bs[b][0]);
            split_tf32_rn(v1, bb[b][1], bs[b][1]);
          }
          // The small products of every block, then the big ones.
#pragma unroll
          for (int b = 0; b < NG; ++b) {
            mma_tf32(acc_g[b], as, bb[b][0], bb[b][1]);
          }
#pragma unroll
          for (int b = 0; b < NG; ++b) {
            mma_tf32(acc_g[b], ab, bs[b][0], bs[b][1]);
          }
#pragma unroll
          for (int b = 0; b < NG; ++b) {
            mma_tf32(acc_g[b], ab, bb[b][0], bb[b][1]);
          }
        };
        // Rolled: unrolled, the k-steps' hoisted loads pass the registers
        // of 16 warps (4-16 bytes of spill at two or eight a pass, at the
        // same speed).
#pragma unroll 1
        for (int ks = 0; 8 * ks < kn; ++ks) gram_step(ks);
      };
      if (gcb == 2) {
        gram_slice(std::integral_constant<int, 2>{});
      } else {
        gram_slice(std::integral_constant<int, 1>{});
      }
    }
    // 2. sq, the weights and the counts, once a pair, into the weight
    // tiles; the tile's row sums of w and its counts into shared memory.
    if (gram_on) {
      unsigned int cnt[kMaxT];
#pragma unroll
      for (int k = 0; k < kMaxT; ++k) cnt[k] = 0u;
      float rsum[2] = {0.0f, 0.0f};  // rows g, g + 8: this thread's sources
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        nt[0] += __shfl_xor_sync(0xffffffffu, nt[0], off);
        nt[1] += __shfl_xor_sync(0xffffffffu, nt[1], off);
#pragma unroll
        for (int b = 0; b < GB; ++b) {
          nsq[b] += __shfl_xor_sync(0xffffffffu, nsq[b], off);
        }
      }
      // sq into the k_c tile first, which ends the Gram tile's and the
      // norms' registers before the weights (AnyTerms' loop over the terms
      // needs them); each thread then reads back only what it wrote.
#pragma unroll
      for (int b = 0; b < GB; ++b) {
        // Sources 2t and 2t + 1 of block b: the norms of lanes 8t, 8t + 4.
        const float ns0 = __shfl_sync(0xffffffffu, nsq[b], 8 * t);
        const float ns1 = __shfl_sync(0xffffffffu, nsq[b], 8 * t + 4);
        if (b < gcb) {
          float sq[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sq[e] = fmaxf(__fsub_rn(__fadd_rn(nt[e >> 1], e & 1 ? ns1 : ns0),
                                    2.0f * acc_g[b][e]),
                          0.0f);
          }
          const int o = (gr0 + g) * kSqWideWLd + s0 + 8 * b + 2 * t;
          *reinterpret_cast<float2*>(wc + o) = make_float2(sq[0], sq[1]);
          *reinterpret_cast<float2*>(wc + o + 8 * kSqWideWLd) =
              make_float2(sq[2], sq[3]);
        }
      }
#pragma unroll
      for (int b = 0; b < GB; ++b) {
        if (b < gcb) {
          const int jl = s0 + 8 * b + 2 * t;
          const bool c0k = j0 + jl < j_end;
          const bool c1k = j0 + jl + 1 < j_end;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o =
                (gr0 + g + 8 * (e >> 1)) * kSqWideWLd + jl + (e & 1);
            const float sq = wc[o];
            const bool ce = e & 1 ? c1k : c0k;
            float ka, kb;
            weights(sq, ka, kb);
            wc[o] = ce ? ka : 0.0f;
            if constexpr (kTwo) ww[o] = ce ? kb : 0.0f;
            if (counting) {
              count_pair_fixed<kT, true>(sq, th, (e < 2 ? row0 : row1) && ce,
                                         cnt);
            }
            rsum[e >> 1] += ce ? tf32_pair_value(kb) : 0.0f;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        rsum[e] += __shfl_xor_sync(0xffffffffu, rsum[e], 1);
        rsum[e] += __shfl_xor_sync(0xffffffffu, rsum[e], 2);
        if (t == 0) rowpart[gcg * R + gr0 + g + 8 * e] += rsum[e];
      }
      if (counting) {
#pragma unroll
        for (int k = 0; k < kT; ++k) {
          unsigned int v = cnt[k];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v += __shfl_down_sync(0xffffffffu, v, off);
          }
          if (lane == 0) wcount[warp * kMaxT + k] += v;
        }
      }
    }
    // 3. The contraction, a k-step every 8 sources of a record slab: A =
    // the weights of the warp's rows and those 8 sources, B = the slab's
    // columns of each of the warp's blocks (k_c's band below xo, w's from
    // it).
#pragma unroll 1
    for (int u0 = 0; u0 < kSqWideTile; u0 += p.slab) {
      const float* slab = next_stage();
#pragma unroll 1
      for (int k8 = 0; k8 < p.slab; k8 += 8) {
        const float* bk = slab + k8 * p.ldr + boff;
        // A: the k_c tile's fragment and (terms) w's; each block takes its
        // band's (blocks below ix k_c's). Every mma.sync runs for all NB
        // blocks: a warp's blocks past nbw (the pass's last, narrower
        // group) read block 0's columns and are never flushed.
        const int ka = (cr0 + g) * kSqWideWLd + u0 + k8 + t;
        uint32_t kb[4], ks[4], wb[4], ws[4];
        split_tf32_rn(wc[ka], kb[0], ks[0]);
        split_tf32_rn(wc[ka + 8 * kSqWideWLd], kb[1], ks[1]);
        split_tf32_rn(wc[ka + 4], kb[2], ks[2]);
        split_tf32_rn(wc[ka + 8 * kSqWideWLd + 4], kb[3], ks[3]);
        if constexpr (kTwo) {
          split_tf32_rn(ww[ka], wb[0], ws[0]);
          split_tf32_rn(ww[ka + 8 * kSqWideWLd], wb[1], ws[1]);
          split_tf32_rn(ww[ka + 4], wb[2], ws[2]);
          split_tf32_rn(ww[ka + 8 * kSqWideWLd + 4], wb[3], ws[3]);
        }
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const float* br = bk + bstep * (i < nbw ? i : 0);
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32_rn(br[0], bb0, bs0);
          split_tf32_rn(br[4 * p.ldr], bb1, bs1);
          if constexpr (kTwo) {
            const bool use_w = i >= ix;
            uint32_t ab[4], as[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ab[e] = use_w ? wb[e] : kb[e];
              as[e] = use_w ? ws[e] : ks[e];
            }
            mma_3x(acc[i], ab, as, bb0, bs0, bb1, bs1);
          } else {
            mma_3x(acc[i], kb, ks, bb0, bs0, bb1, bs1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // The split's partial of the warp's rows and blocks: record column q < w
  // is KS's column q, xo + k is KX's column w + k; the pad goes nowhere.
  const int wd = 2 * w + 1;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    if (i < nbw) {
      const int cb = 8 * (b0 + ccg + ccg_count * i) + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cb + (e & 1);
        const int row = rb + cr0 + g + 8 * (e >> 1);
        int out = -1;
        if (col < w) {
          out = col;
        } else if (col >= p.xo && col < p.xo + w) {
          out = w + (col - p.xo);
        }
        if (out >= 0 && row < n_t) {
          part[static_cast<size_t>(row) * wd + out] = acc[i][e];
        }
      }
    }
  }
  if (counting) {
    // The row sums over the row group's Gram warps in order, and the
    // counts with one 64-bit integer atomic a threshold.
    __syncthreads();
    if (tid < R && rb + tid < n_t) {
      float v = 0.0f;
      for (int k = 0; k < gcg_count; ++k) v += rowpart[k * R + tid];
      part[static_cast<size_t>(rb + tid) * wd + 2 * w] = v;
    }
    if (tid < T) {
      unsigned long long v = 0ull;
      for (int k = 0; k < kSqWideWarps; ++k) v += wcount[k * kMaxT + tid];
      if (v != 0ull) atomicAdd(counts + tid, v);
    }
  }
}

// The threads of a square kernel's block for instance MM: this body's at
// MM = kWideMM, any m past kMaxM, else square_mma_body's.
template <int MM>
struct SqThreads {
  static constexpr int value =
      MM == kWideMM ? kSqWideThreads : kSqMmaThreads;
};

}  // namespace svgd
