// Pair-distance threshold counts for Hopper (sm_90a): the median
// selection's count pass.
//
//   cnt[t] = #{(i, j) : |r_i - c_j|^2 <= thr[t]},  i < n_r, j < n_c
//
// Replaces svgdcpp_tpu/ops/pallas_phi.py:_count_kernel (K16, called through
// count_le_pallas): the pass that ops/median.count_le_cross makes for every
// threshold batch of the median's bisection, its hybrid refinement, the
// fused routes' fallback and the sharded engine's median (local rows against
// the gathered sources, summed over the ranks by the caller).
//
// The wrapper (ops/cuda_phi.count_le_cuda) centers both sets on the column
// mean, as the plain version does, and sorts each launch's thresholds on the
// device: the kernel gets them ascending with `order`, their places in the
// caller's batch, and adds each count at counts[order[t]]. Up to m = 4 sq
// is built from differences in the plain sweeps' order (sweep_common.cuh's
// pair_sq, exact in float32 at any offset); above, by the Gram identity
// max(q_i + q_j - 2 <r_i, c_j>, 0) on the FP32 CUDA cores (never TF32: the
// thresholds sit at the median, where a rounded sq changes a count). The
// plain version (ops/median.count_le_plain) uses the Gram identity at every
// m, so a pair within rounding of a threshold may land on either side; on
// inputs where both forms are exact the counts are equal.
//
// Two entry points. svgd_count_le_self counts one set against itself (the
// single-device median's every pass) over the upper triangle of B x B tile
// pairs: an off-diagonal tile pair is swept once and counts twice, a
// diagonal tile is swept in full (both orders and its diagonal), so the
// counts are 2U + diag with the diagonal's sq from the same formula as
// every other pair's (at m > 4 the Gram form's self sq need not be 0). sq
// is symmetric in both forms (the difference negates exactly; __fadd_rn
// commutes and the dot's FMAs run in k order either way), so the self
// counts equal the cross counts of the same set exactly. svgd_count_le_cross
// sweeps every row tile against every column tile (the sharded engine's
// local rows against the gathered sources).
//
// Design (count_le_cross_kernel, both entries): 128 threads a block, each
// holding R rows (8 up to m = 4, 4 to 16, 2 to 32, 1 to 64) in registers,
// so B = 128 R rows a tile; the block stages its columns in shared memory
// and each broadcast read of a column serves R pairs. A second grid
// dimension splits a tile's columns when there are too few tiles to fill
// the card. Invalid rows hold +inf (or, in the Gram form, an infinite
// norm), so their sq is +inf, which no threshold counts: the pair loop is
// unmasked. The threshold work per pair takes one of two designs:
//
//   * predicated (kBinned false, T <= 3): P = 3 thresholds in registers,
//     padded with -1, which no sq reaches; per threshold one compare into
//     a predicate and one predicated add (sweep_common.cuh's add_if_le):
//     6 instructions a pair, no guard.
//   * binned (kBinned true, T >= 4): the pair's bin #{t : !(sq <= thr_sorted[t])}
//     by a branch-free search over 2^P - 1 sorted thresholds padded with
//     +inf (P = ceil(log2(T + 1)) steps, each a compare and a predicated
//     add to a byte offset; the first two against registers, the rest at
//     one shared read each), then one shared atomic increment of the
//     thread's own counter of that bin in a histogram laid out
//     [bin][thread]: no other thread adds to it, so there is no contention
//     and no bank conflict. At the end the block sums each bin over its
//     threads, and a prefix sum over the bins gives each threshold's count
//     (a tie counts as <=, as torch.bucketize bins it). About 3P + 6
//     instructions a pair, whatever T.
//
// At m = 2 the step loop issues 22.75 instructions a pair binned at P = 5
// (T = 16-31) and 11.75 predicated at T = 3, 5 of them sq's FP32 ones
// (chip_profile.py --sass).
//
// The entry point picks the design by T (kBinnedMinT).
//
// A thread's 32-bit counters see at most R x B pairs of one block (8192),
// then each block flushes: the warps sum by shuffles, the block in shared
// memory, and one 64-bit atomicAdd per threshold per block adds the count
// (twice it for an off-diagonal tile pair). Integer sums are exact and
// order-free: the counts are deterministic.
//
// Past kMaxM dimensions a row's coordinates no longer fit in registers
// (count_le_cross_wide_kernel, the cross form for both entries): sq by the
// same Gram identity, the block stages kWideCols columns at a time in
// slices of kWideK dimensions, each thread reads the matching slice of its
// own row and keeps the kWideCols dot products in registers across the
// slices; the norms are summed in the same order as the dot products'
// slices, dimension by dimension.
//
// Bound on this card: per pair 3m FP32 operations for sq by differences
// (2m + 3 by the Gram form, with the norms hoisted) and ceil(log2(T + 1))
// compares for the sorted bins; a self count needs n(n+1)/2 pairs. The
// inputs are read once per block from L2, so the pass is bound by the
// issue rate, not by memory.
//
// The entry points allocate nothing: the wrapper passes a zeroed counts
// buffer. Each returns cudaGetLastError() after its launch.

#include "sweep_common.cuh"

namespace {

using namespace svgd;

constexpr int kCountThreads = 128;
constexpr int kCountMaxT = 32;  // thresholds per launch (COUNT_MAX_T)

// From this many thresholds a launch takes the binned design; below, the
// predicated one. The predicated design's work
// grows with T (2 instructions a threshold), the binned one's with
// log2(T + 1) (3 a step, and 6 more a pair): on the card the predicated
// design was the faster at T = 3 and the binned one at 17 and 32 (PERF.md
// section 6, both timed by chip_profile.py --config count in trees that
// forced one design), and from T = 4 the search's 3 steps cost about what 8
// compares and adds do.
constexpr int kBinnedMinT = 4;

// Rows a thread holds.
template <int MM>
struct CountRows {
  static constexpr int value =
      MM <= 4 ? 8 : (MM <= 16 ? 4 : (MM <= 32 ? 2 : 1));
};

// Floats a staged column takes: its m coordinates and, in the Gram form,
// its squared norm at [MM], padded to 16 bytes past m = 2 (one LDS.128 per
// four floats).
template <int MM, bool kGram>
struct CountStride {
  static constexpr int value =
      (!kGram && MM <= 2) ? MM : ((MM + (kGram ? 1 : 0) + 3) / 4) * 4;
};

// Columns a shared tile holds: at most 12 KB of them.
template <int S>
struct CountColTile {
  static constexpr int value =
      S <= 12 ? 256 : (S <= 24 ? 128 : (S <= 48 ? 64 : 32));
};

// Tile pair of block `b`: the upper triangle of nb tiles a side (self) or
// every (row tile, column tile) of nbc column tiles (cross); the weight is
// the number of times its pairs count.
__device__ __forceinline__ void count_tile_pair(long long b, bool self,
                                                int nb, int nbc, int* bi,
                                                int* bj, int* weight) {
  if (self) {
    decode_upper_pair(b, nb, bi, bj);
    *weight = *bi == *bj ? 1 : 2;
  } else {
    *bi = static_cast<int>(b / nbc);
    *bj = static_cast<int>(b % nbc);
    *weight = 1;
  }
}

// pos += step where !(sq <= t) (sq above t, or NaN): one compare into a
// predicate and one predicated add, written in PTX as add_if_le is
// (sweep_common.cuh), since the compiler otherwise selects the step first.
__device__ __forceinline__ void step_if_above(unsigned int& pos, float sq,
                                              float t, unsigned int step) {
  asm("{\n\t.reg .pred p;\n\tsetp.gtu.f32 p, %1, %2;\n\t"
      "@p add.u32 %0, %0, %3;\n\t}"
      : "+r"(pos)
      : "f"(sq), "f"(t), "r"(step));
}

// The pair's bin #{t < 2^P - 1 : !(sq <= sh_th[t])}, as a byte offset
// (4 bin), over thresholds ascending and padded with +inf. The first two
// steps compare against registers (th_mid = sh_th[2^(P-1) - 1], th_lo and
// th_hi the quartiles sh_th[2^(P-2) - 1] and sh_th[3 2^(P-2) - 1]), each
// later one reads shared memory at the running offset. A NaN or +inf sq
// goes to a bin >= T, which no threshold counts. P >= 2.
template <int P>
__device__ __forceinline__ unsigned int count_bin4(float sq, float th_mid,
                                                   float th_lo, float th_hi,
                                                   const float* sh_th) {
  constexpr unsigned int kHalf = 1u << (P - 1);
  const bool low = sq <= th_mid;
  unsigned int pos = low ? 0u : 4u * kHalf;
  step_if_above(pos, sq, low ? th_lo : th_hi, 2u * kHalf);
  const char* base = reinterpret_cast<const char*>(sh_th);
#pragma unroll
  for (unsigned int h = kHalf / 4; h >= 1; h >>= 1) {
    const float t = *reinterpret_cast<const float*>(base + pos + 4 * (h - 1));
    step_if_above(pos, sq, t, 4u * h);
  }
  return pos;
}

template <int MM, bool kExact, bool kGram, bool kBinned, int P>
__global__ void __launch_bounds__(kCountThreads)
    count_le_cross_kernel(const float* __restrict__ rows,
                          const float* __restrict__ cols,
                          const float* __restrict__ thr,
                          const int* __restrict__ order, int n_r, int n_c,
                          int m_arg, int T, bool self, int nb, int nbc,
                          int split_len,
                          unsigned long long* __restrict__ counts) {
  constexpr int R = CountRows<MM>::value;
  constexpr int kB = kCountThreads * R;
  constexpr int kStride = CountStride<MM, kGram>::value;
  constexpr int kColTile = CountColTile<kStride>::value;
  constexpr int kP = kBinned ? P : 2;  // binned: search steps
  constexpr int kBins = kBinned ? (1 << kP) : 1;
  constexpr int kTR = kBinned ? 1 : P;  // predicated: thresholds held
  __shared__ __align__(16) float sh_x[kColTile * kStride];
  __shared__ float sh_th[kBinned ? kBins : 1];
  __shared__ unsigned int sh_hist[kBinned ? kBins * kCountThreads : 1];
  __shared__ unsigned long long sh_cnt[kCountMaxT];

  const int m = kExact ? MM : m_arg;
  const int tid = threadIdx.x;
  int bi, bj, weight;
  count_tile_pair(static_cast<long long>(blockIdx.x), self, nb, nbc, &bi,
                  &bj, &weight);
  const int c_begin = bj * kB + blockIdx.y * split_len;
  const int c_end = min(min(n_c, bj * kB + kB), c_begin + split_len);

  for (int t = tid; t < kCountMaxT; t += kCountThreads) sh_cnt[t] = 0ull;
  float th[kTR];
  float th_mid = 0.0f, th_lo = 0.0f, th_hi = 0.0f;
  if (kBinned) {
    for (int t = tid; t < kBins; t += kCountThreads) {
      sh_th[t] = t < T ? thr[t] : __int_as_float(0x7f800000);  // +inf
    }
    for (int e = tid; e < kBins * kCountThreads; e += kCountThreads) {
      sh_hist[e] = 0u;
    }
  } else {
#pragma unroll
    for (int t = 0; t < kTR; ++t) th[t] = t < T ? thr[t] : -1.0f;
  }

  // The thread's rows, R of them, 128 apart; an invalid row sits at +inf.
  float xi[R][MM];
  float qi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = bi * kB + r * kCountThreads + tid;
    const bool ok = i < n_r;
    qi[r] = 0.0f;
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      float v = 0.0f;
      if (kExact || k < m) {
        v = ok ? rows[static_cast<size_t>(i) * m + k]
               : (kGram ? 0.0f : __int_as_float(0x7f800000));
      }
      xi[r][k] = v;
      if (kGram) qi[r] = fmaf(v, v, qi[r]);
    }
    if (kGram && !ok) qi[r] = __int_as_float(0x7f800000);
  }
  unsigned int cnt[kTR];
#pragma unroll
  for (int t = 0; t < kTR; ++t) cnt[t] = 0u;
  char* hist_b = reinterpret_cast<char*>(sh_hist + tid);
  if (kBinned) {
    __syncthreads();  // thresholds and histogram are set
    th_mid = sh_th[(1 << (kP - 1)) - 1];
    th_lo = sh_th[(1 << (kP - 2)) - 1];
    th_hi = sh_th[3 * (1 << (kP - 2)) - 1];
  }

  for (int j0 = c_begin; j0 < c_end; j0 += kColTile) {
    const int tile_n = min(kColTile, c_end - j0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < tile_n * kStride; e += kCountThreads) {
      const int jj = e / kStride, k = e - jj * kStride;
      sh_x[e] = k < m ? cols[static_cast<size_t>(j0 + jj) * m + k] : 0.0f;
    }
    __syncthreads();
    if (kGram) {
      // Each column's squared norm, summed in k order as the rows' are.
      for (int jj = tid; jj < tile_n; jj += kCountThreads) {
        float* xj = sh_x + jj * kStride;
        float q = 0.0f;
#pragma unroll
        for (int k = 0; k < MM; ++k) {
          if (kExact || k < m) q = fmaf(xj[k], xj[k], q);
        }
        xj[MM] = q;
      }
      __syncthreads();
    }
    for (int jj = 0; jj < tile_n; ++jj) {
      const float* xs = sh_x + jj * kStride;
      float xj[MM];
#pragma unroll
      for (int k = 0; k < MM; ++k) xj[k] = xs[k];
      const float qj = kGram ? xs[MM] : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float sq;
        if (kGram) {
          float dot = 0.0f;
#pragma unroll
          for (int k = 0; k < MM; ++k) {
            if (kExact || k < m) dot = fmaf(xi[r][k], xj[k], dot);
          }
          sq = fmaxf(__fsub_rn(__fadd_rn(qi[r], qj), 2.0f * dot), 0.0f);
        } else {
          sq = pair_sq<MM, kExact>(xi[r], xj, m);
        }
        if (kBinned) {
          // The thread's own counter of the bin: no other thread adds
          // to it, so the shared atomic (one instruction) is exact.
          atomicAdd(reinterpret_cast<unsigned int*>(
                        hist_b + count_bin4<kP>(sq, th_mid, th_lo, th_hi,
                                                sh_th) * kCountThreads),
                    1u);
        } else {
          count_pair_fixed<kTR, false>(sq, th, true, cnt);
        }
      }
    }
  }

  // Block counts: per threshold (predicated) or per bin and then prefix
  // sums over the bins (binned), then one 64-bit atomic per threshold.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (kBinned) {
    __syncthreads();  // every thread's histogram is complete
    for (int b = warp; b < T; b += kCountThreads / 32) {
      unsigned int v = 0u;
#pragma unroll
      for (int k = 0; k < kCountThreads / 32; ++k) {
        v += sh_hist[b * kCountThreads + k * 32 + lane];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      if (lane == 0) sh_cnt[b] = v;
    }
    __syncthreads();
    if (warp == 0) {
      // Inclusive scan of the bins over the 32 lanes: lane t's count is
      // the number of pairs with bin <= t.
      unsigned long long v = lane < T ? sh_cnt[lane] : 0ull;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned long long u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      if (lane < T && v != 0ull) {
        atomicAdd(counts + order[lane],
                  v * static_cast<unsigned long long>(weight));
      }
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < kTR; ++t) {
    if (t < T) {  // counters past T held padding
      unsigned int v = cnt[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      if (lane == 0 && v != 0u) {
        atomicAdd(sh_cnt + t, static_cast<unsigned long long>(v));
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < T; t += kCountThreads) {
    if (sh_cnt[t] != 0ull) {
      atomicAdd(counts + order[t],
                sh_cnt[t] * static_cast<unsigned long long>(weight));
    }
  }
}

// Columns a wide tile holds and dimensions a slice of it holds; a thread
// keeps kWideCols dot products and kWideK coordinates of its row in
// registers. A column's slice is padded by one float, so that the 32 threads
// that sum the columns' norms read 32 distinct banks.
constexpr int kWideCols = 32;
constexpr int kWideK = 16;
constexpr int kWideStride = kWideK + 1;

// The count for m > kMaxM, by the Gram identity (see the top of the file),
// one row a thread, TT thresholds held (padded with -1). Dimensions past m
// and columns past the tile enter as zeros.
template <int TT>
__global__ void __launch_bounds__(kCountThreads)
    count_le_cross_wide_kernel(const float* __restrict__ rows,
                               const float* __restrict__ cols,
                               const float* __restrict__ thr,
                               const int* __restrict__ order, int n_r,
                               int n_c, int m, int T, int cols_per_split,
                               unsigned long long* __restrict__ counts) {
  __shared__ float sh_x[kWideCols * kWideStride];
  __shared__ float sh_q[kWideCols];
  __shared__ unsigned long long sh_cnt[TT];

  const int i = blockIdx.x * kCountThreads + threadIdx.x;
  const bool row_ok = i < n_r;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(n_c, c_begin + cols_per_split);
  const float* __restrict__ xi =
      rows + static_cast<size_t>(row_ok ? i : 0) * m;

  for (int t = threadIdx.x; t < TT; t += kCountThreads) sh_cnt[t] = 0ull;

  float th[TT];
#pragma unroll
  for (int t = 0; t < TT; ++t) th[t] = (t < T) ? thr[t] : -1.0f;

  float qi = 0.0f;
  if (row_ok) {
    for (int k = 0; k < m; ++k) qi = fmaf(xi[k], xi[k], qi);
  }
  unsigned int cnt[TT];
#pragma unroll
  for (int t = 0; t < TT; ++t) cnt[t] = 0u;

  for (int j0 = c_begin; j0 < c_end; j0 += kWideCols) {
    const int tile_n = min(kWideCols, c_end - j0);
    float dot[kWideCols];
#pragma unroll
    for (int jj = 0; jj < kWideCols; ++jj) dot[jj] = 0.0f;
    float qj = 0.0f;  // thread jj < kWideCols: column jj's squared norm
    for (int k0 = 0; k0 < m; k0 += kWideK) {
      __syncthreads();  // the previous slice is consumed
      for (int e = threadIdx.x; e < kWideCols * kWideK; e += kCountThreads) {
        const int jj = e / kWideK, kk = e % kWideK;
        sh_x[jj * kWideStride + kk] =
            (jj < tile_n && k0 + kk < m)
                ? cols[static_cast<size_t>(j0 + jj) * m + k0 + kk]
                : 0.0f;
      }
      __syncthreads();
      if (threadIdx.x < kWideCols) {
        const float* xj = sh_x + threadIdx.x * kWideStride;
#pragma unroll
        for (int kk = 0; kk < kWideK; ++kk) qj = fmaf(xj[kk], xj[kk], qj);
      }
      float xr[kWideK];
#pragma unroll
      for (int kk = 0; kk < kWideK; ++kk) {
        xr[kk] = (row_ok && k0 + kk < m) ? xi[k0 + kk] : 0.0f;
      }
#pragma unroll
      for (int jj = 0; jj < kWideCols; ++jj) {
#pragma unroll
        for (int kk = 0; kk < kWideK; ++kk) {
          dot[jj] = fmaf(xr[kk], sh_x[jj * kWideStride + kk], dot[jj]);
        }
      }
    }
    if (threadIdx.x < kWideCols) sh_q[threadIdx.x] = qj;
    __syncthreads();
    if (row_ok) {
#pragma unroll
      for (int jj = 0; jj < kWideCols; ++jj) {
        if (jj < tile_n) {
          const float sq = fmaxf(
              __fsub_rn(__fadd_rn(qi, sh_q[jj]), 2.0f * dot[jj]), 0.0f);
          count_pair_fixed<TT, false>(sq, th, true, cnt);
        }
      }
    }
  }

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    if (t < T) {
      unsigned long long v = cnt[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      if (lane == 0 && v != 0ull) atomicAdd(sh_cnt + t, v);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += kCountThreads) {
    if (sh_cnt[t] != 0ull) atomicAdd(counts + order[t], sh_cnt[t]);
  }
}

// Blocks a launch aims for (a few waves on a 132-SM card); a tile's
// columns are split until the grid has about this many.
constexpr int kTargetBlocks = 2048;

// The wide kernel over all n_r x n_c pairs (either entry past kMaxM).
int launch_wide(const float* rows, const float* cols, const float* thr,
                const int* order, int n_r, int n_c, int m, int T,
                unsigned long long* c, cudaStream_t s) {
  const int row_blocks = (n_r + kCountThreads - 1) / kCountThreads;
  int splits = (kTargetBlocks + row_blocks - 1) / row_blocks;
  splits = max(1, min(splits, (n_c + 63) / 64));
  int per_split = (n_c + splits - 1) / splits;
  per_split = (per_split + 63) / 64 * 64;
  splits = (n_c + per_split - 1) / per_split;
  if (splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(row_blocks, splits);
  if (T <= kMaxT) {
    count_le_cross_wide_kernel<kMaxT><<<grid, kCountThreads, 0, s>>>(
        rows, cols, thr, order, n_r, n_c, m, T, per_split, c);
  } else {
    count_le_cross_wide_kernel<kCountMaxT><<<grid, kCountThreads, 0, s>>>(
        rows, cols, thr, order, n_r, n_c, m, T, per_split, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch of count_le_cross_kernel<MM, kExact, kGram, ...> for T thresholds
// in the design T takes, over the triangle of n_r = n_c rows (self) or
// every tile pair.
template <int MM, bool kExact, bool kGram>
int launch_count(const float* rows, const float* cols, const float* thr,
                 const int* order, int n_r, int n_c, int m, int T, bool self,
                 unsigned long long* c, cudaStream_t s) {
  constexpr int kB = kCountThreads * CountRows<MM>::value;
  const long long nbr = (n_r + kB - 1) / kB;
  const long long nbc = (n_c + kB - 1) / kB;
  const long long pairs = self ? nbr * (nbr + 1) / 2 : nbr * nbc;
  if (pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // Split each tile's columns (in multiples of 64) until the grid holds
  // about kTargetBlocks blocks.
  const long long want = (kTargetBlocks + pairs - 1) / pairs;
  int splits = static_cast<int>(want < kB / 64 ? want : kB / 64);
  splits = max(1, splits);
  int split_len = (kB + splits - 1) / splits;
  split_len = (split_len + 63) / 64 * 64;
  splits = (kB + split_len - 1) / split_len;
  const dim3 grid(static_cast<unsigned int>(pairs), splits);
#define SVGD_COUNT_GO(BIN_, P_)                                             \
  count_le_cross_kernel<MM, kExact, kGram, BIN_, P_>                        \
      <<<grid, kCountThreads, 0, s>>>(rows, cols, thr, order, n_r, n_c, m,  \
                                      T, self, static_cast<int>(nbr),       \
                                      static_cast<int>(nbc), split_len, c)
  static_assert(kBinnedMinT == 4, "the instances below follow kBinnedMinT");
  if (T <= 3) {
    SVGD_COUNT_GO(false, 3);
  } else if (T <= 7) {
    SVGD_COUNT_GO(true, 3);
  } else if (T <= 15) {
    SVGD_COUNT_GO(true, 4);
  } else if (T <= 31) {
    SVGD_COUNT_GO(true, 5);
  } else {
    SVGD_COUNT_GO(true, 6);
  }
#undef SVGD_COUNT_GO
  return static_cast<int>(cudaGetLastError());
}

// Differences up to m = 4 (DIFF_FORM_MAX_M), the Gram form above; exact
// instances for the flagship (m = 2) and hierarchical-BLR (m = 11) widths,
// the wide kernel past kMaxM.
int dispatch_count(const float* rows, const float* cols, const float* thr,
                   const int* order, int n_r, int n_c, int m, int T,
                   bool self, long long* counts, void* stream) {
  if (n_r <= 0 || n_c <= 0 || m < 1 || T < 1 || T > kCountMaxT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  switch (m) {
    case 1:
      return launch_count<1, true, false>(rows, cols, thr, order, n_r, n_c,
                                          m, T, self, c, s);
    case 2:
      return launch_count<2, true, false>(rows, cols, thr, order, n_r, n_c,
                                          m, T, self, c, s);
    case 3:
      return launch_count<3, true, false>(rows, cols, thr, order, n_r, n_c,
                                          m, T, self, c, s);
    case 4:
      return launch_count<4, true, false>(rows, cols, thr, order, n_r, n_c,
                                          m, T, self, c, s);
    case 11:
      return launch_count<11, true, true>(rows, cols, thr, order, n_r, n_c,
                                          m, T, self, c, s);
    default:
      if (m >= 5 && m <= 8) {
        return launch_count<8, false, true>(rows, cols, thr, order, n_r,
                                            n_c, m, T, self, c, s);
      } else if (m >= 9 && m <= 16) {
        return launch_count<16, false, true>(rows, cols, thr, order, n_r,
                                             n_c, m, T, self, c, s);
      } else if (m >= 17 && m <= 32) {
        return launch_count<32, false, true>(rows, cols, thr, order, n_r,
                                             n_c, m, T, self, c, s);
      } else if (m >= 33 && m <= kMaxM) {
        return launch_count<64, false, true>(rows, cols, thr, order, n_r,
                                             n_c, m, T, self, c, s);
      }
      return launch_wide(rows, cols, thr, order, n_r, n_c, m, T, c, s);
  }
}

}  // namespace

extern "C" {

// counts (T,) of |r_i - c_j|^2 <= thr[t] over all n_r x n_c pairs. rows
// (n_r, m) and cols (n_c, m) centered on the column mean, float32 row-major
// on the device; thr (T,) float32 ascending on the device and order (T,)
// int32 its places in the caller's batch (count t goes to counts[order[t]]);
// counts a zeroed int64 buffer. m >= 1, 1 <= T <= 32.
int svgd_count_le_cross(const float* rows, const float* cols, const float* thr,
                        const int* order, int n_r, int n_c, int m, int T,
                        long long* counts, void* stream) {
  return dispatch_count(rows, cols, thr, order, n_r, n_c, m, T, false,
                        counts, stream);
}

// svgd_count_le_cross of one set x (n, m) against itself, over the upper
// triangle of tile pairs (2U + diag; past kMaxM the wide kernel's cross
// form). The same counts as svgd_count_le_cross(x, x, ...).
int svgd_count_le_self(const float* x, const float* thr, const int* order,
                       int n, int m, int T, long long* counts,
                       void* stream) {
  return dispatch_count(x, x, thr, order, n, n, m, T, m <= kMaxM, counts,
                        stream);
}

}  // extern "C"
