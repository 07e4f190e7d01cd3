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
// mean, as the plain version does. Up to m = 4 sq is built from differences
// in the plain sweeps' order (sweep_common.cuh's pair_sq, exact in float32 at
// any offset); above, by the Gram identity q_i + q_j - 2 <r_i, c_j> on the
// FP32 CUDA cores (never TF32: the thresholds sit at the median, where a
// rounded sq changes a count), clamped at 0 as the plain version clamps it.
// The plain version (ops/median.count_le_plain) uses the Gram identity at
// every m, so a pair within rounding of a threshold may land on either side;
// on inputs where both forms are exact the counts are equal.
//
// Design: one thread owns one row, kCountThreads rows a block, and keeps its
// coordinates, TT thresholds and TT counts in registers; the block walks its
// share of the columns in shared-memory tiles (each column read once per
// block, its squared norm computed once per tile). A second grid dimension
// splits the columns, so that a few thousand rows still fill the card. At
// the end each warp sums its counts with shuffles (64-bit), adds them to the
// block's partial counts in shared memory, and one thread adds each of the
// block's T partials to the int64 counts with one 64-bit atomicAdd. Integer
// sums are exact and order-free: the counts are deterministic.
//
// Past kMaxM dimensions a row's coordinates no longer fit in registers
// (count_le_cross_wide_kernel): sq by the same Gram identity, the block
// stages kWideCols columns at a time in slices of kWideK dimensions, each
// thread reads the matching slice of its own row and keeps the kWideCols dot
// products in registers across the slices; the norms are summed in the same
// order as the dot products' slices, dimension by dimension.
//
// Bound on this card: per pair 3m FP32 operations for sq by differences
// (2m + 3 by the Gram form, with the norms hoisted) and T compares; the
// inputs are read once per block from L2, so the pass is bound by the FP32
// pipes, not by memory.
//
// The entry point allocates nothing: the wrapper passes a zeroed counts
// buffer. It returns cudaGetLastError() after its launch.

#include "sweep_common.cuh"

namespace {

using namespace svgd;

constexpr int kCountThreads = 128;
constexpr int kCountMaxT = 32;  // thresholds per launch (COUNT_MAX_T)

// Columns of a shared tile: kTile * MM floats stay at 16 KB.
template <int MM>
struct CountTile {
  static constexpr int value = MM <= 16 ? 256 : (MM <= 32 ? 128 : 64);
};

// Blocks a launch aims for (a few per SM on a 132-SM card); the columns are
// split until the grid has about this many.
constexpr int kTargetBlocks = 2048;

template <int MM, bool kExact, bool kGram, int TT>
__global__ void __launch_bounds__(kCountThreads)
    count_le_cross_kernel(const float* __restrict__ rows,
                          const float* __restrict__ cols,
                          const float* __restrict__ thr, int n_r, int n_c,
                          int m_arg, int T, int cols_per_split,
                          unsigned long long* __restrict__ counts) {
  constexpr int kTile = CountTile<MM>::value;
  __shared__ float sh_x[kTile * MM];
  __shared__ float sh_q[kGram ? kTile : 1];
  __shared__ unsigned long long sh_cnt[TT];

  const int m = kExact ? MM : m_arg;
  const int i = blockIdx.x * kCountThreads + threadIdx.x;
  const bool row_ok = i < n_r;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(n_c, c_begin + cols_per_split);

  for (int t = threadIdx.x; t < TT; t += kCountThreads) sh_cnt[t] = 0ull;

  float th[TT];
#pragma unroll
  for (int t = 0; t < TT; ++t) th[t] = (t < T) ? thr[t] : 0.0f;

  float xi[MM];
  float qi = 0.0f;
#pragma unroll
  for (int k = 0; k < MM; ++k) {
    xi[k] = (row_ok && (kExact || k < m))
                ? rows[static_cast<size_t>(i) * m + k]
                : 0.0f;
    if (kGram) qi = fmaf(xi[k], xi[k], qi);
  }
  unsigned int cnt[TT];
#pragma unroll
  for (int t = 0; t < TT; ++t) cnt[t] = 0u;

  for (int j0 = c_begin; j0 < c_end; j0 += kTile) {
    const int tile_n = min(kTile, c_end - j0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < tile_n * m; e += kCountThreads) {
      sh_x[e] = cols[static_cast<size_t>(j0) * m + e];
    }
    __syncthreads();
    if (kGram) {
      for (int jj = threadIdx.x; jj < tile_n; jj += kCountThreads) {
        float q = 0.0f;
        for (int k = 0; k < m; ++k) {
          q = fmaf(sh_x[jj * m + k], sh_x[jj * m + k], q);
        }
        sh_q[jj] = q;
      }
      __syncthreads();
    }
    if (row_ok) {
      for (int jj = 0; jj < tile_n; ++jj) {
        const float* xj = sh_x + jj * m;
        float sq;
        if (kGram) {
          float dot = 0.0f;
#pragma unroll
          for (int k = 0; k < MM; ++k) {
            if (kExact || k < m) dot = fmaf(xi[k], xj[k], dot);
          }
          sq = fmaxf(__fsub_rn(__fadd_rn(qi, sh_q[jj]), 2.0f * dot), 0.0f);
        } else {
          sq = pair_sq<MM, kExact>(xi, xj, m);
        }
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          if (t < T) cnt[t] += (sq <= th[t]) ? 1u : 0u;
        }
      }
    }
  }

  // Block partials: warp sums by shuffles, then one shared atomic per warp.
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
    if (sh_cnt[t] != 0ull) atomicAdd(counts + t, sh_cnt[t]);
  }
}

// Columns a wide tile holds and dimensions a slice of it holds; a thread
// keeps kWideCols dot products and kWideK coordinates of its row in
// registers. A column's slice is padded by one float, so that the 32 threads
// that sum the columns' norms read 32 distinct banks.
constexpr int kWideCols = 32;
constexpr int kWideK = 16;
constexpr int kWideStride = kWideK + 1;

// count_le_cross_kernel for m > kMaxM, by the Gram identity (see the top of
// the file). Dimensions past m and columns past the tile enter as zeros.
template <int TT>
__global__ void __launch_bounds__(kCountThreads)
    count_le_cross_wide_kernel(const float* __restrict__ rows,
                               const float* __restrict__ cols,
                               const float* __restrict__ thr, int n_r,
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
  for (int t = 0; t < TT; ++t) th[t] = (t < T) ? thr[t] : 0.0f;

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
#pragma unroll
          for (int t = 0; t < TT; ++t) {
            if (t < T) cnt[t] += (sq <= th[t]) ? 1u : 0u;
          }
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
    if (sh_cnt[t] != 0ull) atomicAdd(counts + t, sh_cnt[t]);
  }
}

}  // namespace

extern "C" {

// counts (T,) of |r_i - c_j|^2 <= thr[t] over all n_r x n_c pairs. rows
// (n_r, m) and cols (n_c, m) centered on the column mean, float32 row-major
// on the device; thr (T,) float32 on the device; counts a zeroed int64 (T,)
// buffer. m >= 1, 1 <= T <= 32.
int svgd_count_le_cross(const float* rows, const float* cols, const float* thr,
                        int n_r, int n_c, int m, int T, long long* counts,
                        void* stream) {
  if (n_r <= 0 || n_c <= 0 || m < 1 || T < 1 || T > kCountMaxT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_blocks = (n_r + kCountThreads - 1) / kCountThreads;
  // Split the columns until the grid holds about kTargetBlocks blocks, each
  // split a multiple of 64 columns (the narrowest tile).
  int splits = (kTargetBlocks + row_blocks - 1) / row_blocks;
  splits = max(1, min(splits, (n_c + 63) / 64));
  int per_split = (n_c + splits - 1) / splits;
  per_split = (per_split + 63) / 64 * 64;
  splits = (n_c + per_split - 1) / per_split;
  if (splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(row_blocks, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_COUNT(MM_, EX_, GRAM_)                                   \
  {                                                                          \
    if (T <= kMaxT) {                                                        \
      count_le_cross_kernel<MM_, EX_, GRAM_, kMaxT>                          \
          <<<grid, kCountThreads, 0, s>>>(rows, cols, thr, n_r, n_c, m, T,   \
                                          per_split, c);                     \
    } else {                                                                 \
      count_le_cross_kernel<MM_, EX_, GRAM_, kCountMaxT>                     \
          <<<grid, kCountThreads, 0, s>>>(rows, cols, thr, n_r, n_c, m, T,   \
                                          per_split, c);                     \
    }                                                                        \
  }
  // Differences up to m = 4 (DIFF_FORM_MAX_M), the Gram form above; exact
  // instances for the flagship (m = 2) and hierarchical-BLR (m = 11) widths,
  // the wide kernel past kMaxM.
  switch (m) {
    case 1: SVGD_LAUNCH_COUNT(1, true, false); break;
    case 2: SVGD_LAUNCH_COUNT(2, true, false); break;
    case 3: SVGD_LAUNCH_COUNT(3, true, false); break;
    case 4: SVGD_LAUNCH_COUNT(4, true, false); break;
    case 11: SVGD_LAUNCH_COUNT(11, true, true); break;
    default:
      if (m >= 5 && m <= 8) {
        SVGD_LAUNCH_COUNT(8, false, true);
      } else if (m >= 9 && m <= 16) {
        SVGD_LAUNCH_COUNT(16, false, true);
      } else if (m >= 17 && m <= 32) {
        SVGD_LAUNCH_COUNT(32, false, true);
      } else if (m >= 33 && m <= kMaxM) {
        SVGD_LAUNCH_COUNT(64, false, true);
      } else if (T <= kMaxT) {
        count_le_cross_wide_kernel<kMaxT><<<grid, kCountThreads, 0, s>>>(
            rows, cols, thr, n_r, n_c, m, T, per_split, c);
      } else {
        count_le_cross_wide_kernel<kCountMaxT><<<grid, kCountThreads, 0, s>>>(
            rows, cols, thr, n_r, n_c, m, T, per_split, c);
      }
  }
#undef SVGD_LAUNCH_COUNT
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
