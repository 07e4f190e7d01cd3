// Fused phi + median-count sweeps for Hopper (sm_90a).
//
// One O(n^2) pass over particle pairs gives both the SVGD update direction
// of an isotropic RBF kernel k = exp(-gamma * sq) and the counts of pair
// squared distances at or below each of T thresholds (the median
// selection's edges):
//
//   KS_i   = sum_j k_ij s_j,   D_i = sum_j k_ij (x_i - x_j)    (2m values)
//   phi_i  = (KS_i + 2 gamma D_i) / n_s
//   cnt[t] = #{(i, j) : sq_ij <= thr[t]}
//
// D is accumulated from the differences, as the plain version does, and not
// as the Pallas kernels' KX - rowsum * x: that subtraction of two nearly
// equal O(n) sums cancels in float32.
//
// Coordinates arrive centered on the source mean (the wrapper does it in
// torch), so sq in the difference form is exact in float32 at any offset.
// gamma and the thresholds are read from device memory: the host never
// reads them, so a step needs no synchronisation to launch a sweep.
//
// sq is summed from the first coordinate up with __fmul_rn/__fadd_rn, so no
// FMA contraction rounds it differently from the plain torch version
// (svgdcpp_tpu_torch/ops/phi.py); its counts therefore equal these exactly.
//
// The kernels allocate nothing: the wrapper (ops/cuda_phi.py) passes zeroed
// count and accumulator buffers. Each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 8;  // thresholds held in registers
constexpr float kLog2e = 1.4426950408889634f;

// d = xi - xj and sq = |d|^2, summed from k = 0 up, each product and sum
// rounded on its own.
template <int M>
__device__ __forceinline__ float diff_sq(const float* xi, const float* xj,
                                         float* d) {
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    d[k] = __fsub_rn(xi[k], xj[k]);
    sq = k == 0 ? __fmul_rn(d[k], d[k]) : __fadd_rn(sq, __fmul_rn(d[k], d[k]));
  }
  return sq;
}

__device__ __forceinline__ void count_pair(float sq, const float* th, int T,
                                           unsigned int* cnt) {
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    if (t < T) cnt[t] += (sq <= th[t]) ? 1u : 0u;
  }
}

// Warp-reduce each thread's counts; lane 0 adds the warp's total with one
// 64-bit integer atomic per threshold. Integer sums are exact and
// independent of order, so the counts are deterministic. Every lane of the
// warp must be present.
__device__ __forceinline__ void flush_counts(const unsigned int* cnt, int T,
                                             unsigned long long* counts) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    if (t < T) {
      unsigned int v = cnt[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      if (lane == 0 && v != 0u) {
        atomicAdd(counts + t, static_cast<unsigned long long>(v));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fused_phi_counts_square
//
// Replaces svgdcpp_tpu/ops/pallas_phi.py:_fused_kernel (the square/cross
// sweep, called through _phi_rbf_fused_pallas_cross_impl).
//
// Bound on this card: per pair 3m+1 FLOPs for sq, one ex2 on the special
// function unit (a quarter of the FP32 rate), 2m FMAs and T compares;
// the operands are a few KB, so the sweep is compute-bound on the FP32
// pipes and the SFU, not on memory.
//
// Design: one thread owns one target row and keeps KS, D (2m values) and
// its T counts in registers, so nothing per pair leaves the SM. A block of
// kSqThreads targets walks all sources in kSqTile-row shared-memory tiles
// (each source is read once per block and broadcast to every thread). The
// epilogue writes phi directly; ragged edges are bounds checks, not padding.
// ---------------------------------------------------------------------------

constexpr int kSqThreads = 128;
constexpr int kSqTile = 256;

template <int M>
__global__ void __launch_bounds__(kSqThreads)
    fused_phi_counts_square_kernel(const float* __restrict__ targets,
                                   const float* __restrict__ sources,
                                   const float* __restrict__ scores,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ thr, int n_t,
                                   int n_s, int T, float* __restrict__ phi,
                                   unsigned long long* __restrict__ counts) {
  __shared__ float sh_x[kSqTile * M];
  __shared__ float sh_s[kSqTile * M];

  const int i = blockIdx.x * kSqThreads + threadIdx.x;
  const bool row_ok = i < n_t;
  const float g = gamma[0];
  const float g2 = g * kLog2e;

  float th[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) th[t] = (t < T) ? thr[t] : 0.0f;

  float xi[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    xi[k] = row_ok ? targets[static_cast<size_t>(i) * M + k] : 0.0f;
  }

  float acc_s[M];
  float acc_d[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    acc_s[k] = 0.0f;
    acc_d[k] = 0.0f;
  }
  unsigned int cnt[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) cnt[t] = 0u;

  for (int j0 = 0; j0 < n_s; j0 += kSqTile) {
    const int tile_n = min(kSqTile, n_s - j0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < tile_n * M; e += kSqThreads) {
      sh_x[e] = sources[static_cast<size_t>(j0) * M + e];
      sh_s[e] = scores[static_cast<size_t>(j0) * M + e];
    }
    __syncthreads();
    if (row_ok) {
      for (int jj = 0; jj < tile_n; ++jj) {
        const float* sj = sh_s + jj * M;
        float d[M];
        const float sq = diff_sq<M>(xi, sh_x + jj * M, d);
        const float kv = exp2f(-g2 * sq);
#pragma unroll
        for (int k = 0; k < M; ++k) {
          acc_s[k] = fmaf(kv, sj[k], acc_s[k]);
          acc_d[k] = fmaf(kv, d[k], acc_d[k]);
        }
        count_pair(sq, th, T, cnt);
      }
    }
  }

  if (row_ok) {
    const float ns = static_cast<float>(n_s);
#pragma unroll
    for (int k = 0; k < M; ++k) {
      phi[static_cast<size_t>(i) * M + k] =
          (acc_s[k] + 2.0f * g * acc_d[k]) / ns;
    }
  }
  flush_counts(cnt, T, counts);
}

// ---------------------------------------------------------------------------
// fused_phi_counts_sym
//
// Replaces svgdcpp_tpu/ops/pallas_phi.py:_sym_kernel (the upper-triangle
// sweep, called through _phi_rbf_fused_pallas_sym_impl).
//
// Bound on this card: the same per-pair work as the square sweep (3m+1
// FLOPs for sq, one ex2, T compares), paid once per UNORDERED pair, plus
// 4m FMAs, m subtractions and one shared-memory store and load per pair
// for the two contraction directions. sq, ex2 and the compares, the
// SFU-heavy part, halve.
//
// Design: one block per upper-triangle tile pair (bi <= bj) of
// kSymTile x kSymTile particles, enumerated from a linear block index. On
// the diagonal tile only pairs j >= i are entered. Thread r owns row
// i = bi*T + r: it computes k_ij for the tile's columns, accumulates the
// row direction in registers, and stores k_ij to a padded shared tile
// (stride kSymTile+1: conflict-free by rows and by columns). Then thread r
// owns column j = bj*T + r and accumulates the column direction from that
// tile (pair (i, j) adds k s_i and k (x_j - x_i) to particle j). Both
// directions are flushed with float32 atomicAdd into a zeroed (2m, n)
// accumulator [KS | D] (coalesced: neighbouring threads, neighbouring
// particles). The diagonal pairs enter both directions: their D term is 0,
// and the wrapper's epilogue subtracts s_i once from KS (k_ii = 1 exactly),
// the JAX epilogue's "acc - B" restricted to the columns kept.
// The count buffer receives U, the upper count including the diagonal; the
// wrapper forms 2U - n. Float atomics make phi's summation order vary from
// run to run; the counts are integers and do not.
// ---------------------------------------------------------------------------

constexpr int kSymTile = 64;

__device__ __forceinline__ void decode_upper_pair(long long t, int nb, int* bi,
                                                  int* bj) {
  // Row i of the upper triangle holds nb - i tiles; rows before i hold
  // off(i) = i*nb - i*(i-1)/2. Solve off(i) <= t < off(i+1) in double, then
  // correct the rounding with integer steps.
  const double b = 2.0 * nb + 1.0;
  long long i = static_cast<long long>(
      floor((b - sqrt(b * b - 8.0 * static_cast<double>(t))) * 0.5));
  if (i < 0) i = 0;
  if (i > nb - 1) i = nb - 1;
  auto off = [nb](long long r) { return r * nb - r * (r - 1) / 2; };
  while (i > 0 && off(i) > t) --i;
  while (i + 1 < nb && off(i + 1) <= t) ++i;
  *bi = static_cast<int>(i);
  *bj = static_cast<int>(i + (t - off(i)));
}

template <int M>
__global__ void __launch_bounds__(kSymTile)
    fused_phi_counts_sym_kernel(const float* __restrict__ coords,
                                const float* __restrict__ scores,
                                const float* __restrict__ gamma,
                                const float* __restrict__ thr, int n, int T,
                                int nb, float* __restrict__ acc,
                                unsigned long long* __restrict__ counts) {
  __shared__ float sh_k[kSymTile][kSymTile + 1];
  __shared__ float sh_xi[kSymTile * M];
  __shared__ float sh_si[kSymTile * M];
  __shared__ float sh_xj[kSymTile * M];
  __shared__ float sh_sj[kSymTile * M];

  int bi, bj;
  decode_upper_pair(static_cast<long long>(blockIdx.x), nb, &bi, &bj);
  const int r = threadIdx.x;
  const int i0 = bi * kSymTile;
  const int j0 = bj * kSymTile;

  for (int e = r; e < kSymTile * M; e += kSymTile) {
    const int p = e / M;
    const bool ok_i = i0 + p < n;
    const bool ok_j = j0 + p < n;
    sh_xi[e] = ok_i ? coords[static_cast<size_t>(i0) * M + e] : 0.0f;
    sh_si[e] = ok_i ? scores[static_cast<size_t>(i0) * M + e] : 0.0f;
    sh_xj[e] = ok_j ? coords[static_cast<size_t>(j0) * M + e] : 0.0f;
    sh_sj[e] = ok_j ? scores[static_cast<size_t>(j0) * M + e] : 0.0f;
  }
  __syncthreads();

  const float g2 = gamma[0] * kLog2e;
  float th[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) th[t] = (t < T) ? thr[t] : 0.0f;

  // Row direction: thread r owns particle i.
  const int i = i0 + r;
  const bool row_ok = i < n;
  float xi[M];
#pragma unroll
  for (int k = 0; k < M; ++k) xi[k] = sh_xi[r * M + k];
  float acc_s[M];
  float acc_d[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    acc_s[k] = 0.0f;
    acc_d[k] = 0.0f;
  }
  unsigned int cnt[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) cnt[t] = 0u;

  for (int jj = 0; jj < kSymTile; ++jj) {
    const int j = j0 + jj;
    float kv = 0.0f;
    if (row_ok && j < n && j >= i) {
      const float* sj = sh_sj + jj * M;
      float d[M];
      const float sq = diff_sq<M>(xi, sh_xj + jj * M, d);
      kv = exp2f(-g2 * sq);
#pragma unroll
      for (int k = 0; k < M; ++k) {
        acc_s[k] = fmaf(kv, sj[k], acc_s[k]);
        acc_d[k] = fmaf(kv, d[k], acc_d[k]);
      }
      count_pair(sq, th, T, cnt);
    }
    sh_k[r][jj] = kv;
  }
  if (row_ok) {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      atomicAdd(acc + static_cast<size_t>(k) * n + i, acc_s[k]);
      atomicAdd(acc + static_cast<size_t>(M + k) * n + i, acc_d[k]);
    }
  }
  flush_counts(cnt, T, counts);
  __syncthreads();  // the k tile is complete

  // Column direction: thread r owns particle j. Masked pairs hold k = 0.
  const int j = j0 + r;
  if (j < n) {
    float xj[M];
#pragma unroll
    for (int k = 0; k < M; ++k) xj[k] = sh_xj[r * M + k];
    float col_s[M];
    float col_d[M];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      col_s[k] = 0.0f;
      col_d[k] = 0.0f;
    }
    for (int ii = 0; ii < kSymTile; ++ii) {
      const float kv = sh_k[ii][r];
      const float* x_i = sh_xi + ii * M;
      const float* s_i = sh_si + ii * M;
#pragma unroll
      for (int k = 0; k < M; ++k) {
        col_s[k] = fmaf(kv, s_i[k], col_s[k]);
        col_d[k] = fmaf(kv, xj[k] - x_i[k], col_d[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < M; ++k) {
      atomicAdd(acc + static_cast<size_t>(k) * n + j, col_s[k]);
      atomicAdd(acc + static_cast<size_t>(M + k) * n + j, col_d[k]);
    }
  }
}

}  // namespace

#define SVGD_DISPATCH_M(m, LAUNCH) \
  switch (m) {                     \
    case 1: LAUNCH(1); break;      \
    case 2: LAUNCH(2); break;      \
    case 3: LAUNCH(3); break;      \
    case 4: LAUNCH(4); break;      \
    case 5: LAUNCH(5); break;      \
    case 6: LAUNCH(6); break;      \
    case 7: LAUNCH(7); break;      \
    case 8: LAUNCH(8); break;      \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

extern "C" {

// phi (n_t, m) and counts (T,) of the square/cross sweep. targets (n_t, m)
// and sources (n_s, m) centered on the source mean, scores (n_s, m), all
// float32 row-major; gamma (1,), thr (T,) float32 on the device; counts
// zeroed int64. 1 <= m <= 8, 1 <= T <= 8.
int svgd_fused_phi_counts_square(const float* targets, const float* sources,
                                 const float* scores, const float* gamma,
                                 const float* thr, int n_t, int n_s, int m,
                                 int T, float* phi, long long* counts,
                                 void* stream) {
  if (n_t <= 0 || n_s <= 0 || T < 1 || T > kMaxT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n_t + kSqThreads - 1) / kSqThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_SQUARE(M_)                                           \
  fused_phi_counts_square_kernel<M_><<<grid, kSqThreads, 0, s>>>(        \
      targets, sources, scores, gamma, thr, n_t, n_s, T, phi, c)
  SVGD_DISPATCH_M(m, SVGD_LAUNCH_SQUARE)
#undef SVGD_LAUNCH_SQUARE
  return static_cast<int>(cudaGetLastError());
}

// Upper-triangle sweep over one particle set. coords (n, m) centered,
// scores (n, m), gamma (1,), thr (T,) float32 on the device; acc a zeroed
// (2m, n) float32 accumulator [KS | D]; counts a zeroed int64 (T,) buffer that
// receives the upper count U (diagonal included).
int svgd_fused_phi_counts_sym(const float* coords, const float* scores,
                              const float* gamma, const float* thr, int n,
                              int m, int T, float* acc, long long* counts,
                              void* stream) {
  if (n <= 0 || T < 1 || T > kMaxT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nb = (n + kSymTile - 1) / kSymTile;
  const long long pairs = static_cast<long long>(nb) * (nb + 1) / 2;
  if (pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(pairs));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_SYM(M_)                                             \
  fused_phi_counts_sym_kernel<M_><<<grid, kSymTile, 0, s>>>(            \
      coords, scores, gamma, thr, n, T, nb, acc, c)
  SVGD_DISPATCH_M(m, SVGD_LAUNCH_SYM)
#undef SVGD_LAUNCH_SYM
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
