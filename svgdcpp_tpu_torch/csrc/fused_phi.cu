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
// sq is summed in the plain torch version's order with its roundings
// (sweep_common.cuh); at m <= 4, where the plain version also uses the
// difference form, the counts of both are equal.
//
// Every m from 1 to 64 runs: exact instances for m = 1..8, 11 and 50, a
// runtime-m instance for the rest (sweep_common.cuh). Each thread keeps its
// target's coordinates and 2m accumulators in registers, so at m = 50 a
// thread holds about 150 live floats; ptxas's report (-Xptxas -v, kept in
// the build log) says whether an instance spills.
//
// The kernels allocate nothing: the wrapper (ops/cuda_phi.py) passes zeroed
// count and accumulator buffers. Each entry point returns
// cudaGetLastError() after its launch.

#include "sweep_common.cuh"

namespace {

using namespace svgd;

// ---------------------------------------------------------------------------
// fused_phi_counts_square
//
// Replaces svgdcpp_tpu/ops/pallas_phi.py:_fused_kernel (the square/cross
// sweep, called through _phi_rbf_fused_pallas_cross_impl).
//
// Bound on this card: per pair 3m+1 FLOPs for sq, one ex2 on the special
// function unit (a quarter of the FP32 rate), 3m FP32 ops for the two
// contractions and T compares; the operands are a few hundred KB, so the
// sweep is compute-bound on the FP32 pipes and the SFU, not on memory.
//
// Design: one thread owns one target row and keeps KS, D (2m values) and
// its T counts in registers, so nothing per pair leaves the SM. A block of
// kSqThreads targets walks all sources in shared-memory tiles (each source
// is read once per block and broadcast to every thread); the tile is
// shorter for wide m so that both tiles stay within 48 KB of static shared
// memory. The epilogue writes phi directly; ragged edges are bounds checks,
// not padding.
// ---------------------------------------------------------------------------

template <int MM, bool kExact>
__global__ void __launch_bounds__(kSqThreads)
    fused_phi_counts_square_kernel(const float* __restrict__ targets,
                                   const float* __restrict__ sources,
                                   const float* __restrict__ scores,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ thr, int n_t,
                                   int n_s, int m_arg, int T,
                                   float* __restrict__ phi,
                                   unsigned long long* __restrict__ counts) {
  constexpr int kTile = SqTile<MM>::value;
  __shared__ float sh_x[kTile * MM];
  __shared__ float sh_s[kTile * MM];

  const int m = kExact ? MM : m_arg;
  const int i = blockIdx.x * kSqThreads + threadIdx.x;
  const bool row_ok = i < n_t;
  const float g = gamma[0];
  const float g2 = g * kLog2e;

  float th[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) th[t] = (t < T) ? thr[t] : 0.0f;

  float xi[MM];
  float acc_s[MM];
  float acc_d[MM];
#pragma unroll
  for (int k = 0; k < MM; ++k) {
    xi[k] = (row_ok && (kExact || k < m))
                ? targets[static_cast<size_t>(i) * m + k]
                : 0.0f;
    acc_s[k] = 0.0f;
    acc_d[k] = 0.0f;
  }
  unsigned int cnt[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) cnt[t] = 0u;

  for (int j0 = 0; j0 < n_s; j0 += kTile) {
    const int tile_n = min(kTile, n_s - j0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < tile_n * m; e += kSqThreads) {
      sh_x[e] = sources[static_cast<size_t>(j0) * m + e];
      sh_s[e] = scores[static_cast<size_t>(j0) * m + e];
    }
    __syncthreads();
    if (row_ok) {
      for (int jj = 0; jj < tile_n; ++jj) {
        const float* xj = sh_x + jj * m;
        const float* sj = sh_s + jj * m;
        const float sq = pair_sq<MM, kExact>(xi, xj, m);
        const float kv = exp2f(-g2 * sq);
#pragma unroll
        for (int k = 0; k < MM; ++k) {
          if (kExact || k < m) {
            acc_s[k] = fmaf(kv, sj[k], acc_s[k]);
            acc_d[k] = fmaf(kv, __fsub_rn(xi[k], xj[k]), acc_d[k]);
          }
        }
        count_pair(sq, th, T, cnt);
      }
    }
  }

  if (row_ok) {
    const float ns = static_cast<float>(n_s);
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      if (kExact || k < m) {
        phi[static_cast<size_t>(i) * m + k] =
            (acc_s[k] + 2.0f * g * acc_d[k]) / ns;
      }
    }
  }
  flush_counts(cnt, T, counts);
}

}  // namespace

// ---------------------------------------------------------------------------
// fused_phi_counts_sym and fused_phi_counts_sym_chunk
//
// fused_phi_counts_sym replaces svgdcpp_tpu/ops/pallas_phi.py:_sym_kernel
// (the upper-triangle sweep, called through _phi_rbf_fused_pallas_sym_impl:
// K2). fused_phi_counts_sym_chunk replaces the same Pallas kernel as
// phi_rbf_fused_pallas_sym_sharded calls it (K4): one device's chunk of the
// GLOBAL triangle, here a contiguous range [t0, t0 + count) of the tile
// list (ops/sym_plan.sym_tile_chunk), whose raw accumulator and upper count
// the caller sums over the ranks before one epilogue. Both are the body in
// counts_sym.cuh under their own names.
//
// Bound on this card: the same per-pair work as the square sweep (3m+1
// FLOPs for sq, one ex2, T compares), paid once per UNORDERED pair, plus
// 4m FMAs, m subtractions and one shared-memory store and load per pair
// for the two contraction directions. sq, ex2 and the compares, the
// SFU-heavy part, halve.
// ---------------------------------------------------------------------------

#define SVGD_COUNTS_SYM_KERNEL fused_phi_counts_sym_kernel
#include "counts_sym.cuh"
#define SVGD_COUNTS_SYM_KERNEL fused_phi_counts_sym_chunk_kernel
#include "counts_sym.cuh"

extern "C" {

// phi (n_t, m) and counts (T,) of the square/cross sweep. targets (n_t, m)
// and sources (n_s, m) centered on the source mean, scores (n_s, m), all
// float32 row-major; gamma (1,), thr (T,) float32 on the device; counts
// zeroed int64. 1 <= m <= 64, 1 <= T <= 8.
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
#define SVGD_LAUNCH_SQUARE(MM_, EX_)                                    \
  fused_phi_counts_square_kernel<MM_, EX_><<<grid, kSqThreads, 0, s>>>( \
      targets, sources, scores, gamma, thr, n_t, n_s, m, T, phi, c)
  SVGD_DISPATCH_M(m, SVGD_LAUNCH_SQUARE)
#undef SVGD_LAUNCH_SQUARE
  return static_cast<int>(cudaGetLastError());
}

// Upper-triangle sweep over one particle set. coords (n, m) centered,
// scores (n, m), gamma (1,), thr (T,) float32 on the device; acc a zeroed
// (2m, n) float32 accumulator [KS | D]; counts a zeroed int64 (T,) buffer that
// receives the upper count U (diagonal included). 1 <= m <= 64.
int svgd_fused_phi_counts_sym(const float* coords, const float* scores,
                              const float* gamma, const float* thr, int n,
                              int m, int T, float* acc, long long* counts,
                              void* stream) {
  if (n <= 0 || T < 1 || T > kMaxT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_SYM(MM_, EX_)                                          \
  {                                                                        \
    constexpr int tile = SymTile<MM_>::value;                              \
    const long long pairs = upper_pairs(n, tile);                          \
    if (pairs < 0) return static_cast<int>(cudaErrorInvalidValue);        \
    fused_phi_counts_sym_kernel<MM_, EX_>                                  \
        <<<static_cast<unsigned int>(pairs), tile, 0, s>>>(                \
            coords, scores, gamma, thr, n, m, T, (n + tile - 1) / tile,    \
            0LL, acc, c);                                                  \
  }
  SVGD_DISPATCH_M(m, SVGD_LAUNCH_SYM)
#undef SVGD_LAUNCH_SYM
  return static_cast<int>(cudaGetLastError());
}

// One rank's chunk of the upper-triangle sweep: tiles [t0, t0 + count) of
// the triangle's tile list (SymTile<MM> particles a side for this m), the
// arguments otherwise as svgd_fused_phi_counts_sym's. coords and scores are
// the GLOBAL set, centered on its mean; acc (2m, n) and counts receive this
// chunk's raw sums. count = 0 launches nothing.
int svgd_fused_phi_counts_sym_chunk(const float* coords, const float* scores,
                                    const float* gamma, const float* thr,
                                    int n, int m, int T, long long t0,
                                    long long count, float* acc,
                                    long long* counts, void* stream) {
  if (n <= 0 || T < 1 || T > kMaxT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_SYM_CHUNK(MM_, EX_)                                    \
  {                                                                        \
    constexpr int tile = SymTile<MM_>::value;                              \
    if (!tile_range_ok(n, tile, t0, count)) {                              \
      return static_cast<int>(cudaErrorInvalidValue);                      \
    }                                                                      \
    if (count > 0) {                                                       \
      fused_phi_counts_sym_chunk_kernel<MM_, EX_>                          \
          <<<static_cast<unsigned int>(count), tile, 0, s>>>(              \
              coords, scores, gamma, thr, n, m, T, (n + tile - 1) / tile,  \
              t0, acc, c);                                                 \
    }                                                                      \
  }
  SVGD_DISPATCH_M(m, SVGD_LAUNCH_SYM_CHUNK)
#undef SVGD_LAUNCH_SYM_CHUNK
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

namespace {

// The tile side of the triangle instance SVGD_DISPATCH_M picks for m.
int sym_tile_of(int m, int terms, int* tile) {
#define SVGD_SYM_TILE(MM_, EX_) \
  *tile = terms ? SymTermsTile<MM_>::value : SymTile<MM_>::value
  SVGD_DISPATCH_M(m, SVGD_SYM_TILE)
#undef SVGD_SYM_TILE
  return 0;
}

}  // namespace

extern "C" {

// The side of the tiles in the triangle chunk kernels' tile list for
// dimension m: svgd_fused_phi_counts_sym_chunk's (terms = 0) or
// svgd_fused_phi_terms_sym_chunk's (terms = 1). A rank's [t0, t0 + count)
// is a range of this list. -1 for an m outside 1..64.
int svgd_sym_tile(int m, int terms) {
  int tile = -1;
  sym_tile_of(m, terms, &tile);
  return tile;
}

}  // extern "C"
