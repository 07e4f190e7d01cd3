// Fused phi + median-count sweeps of a COMPOSED isotropic RBF kernel, for
// Hopper (sm_90a).
//
// A `+ - * /` composition of Gaussian RBF kernels whose slots are all
// isotropic flattens to a signed sum of terms (kernels/algebra.py),
//
//   k(x_i, x_j) = sum_t s_t exp(-gamma_t sq_ij),   t < nterms <= 16,
//
// and every term shares the pair's squared distance sq. One O(n^2) pass
// computes, per pair, the T_terms exponentials once and combines them into
//
//   k_c = sum_t s_t k_t            w = sum_t s_t gamma_t k_t,
//
// accumulates KS_i = sum_j k_c s_j and D_i = sum_j w (x_i - x_j), and counts
// the pair squared distances at or below each threshold, so
//
//   phi_i = (KS_i + 2 D_i) / n_s.
//
// This is the plain version's form (ops/phi.phi_rbf_terms_cross_fused_counts)
// with D accumulated from the differences, as fused_phi.cu does: the Pallas
// kernels' KX - rowsum * x epilogue cancels in float32.
//
// Replaces four Pallas kernels of svgdcpp_tpu/ops/pallas_phi.py. The TPU
// splits each shape into a "direct" kernel (one accumulator band per term,
// combined in the epilogue) and a k_c/w kernel, and picks between them by
// the VMEM budget of the accumulator (_terms_direct_fits). On this card the
// accumulator lives in device memory and the split has no reason to exist:
//
//   * fused_phi_terms_square replaces _fused_terms_direct_kernel (K6) and
//     _fused_terms_kernel (K7), the square/cross sweeps;
//   * fused_phi_terms_sym replaces _sym_terms_direct_kernel (K8, both of its
//     masked and unmasked calls) and _sym_terms_kernel (K9), the
//     upper-triangle sweeps; its kernel, in terms_sym.cuh, also serves the
//     anisotropic sweep (fused_phi_aniso.cu) with more term groups;
//   * fused_phi_terms_sym_chunk replaces the same two Pallas kernels as the
//     sharded engine calls them on one device's chunk of the GLOBAL triangle
//     (K10 through phi_rbf_terms_fused_pallas_sym_sharded_direct, K11
//     through _phi_rbf_terms_fused_pallas_sym_sharded_impl; the JAX split by
//     _terms_direct_fits_npad is a VMEM choice): terms_sym.cuh's body under
//     its own name over a range [t0, t0 + count) of the tile list
//     (ops/sym_plan.sym_tile_chunk), whose raw accumulator and upper count
//     the caller sums over the ranks.
//
// Bound on this card: per pair 3m+1 FLOPs for sq, nterms ex2 on the special
// function unit (a quarter of the FP32 rate) plus 4 FP32 ops per term to
// combine, 3m FP32 ops for the two contractions and T compares. At m = 11
// and two terms the SFU and the FP32 pipes share the work; memory traffic
// is a few hundred KB per sweep, so the sweep is compute-bound.
//
// The gammas are read from device memory (they come out of the median
// update as device scalars; the host never reads them); the signs are
// static and arrive by value in the launch parameters; the thresholds are
// read from device memory. Coordinates arrive centered on the source mean.
// The kernels allocate nothing: the wrapper (ops/cuda_phi.py) passes zeroed
// count and accumulator buffers. Each entry point returns cudaGetLastError()
// after its launch.

#define SVGD_TERMS_SYM_KERNEL fused_phi_terms_sym_kernel
#include "terms_sym.cuh"
#define SVGD_TERMS_SYM_KERNEL fused_phi_terms_sym_chunk_kernel
#include "terms_sym.cuh"

namespace {

using namespace svgd;

// ---------------------------------------------------------------------------
// fused_phi_terms_square (K6, K7)
//
// fused_phi_counts_square's design (fused_phi.cu) with the term
// combination: one thread owns one target row and keeps KS, D (2m values)
// and its T counts in registers; a block of kSqThreads targets walks all
// sources in shared-memory tiles.
// ---------------------------------------------------------------------------

template <int MM, bool kExact>
__global__ void __launch_bounds__(kSqThreads)
    fused_phi_terms_square_kernel(const float* __restrict__ targets,
                                  const float* __restrict__ sources,
                                  const float* __restrict__ scores,
                                  const float* __restrict__ gammas,
                                  TermSigns signs, int nterms,
                                  const float* __restrict__ thr, int n_t,
                                  int n_s, int m_arg, int T,
                                  float* __restrict__ phi,
                                  unsigned long long* __restrict__ counts) {
  constexpr int kTile = SqTile<MM>::value;
  __shared__ float sh_x[kTile * MM];
  __shared__ float sh_s[kTile * MM];
  __shared__ float sh_g2[kMaxTerms];
  __shared__ float sh_sn[kMaxTerms];
  __shared__ float sh_sg[kMaxTerms];

  load_terms(gammas, signs, nterms, sh_g2, sh_sn, sh_sg);

  const int m = kExact ? MM : m_arg;
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
    __syncthreads();  // the previous tile is consumed (and the terms loaded)
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
        float kc, w;
        combine_terms(sq, nterms, sh_g2, sh_sn, sh_sg, &kc, &w);
#pragma unroll
        for (int k = 0; k < MM; ++k) {
          if (kExact || k < m) {
            acc_s[k] = fmaf(kc, sj[k], acc_s[k]);
            acc_d[k] = fmaf(w, __fsub_rn(xi[k], xj[k]), acc_d[k]);
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
            (acc_s[k] + 2.0f * acc_d[k]) / ns;
      }
    }
  }
  flush_counts(cnt, T, counts);
}

}  // namespace

extern "C" {

// phi (n_t, m) and counts (T,) of the composed-kernel square/cross sweep.
// targets (n_t, m) and sources (n_s, m) centered on the source mean, scores
// (n_s, m), all float32 row-major on the device; gammas (nterms,) float32 on
// the device; signs (nterms,) a HOST array, passed by value to the kernel;
// thr (T,) float32 on the device; counts zeroed int64. 1 <= m <= 64,
// 1 <= nterms <= 16, 1 <= T <= 8.
int svgd_fused_phi_terms_square(const float* targets, const float* sources,
                                const float* scores, const float* gammas,
                                const float* signs, int nterms,
                                const float* thr, int n_t, int n_s, int m,
                                int T, float* phi, long long* counts,
                                void* stream) {
  if (n_t <= 0 || n_s <= 0 || T < 1 || T > kMaxT || nterms < 1 ||
      nterms > kMaxTerms) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TermSigns sg = make_signs(signs, nterms);
  const dim3 grid((n_t + kSqThreads - 1) / kSqThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_TERMS_SQUARE(MM_, EX_)                                \
  fused_phi_terms_square_kernel<MM_, EX_><<<grid, kSqThreads, 0, s>>>(    \
      targets, sources, scores, gammas, sg, nterms, thr, n_t, n_s, m, T,  \
      phi, c)
  SVGD_DISPATCH_M(m, SVGD_LAUNCH_TERMS_SQUARE)
#undef SVGD_LAUNCH_TERMS_SQUARE
  return static_cast<int>(cudaGetLastError());
}

// Composed-kernel upper-triangle sweep over one particle set. coords (n, m)
// centered, scores (n, m), gammas (nterms,), thr (T,) float32 on the device;
// signs (nterms,) a host array; acc a zeroed (2m, n) float32 accumulator
// [KS | D]; counts a zeroed int64 (T,) buffer that receives the upper count
// U (diagonal included). 1 <= m <= 64, 1 <= nterms <= 16, 1 <= T <= 8.
int svgd_fused_phi_terms_sym(const float* coords, const float* scores,
                             const float* gammas, const float* signs,
                             int nterms, const float* thr, int n, int m,
                             int T, float* acc, long long* counts,
                             void* stream) {
  if (n <= 0 || T < 1 || T > kMaxT || nterms < 1 || nterms > kMaxTerms) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TermSigns sg = make_signs(signs, nterms);
  const AnisoSigns none{};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_TERMS_SYM(MM_, EX_)                                    \
  {                                                                        \
    constexpr int tile = SymTermsTile<MM_>::value;                         \
    const long long pairs = upper_pairs(n, tile);                          \
    if (pairs < 0) return static_cast<int>(cudaErrorInvalidValue);        \
    fused_phi_terms_sym_kernel<MM_, EX_, false>                            \
        <<<static_cast<unsigned int>(pairs), tile, 0, s>>>(                \
            coords, nullptr, scores, gammas, sg, nterms, none, thr, n, m,  \
            T, (n + tile - 1) / tile, 0LL, acc, c);                        \
  }
  SVGD_DISPATCH_M(m, SVGD_LAUNCH_TERMS_SYM)
#undef SVGD_LAUNCH_TERMS_SYM
  return static_cast<int>(cudaGetLastError());
}

// One rank's chunk of the composed-kernel triangle sweep: tiles
// [t0, t0 + count) of the tile list (SymTermsTile<MM> particles a side), the
// arguments otherwise as svgd_fused_phi_terms_sym's. coords and scores are
// the GLOBAL set, centered on its mean; acc (2m, n) and counts receive this
// chunk's raw sums. count = 0 launches nothing.
int svgd_fused_phi_terms_sym_chunk(const float* coords, const float* scores,
                                   const float* gammas, const float* signs,
                                   int nterms, const float* thr, int n, int m,
                                   int T, long long t0, long long count,
                                   float* acc, long long* counts,
                                   void* stream) {
  if (n <= 0 || T < 1 || T > kMaxT || nterms < 1 || nterms > kMaxTerms) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TermSigns sg = make_signs(signs, nterms);
  const AnisoSigns none{};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_TERMS_SYM_CHUNK(MM_, EX_)                              \
  {                                                                        \
    constexpr int tile = SymTermsTile<MM_>::value;                         \
    if (!tile_range_ok(n, tile, t0, count)) {                              \
      return static_cast<int>(cudaErrorInvalidValue);                      \
    }                                                                      \
    if (count > 0) {                                                       \
      fused_phi_terms_sym_chunk_kernel<MM_, EX_, false>                    \
          <<<static_cast<unsigned int>(count), tile, 0, s>>>(              \
              coords, nullptr, scores, gammas, sg, nterms, none, thr, n,   \
              m, T, (n + tile - 1) / tile, t0, acc, c);                    \
    }                                                                      \
  }
  SVGD_DISPATCH_M(m, SVGD_LAUNCH_TERMS_SYM_CHUNK)
#undef SVGD_LAUNCH_TERMS_SYM_CHUNK
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
