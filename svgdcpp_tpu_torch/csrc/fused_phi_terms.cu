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
// The triangle sweeps and the square sweep up to m = 4 accumulate D from
// the differences, the plain version's form at m <= 4
// (ops/phi.phi_rbf_terms_cross_fused_counts). From m = 5 the square sweep
// takes the plain version's form at those widths, the Gram sq and
// D = rowsum_w x - WX, on the tensor cores in 3xTF32 (square_mma.cuh); the
// centring keeps the subtraction's cancellation at float32 level.
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
//     upper-triangle sweeps;
//   * fused_phi_terms_sym_chunk replaces the same two Pallas kernels as the
//     sharded engine calls them on one device's chunk of the GLOBAL triangle
//     (K10 through phi_rbf_terms_fused_pallas_sym_sharded_direct, K11
//     through _phi_rbf_terms_fused_pallas_sym_sharded_impl; the JAX split by
//     _terms_direct_fits_npad is a VMEM choice): the same body under its
//     own name over a range [t0, t0 + count) of the tile list
//     (ops/sym_plan.sym_tile_chunk), whose raw accumulator and upper count
//     the caller sums over the ranks.
//
// Bound of the triangle sweeps on this card (the square sweep's is in
// square_mma.cuh): per unordered pair 3m FP32 operations for the
// difference and sq (rounded term by term, so that the counts equal the
// plain version's), one ex2 on the special function unit and 4 FP32
// operations per term to combine, 4m FMAs into both directions and T
// compares; the operands are a few hundred KB, so the sweep is bound by
// instruction issue. At m = 11, T = 3 with two terms the floor is 91
// instructions a pair (33 for sq, 8 for the terms, 44 FMAs, 6 for the
// counts).
//
// The triangle's body at m = 1-8 and 11 (TermsTriTile) is the micro-tile
// body of the panel kernels (micro_tile.cuh, micro_tri_body): the triangle
// is cut into tiles of 128 particles, a block sweeps one tile pair (bi <=
// bj) of the tile list with 2 warps of 2 rows a thread (one warp of 4 rows
// up to m = 2), the pair's weights in registers feeding both directions,
// the terms' constants in registers for two terms (FixedTerms<2>) and in
// shared memory for any other count (AnyTerms), T compile-time at T = 3
// (a runtime T <= 8 runs the 8-threshold instance), interior chunks
// unmasked, the column sums rotating between lanes at m = 11. Rows and
// columns flush with float32 atomics; a small launch splits a tile pair's
// chunks over the grid's second dimension (tri_splits). At n = 10,000 the
// 3160 tile pairs fill 132 SMs about 6 times. At the other widths (m = 9,
// 10, 12-64, whose rows the micro-tile would spill) the kernel keeps the
// one-row-a-thread body of terms_sym.cuh in tiles of SymTermsTile, and
// past m = 64 wide_tri_sm90.cuh's tensor-core body in tiles of 128 (one
// persistent block an SM; k_c in the weight tile for the scores, then w
// for the coordinates), under the same names. The tile side of each instance
// is svgd_sym_tile's (fused_phi.cu), which the chunk wrappers read.
//
// The gammas are read from device memory (they come out of the median
// update as device scalars; the host never reads them); the signs are
// static and arrive by value in the launch parameters; the thresholds are
// read from device memory. Coordinates arrive centered on the source mean.
// The kernels allocate nothing: the wrapper (ops/cuda_phi.py) passes zeroed
// count and accumulator buffers and the square sweep's workspace. Each entry
// point returns cudaGetLastError() after its launches.

#include <type_traits>

#include "micro_tile.cuh"
#include "square_mma.cuh"
#include "square_wide_sm90.cuh"
#include "wide_tri_sm90.cuh"

#define SVGD_TERMS_SYM_KERNEL fused_phi_terms_sym_kernel
#include "terms_sym.cuh"
#define SVGD_TERMS_SYM_KERNEL fused_phi_terms_sym_chunk_kernel
#include "terms_sym.cuh"

namespace {

using namespace svgd;

// ---------------------------------------------------------------------------
// fused_phi_terms_sym and _sym_chunk at m = 1-8 and 11 (K8/K9, K10/K11):
// micro_tri_body with the terms' weights, kT thresholds (3, or kMaxT for a
// runtime T) and NTerms terms (2 in registers, or 0 for any count in
// shared memory). The kernels overload terms_sym.cuh's wider instances, so
// a trace names both bodies alike.
// ---------------------------------------------------------------------------

template <int MM, bool kExact, int kT, int NTerms>
__device__ __forceinline__ void terms_tri(
    const float* __restrict__ coords, const float* __restrict__ scores,
    const float* __restrict__ gammas, const TermSigns& signs, int nterms,
    const float* __restrict__ thr, int n, int m_arg, int T, int nb,
    long long t0, long long count, float* __restrict__ acc,
    unsigned long long* __restrict__ counts) {
  auto body = [&](const auto& weights) {
    if constexpr (MM == kWideMM) {
      wide_tri_sm90_body<kT>(coords, scores, weights, thr, n, m_arg, T, nb,
                             t0, count, acc, counts);
    } else {
      micro_tri_body<MM, kExact, kT>(coords, scores, weights, thr, n, m_arg,
                                     T, nb, t0, acc, counts);
    }
  };
  if constexpr (NTerms > 0) {
    body(FixedTerms<NTerms>(gammas, signs));
  } else {
    __shared__ float sh_g2[kMaxTerms];
    __shared__ float sh_sn[kMaxTerms];
    __shared__ float sh_sg[kMaxTerms];
    // The body's first barrier comes before its first pair.
    load_terms(gammas, signs, nterms, sh_g2, sh_sn, sh_sg);
    body(AnyTerms{sh_g2, sh_sn, sh_sg, nterms});
  }
}

template <int MM, bool kExact, int kT, int NTerms>
__global__ void __launch_bounds__(TriThreads<MM>::value)
    fused_phi_terms_sym_kernel(const float* __restrict__ coords,
                               const float* __restrict__ scores,
                               const float* __restrict__ gammas,
                               TermSigns signs, int nterms,
                               const float* __restrict__ thr, int n,
                               int m_arg, int T, int nb, long long t0,
                               long long count, float* __restrict__ acc,
                               unsigned long long* __restrict__ counts) {
  terms_tri<MM, kExact, kT, NTerms>(coords, scores, gammas, signs, nterms,
                                    thr, n, m_arg, T, nb, t0, count, acc,
                                    counts);
}

template <int MM, bool kExact, int kT, int NTerms>
__global__ void __launch_bounds__(TriThreads<MM>::value)
    fused_phi_terms_sym_chunk_kernel(const float* __restrict__ coords,
                                     const float* __restrict__ scores,
                                     const float* __restrict__ gammas,
                                     TermSigns signs, int nterms,
                                     const float* __restrict__ thr, int n,
                                     int m_arg, int T, int nb, long long t0,
                                     long long count,
                                     float* __restrict__ acc,
                                     unsigned long long* __restrict__ counts) {
  terms_tri<MM, kExact, kT, NTerms>(coords, scores, gammas, signs, nterms,
                                    thr, n, m_arg, T, nb, t0, count, acc,
                                    counts);
}

// Launch of the terms triangle sweep over tiles [t0, t0 + count) of the
// tile list (TermsTriTile<MM> particles a side; count > 0): the wide
// body's instances past kMaxM (one persistent block an SM) and the
// micro-tile ones where they serve MM, each for T = 3 or any T <= 8 and for
// two terms or any count; terms_sym.cuh's body otherwise.
template <int MM, bool kExact>
void launch_terms_sym(bool chunk, const float* coords, const float* scores,
                      const float* gammas, const TermSigns& sg, int nterms,
                      const float* thr, int n, int m, int T, long long t0,
                      long long count, float* acc,
                      unsigned long long* counts, cudaStream_t s) {
  constexpr int tile = TermsTriTile<MM>::value;
  const int nb = (n + tile - 1) / tile;
  if constexpr (MM == kWideMM) {
    auto go = [&](auto kt, auto nt) {
      constexpr int kT = decltype(kt)::value;
      constexpr int NTerms = decltype(nt)::value;
      auto* kernel =
          chunk ? &fused_phi_terms_sym_chunk_kernel<MM, false, kT, NTerms>
                : &fused_phi_terms_sym_kernel<MM, false, kT, NTerms>;
      const unsigned int blocks = wide_sym_prepare<true>(kernel, count);
      kernel<<<blocks, kWideSymThreads, WideSym<true>::kSmemBytes, s>>>(
          coords, scores, gammas, sg, nterms, thr, n, m, T, nb, t0, count,
          acc, counts);
    };
    auto terms = [&](auto kt) {
      if (nterms == 2) {
        go(kt, std::integral_constant<int, 2>{});
      } else {
        go(kt, std::integral_constant<int, 0>{});
      }
    };
    if (T == 3) {
      terms(std::integral_constant<int, 3>{});
    } else {
      terms(std::integral_constant<int, kMaxT>{});
    }
  } else if constexpr (MicroTri<MM>::enabled) {
    const dim3 grid(static_cast<unsigned int>(count),
                    tri_splits<MM>(count));
    constexpr int threads = MicroTri<MM>::kThreads;
    auto go = [&](auto kt, auto nt) {
      constexpr int kT = decltype(kt)::value;
      constexpr int NTerms = decltype(nt)::value;
      if (chunk) {
        fused_phi_terms_sym_chunk_kernel<MM, kExact, kT, NTerms>
            <<<grid, threads, 0, s>>>(coords, scores, gammas, sg, nterms,
                                      thr, n, m, T, nb, t0, count, acc,
                                      counts);
      } else {
        fused_phi_terms_sym_kernel<MM, kExact, kT, NTerms>
            <<<grid, threads, 0, s>>>(coords, scores, gammas, sg, nterms,
                                      thr, n, m, T, nb, t0, count, acc,
                                      counts);
      }
    };
    auto terms = [&](auto kt) {
      if (nterms == 2) {
        go(kt, std::integral_constant<int, 2>{});
      } else {
        go(kt, std::integral_constant<int, 0>{});
      }
    };
    if (T == 3) {
      terms(std::integral_constant<int, 3>{});
    } else {
      terms(std::integral_constant<int, kMaxT>{});
    }
  } else {
    const AnisoSigns none{};
    const unsigned int blocks = static_cast<unsigned int>(count);
    if (chunk) {
      fused_phi_terms_sym_chunk_kernel<MM, kExact, false>
          <<<blocks, tile, 0, s>>>(coords, nullptr, scores, gammas, sg,
                                   nterms, none, thr, n, m, T, nb, t0, acc,
                                   counts);
    } else {
      fused_phi_terms_sym_kernel<MM, kExact, false>
          <<<blocks, tile, 0, s>>>(coords, nullptr, scores, gammas, sg,
                                   nterms, none, thr, n, m, T, nb, t0, acc,
                                   counts);
    }
  }
}

// ---------------------------------------------------------------------------
// fused_phi_terms_square (K6, K7)
//
// K1's design (square_mma.cuh) with the terms' weights, k_c for the scores
// and w for the coordinates: the sources split over the grid's y, each
// block's partials in the (splits, n_t, 2m + 1) workspace, summed in split
// order by the finishing pass (D scaled by 2: w carries the gammas). Up to
// m = 4 square_cuda_body, a row a thread on the CUDA cores, sq and D from
// differences ([KS | D]; counts equal to the plain version's); from m = 5
// square_mma_body, the Gram tile and both contractions in 3xTF32 mma.sync,
// the records in two bands [S | 0..] (A = k_c) and [X | 1 | 0..] (A = w)
// ([KS | WX | rowsum_w]). This replaces a body that held a row a thread at
// every m, one 128-thread block per 128 targets with every source (12
// blocks at n = 1500 for 132 SMs), all 4m FMAs a pair on the CUDA cores.
// The terms' constants sit in registers for two terms (FixedTerms<2>) and
// in shared memory for any other count (AnyTerms); tensor-core instances
// take T = 3 or any T <= 8 (kT 3 or kMaxT), at MM = 8, 11, 16, 32, 50, 64
// (SVGD_DISPATCH_SQ_MMA). Past m = 64 square_wide_sm90_body
// (square_wide_sm90.cuh) with a weight tile each for k_c and w, the record
// [S | 0.. | X | 0..] in two bands and the row sum of w from the weights.
// ---------------------------------------------------------------------------

// The CUDA-core body, at exactly MM coordinates, NTerms terms (2 in
// registers, or 0 for any count in shared memory).
template <int MM, int NTerms>
__global__ void __launch_bounds__(kSqThreads)
    fused_phi_terms_square_kernel(const float* __restrict__ targets,
                                  const float* __restrict__ sources,
                                  const float* __restrict__ scores,
                                  const float* __restrict__ gammas,
                                  TermSigns signs, int nterms,
                                  const float* __restrict__ thr, int n_t,
                                  int n_s, int T, int chunk,
                                  float* __restrict__ work,
                                  unsigned long long* __restrict__ counts) {
  if constexpr (NTerms > 0) {
    const FixedTerms<NTerms> weights(gammas, signs);
    square_cuda_body<MM>(targets, sources, scores, weights, thr, n_t, n_s, T,
                         chunk, work, counts);
  } else {
    __shared__ float sh_g2[kMaxTerms];
    __shared__ float sh_sn[kMaxTerms];
    __shared__ float sh_sg[kMaxTerms];
    // The body's first barrier comes before its first pair.
    load_terms(gammas, signs, nterms, sh_g2, sh_sn, sh_sg);
    const AnyTerms weights{sh_g2, sh_sn, sh_sg, nterms};
    square_cuda_body<MM>(targets, sources, scores, weights, thr, n_t, n_s, T,
                         chunk, work, counts);
  }
}

// The tensor-core body: kT thresholds (3, or kMaxT for a runtime T), NTerms
// terms as above; the wide body (square_wide_sm90_body, 512 threads) at
// MM = kWideMM, any m past kMaxM, m_arg being the padded row width there.
// The minimum of one block an SM changes ptxas's register target: without
// it, <MM = 8, T = 8, two terms> spilled 4 bytes at 72 registers; with it
// no instance spills (PERF.md, section 6).
template <int MM, bool kExact, int kT, int NTerms>
__global__ void __launch_bounds__(SqThreads<MM>::value, 1)
    fused_phi_terms_square_kernel(const float* __restrict__ targets,
                                  const float* __restrict__ sources,
                                  const float* __restrict__ scores,
                                  const float* __restrict__ gammas,
                                  TermSigns signs, int nterms,
                                  const float* __restrict__ thr, int n_t,
                                  int n_s, int m_arg, int T, int chunk,
                                  float* __restrict__ work,
                                  unsigned long long* __restrict__ counts) {
  const int w = 2 * (kExact ? MM : m_arg) + 1;
  float* part = work + static_cast<size_t>(blockIdx.y) * n_t * w;
  auto body = [&](const auto& weights) {
    if constexpr (MM == kWideMM) {
      square_wide_sm90_body<kT>(targets, sources, scores, weights, thr, n_t,
                                n_s, m_arg, T, chunk, part, counts);
    } else {
      square_mma_body<MM, kExact, kT>(targets, sources, scores, weights,
                                      thr, n_t, n_s, m_arg, T, chunk, part,
                                      counts);
    }
  };
  if constexpr (NTerms > 0) {
    body(FixedTerms<NTerms>(gammas, signs));
  } else {
    __shared__ float sh_g2[kMaxTerms];
    __shared__ float sh_sn[kMaxTerms];
    __shared__ float sh_sg[kMaxTerms];
    // The body's first barrier comes before its first pair.
    load_terms(gammas, signs, nterms, sh_g2, sh_sn, sh_sg);
    body(AnyTerms{sh_g2, sh_sn, sh_sg, nterms});
  }
}

// The finishing pass: D scaled by 2, the weights w carrying the gammas.
__global__ void fused_phi_terms_square_finish_kernel(
    const float* __restrict__ work, int splits, int n_t, int m, int rowsum,
    const float* __restrict__ targets, int n_s, float* __restrict__ phi) {
  square_finish(work, splits, n_t, m, rowsum, 2.0f, targets, n_s, phi);
}

// Static shared memory of the tensor-core kernel beside its dynamic share
// (the AnyTerms constants).
constexpr size_t kTermsSmemBytes = 3 * kMaxTerms * sizeof(float);

template <int MM, bool kExact>
int launch_terms_square_mma(const float* targets, const float* sources,
                            const float* scores, const float* gammas,
                            const TermSigns& sg, int nterms,
                            const float* thr, int n_t, int n_s, int m, int T,
                            int chunk, int splits, float* work,
                            unsigned long long* counts, cudaStream_t s) {
  // The wide body's plan: its rows a block, its passes along the grid's z
  // (1 up to m = 512) and its dynamic shared memory.
  constexpr bool wide = MM == kWideMM;
  const SqWidePlan wp = sq_wide_plan(wide ? m : 4, true);
  const size_t smem = wide ? wp.smem : SqMma<MM, true>::kSmemBytes;
  const int rows = wide ? wp.rows : kSqMmaRows;
  const dim3 grid((n_t + rows - 1) / rows, splits, wide ? wp.passes : 1);
  auto go = [&](auto kt, auto nt) {
    constexpr int kT = decltype(kt)::value;
    constexpr int NTerms = decltype(nt)::value;
    auto* kernel = &fused_phi_terms_square_kernel<MM, kExact, kT, NTerms>;
    if (smem + kTermsSmemBytes > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    kernel<<<grid, SqThreads<MM>::value, smem, s>>>(
        targets, sources, scores, gammas, sg, nterms, thr, n_t, n_s, m, T,
        chunk, work, counts);
    return 0;
  };
  auto terms = [&](auto kt) {
    return nterms == 2 ? go(kt, std::integral_constant<int, 2>{})
                       : go(kt, std::integral_constant<int, 0>{});
  };
  return T == 3 ? terms(std::integral_constant<int, 3>{})
                : terms(std::integral_constant<int, kMaxT>{});
}

}  // namespace

extern "C" {

// phi (n_t, m) and counts (T,) of the composed-kernel square/cross sweep.
// targets (n_t, m) and sources (n_s, m) centered on the source mean, scores
// (n_s, m), all float32 row-major on the device; gammas (nterms,) float32 on
// the device; signs (nterms,) a HOST array, passed by value to the kernel;
// thr (T,) float32 on the device; counts zeroed int64; work a float32
// workspace of (splits, n_t, 2m + 1), splits being svgd_square_splits(n_t,
// n_s, m) (fused_phi.cu). m >= 1, 1 <= nterms <= 16, 1 <= T <= 8.
// From m = kSquareTensorMinM the body copies sources and scores 16 bytes at
// a time (cp.async): both must start on a 16-byte boundary; past m = 64 the
// targets too, and m must be a multiple of 4 (the wrappers pad the rows
// with zero columns; phi then has the padded width, its padded columns 0).
int svgd_fused_phi_terms_square(const float* targets, const float* sources,
                                const float* scores, const float* gammas,
                                const float* signs, int nterms,
                                const float* thr, int n_t, int n_s, int m,
                                int T, float* phi, long long* counts,
                                float* work, int splits, void* stream) {
  if (n_t <= 0 || n_s <= 0 || T < 1 || T > kMaxT || m < 1 ||
      nterms < 1 || nterms > kMaxTerms) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool tensor = m >= kSquareTensorMinM;
  if (tensor && ((reinterpret_cast<uintptr_t>(sources) |
                  reinterpret_cast<uintptr_t>(scores)) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m > kMaxM && (!wide_rows_ok(m, sources, scores) ||
                    (reinterpret_cast<uintptr_t>(targets) & 15u) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int want = 0;
  const int chunk = square_plan_chunk(n_t, n_s, m, &want);
  if (splits != want) return static_cast<int>(cudaErrorInvalidValue);
  const TermSigns sg = make_signs(signs, nterms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  if (tensor) {
    int rc = 0;
#define SVGD_LAUNCH_TERMS_SQ_MMA(MM_, EX_)                                   \
  rc = launch_terms_square_mma<MM_, EX_>(targets, sources, scores, gammas,   \
                                         sg, nterms, thr, n_t, n_s, m, T,    \
                                         chunk, splits, work, c, s)
    SVGD_DISPATCH_SQ_MMA(m, SVGD_LAUNCH_TERMS_SQ_MMA)
#undef SVGD_LAUNCH_TERMS_SQ_MMA
    if (rc != 0) return rc;
  } else {
    const dim3 grid((n_t + kSqThreads - 1) / kSqThreads, splits);
#define SVGD_LAUNCH_TERMS_SQUARE(MM_)                                        \
  if (nterms == 2) {                                                         \
    fused_phi_terms_square_kernel<MM_, 2><<<grid, kSqThreads, 0, s>>>(       \
        targets, sources, scores, gammas, sg, nterms, thr, n_t, n_s, T,      \
        chunk, work, c);                                                     \
  } else {                                                                   \
    fused_phi_terms_square_kernel<MM_, 0><<<grid, kSqThreads, 0, s>>>(       \
        targets, sources, scores, gammas, sg, nterms, thr, n_t, n_s, T,      \
        chunk, work, c);                                                     \
  }
    SVGD_DISPATCH_SQ_CUDA_CORES(m, SVGD_LAUNCH_TERMS_SQUARE)
#undef SVGD_LAUNCH_TERMS_SQUARE
  }
  const long long outs = static_cast<long long>(n_t) * m;
  fused_phi_terms_square_finish_kernel<<<
      static_cast<unsigned int>((outs + kSqFinishThreads - 1) /
                                kSqFinishThreads),
      kSqFinishThreads, 0, s>>>(work, splits, n_t, m, tensor ? 1 : 0,
                                targets, n_s, phi);
  return static_cast<int>(cudaGetLastError());
}

// Composed-kernel upper-triangle sweep over one particle set. coords (n, m)
// centered, scores (n, m), gammas (nterms,), thr (T,) float32 on the device;
// signs (nterms,) a host array; acc a zeroed (2m, n) float32 accumulator
// [KS | D]; counts a zeroed int64 (T,) buffer that receives the upper count
// U (diagonal included). m >= 1, 1 <= nterms <= 16, 1 <= T <= 8; past
// m = 64 (the wide body's 16-byte copies) m a multiple of 4 and coords and
// scores on a 16-byte boundary (the wrappers pad the rows with zero
// columns).
int svgd_fused_phi_terms_sym(const float* coords, const float* scores,
                             const float* gammas, const float* signs,
                             int nterms, const float* thr, int n, int m,
                             int T, float* acc, long long* counts,
                             void* stream) {
  if (n <= 0 || T < 1 || T > kMaxT || nterms < 1 || nterms > kMaxTerms ||
      (m > kMaxM && !wide_rows_ok(m, coords, scores))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TermSigns sg = make_signs(signs, nterms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_TERMS_SYM(MM_, EX_)                                    \
  {                                                                        \
    const long long pairs = upper_pairs(n, TermsTriTile<MM_>::value);      \
    if (pairs < 0) return static_cast<int>(cudaErrorInvalidValue);        \
    launch_terms_sym<MM_, EX_>(false, coords, scores, gammas, sg, nterms,  \
                               thr, n, m, T, 0LL, pairs, acc, c, s);       \
  }
  SVGD_DISPATCH_M(m, SVGD_LAUNCH_TERMS_SYM)
#undef SVGD_LAUNCH_TERMS_SYM
  return static_cast<int>(cudaGetLastError());
}

// One rank's chunk of the composed-kernel triangle sweep: tiles
// [t0, t0 + count) of the tile list (TermsTriTile<MM> particles a side), the
// arguments otherwise as svgd_fused_phi_terms_sym's. coords and scores are
// the GLOBAL set, centered on its mean; acc (2m, n) and counts receive this
// chunk's raw sums. count = 0 launches nothing.
int svgd_fused_phi_terms_sym_chunk(const float* coords, const float* scores,
                                   const float* gammas, const float* signs,
                                   int nterms, const float* thr, int n, int m,
                                   int T, long long t0, long long count,
                                   float* acc, long long* counts,
                                   void* stream) {
  if (n <= 0 || T < 1 || T > kMaxT || nterms < 1 || nterms > kMaxTerms ||
      (m > kMaxM && !wide_rows_ok(m, coords, scores))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TermSigns sg = make_signs(signs, nterms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_TERMS_SYM_CHUNK(MM_, EX_)                              \
  {                                                                        \
    if (!tile_range_ok(n, TermsTriTile<MM_>::value, t0, count)) {          \
      return static_cast<int>(cudaErrorInvalidValue);                      \
    }                                                                      \
    if (count > 0) {                                                       \
      launch_terms_sym<MM_, EX_>(true, coords, scores, gammas, sg, nterms, \
                                 thr, n, m, T, t0, count, acc, c, s);      \
    }                                                                      \
  }
  SVGD_DISPATCH_M(m, SVGD_LAUNCH_TERMS_SYM_CHUNK)
#undef SVGD_LAUNCH_TERMS_SYM_CHUNK
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
