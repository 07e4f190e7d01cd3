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
// Coordinates arrive centered on the source mean (the wrapper does it in
// torch), so sq is exact in float32 at any offset where it is formed from
// differences. gamma and the thresholds are read from device memory: the
// host never reads them, so a step needs no synchronisation to launch a
// sweep.
//
// The triangle sweeps, and the square sweep up to m = 4, sum sq from
// differences in the plain torch version's order with its roundings
// (sweep_common.cuh), and D from the differences; at m <= 4, where the
// plain version also uses the difference form, the counts of both are
// equal. Past m = 4 the square sweep takes the plain version's own forms
// at those widths, the Gram sq and D = rowsum x - KX, on the tensor cores
// in 3xTF32 (square_mma.cuh); the centring keeps the subtraction's
// cancellation at float32 level.
//
// Every m >= 1 runs. The triangle sweeps take exact micro-tile instances
// for m = 1..8 and 11 and the wide instance (MM = kWideMM) for every other
// m (SVGD_DISPATCH_TRI_M, sweep_common.cuh); the square sweep exact
// CUDA-core instances for m = 1..4, tensor-core ones past them up to
// m = 64 (SVGD_DISPATCH_SQ_MMA) and its wide instance past 64. The wide
// instances' bodies hold nothing sized by m: square_wide_sm90_body
// (square_wide_sm90.cuh) and wide_tri_sm90_body (wide_tri_sm90.cuh), both
// on the tensor cores, their rows padded by the wrappers to a multiple of
// 4 floats. ptxas's report (-Xptxas -v, kept in the build log) says
// whether an instance spills.
//
// The bfloat16 operand opt-in (the JAX package's dot_dtype='bfloat16',
// pallas_phi.py:406 and :619) has instances of its own, at every m >= 1,
// their contractions on bf16 mma.sync m16n8k16, the norms and the
// epilogue's x_i in float32: K1's on square_bf16_sm90.cuh's body (its
// pack kernel's rounded operands and the norms the wrapper sums from the
// pack's squares, the Gram tile by float32 FMA in the plain version's
// order, the target rows resident, the weights from registers, the
// splits' partials [KS | KX | rowsum] summed by the finishing pass)
// and K2's on bf16_tri_sm90.cuh's (operands rounded once by its pack
// kernel, the accumulator [KS | KX | rowsum] whose D the wrapper forms in
// float32). The JAX kernels take the Gram form under bf16 at every m, so
// the CUDA-core and micro-tile bodies, which form sq from differences,
// have no bf16 instance.
//
// The kernels allocate nothing: the wrapper (ops/cuda_phi.py) passes zeroed
// count and accumulator buffers (K1's bf16 pack zeroes its counts itself)
// and the square sweep's workspace. Each
// entry point returns cudaGetLastError() after its launches.

#include <type_traits>

#include "micro_tile.cuh"
#include "square_mma.cuh"
#include "bf16_tri_sm90.cuh"
#include "square_bf16_sm90.cuh"
#include "square_wide_sm90.cuh"
#include "wide_tri_sm90.cuh"

namespace {

using namespace svgd;

// ---------------------------------------------------------------------------
// fused_phi_counts_square
//
// Replaces svgdcpp_tpu/ops/pallas_phi.py:_fused_kernel (the square/cross
// sweep, called through _phi_rbf_fused_pallas_cross_impl: K1).
//
// Bound on this card: per pair 3m FP32 operations for sq, one ex2 on the
// special function unit, 4m for the two contractions and T compares; the
// operands are a few hundred KB, so the function is bound by its
// operations (chip_smoke.py's sweep_bound counts them at the FP32 rate).
// Past m = 4 the design moves sq's Gram tile and both contractions, 5m of
// the 7m + 2 + T, onto the tensor cores.
//
// Design: square_mma.cuh's launch plan (sources split over the grid's y,
// partials in a (splits, n_t, 2m + 1) workspace summed in split order by
// the finishing pass) and bodies with one RBF's weights: up to m = 4
// square_cuda_body (a row a thread, partials [KS | D]), from m = 5
// (kSquareTensorMinM) square_mma_body with K1's one packed band
// K . [S | X | 1] (partials [KS | KX | rowsum]), past m = 64
// square_wide_sm90_body (square_wide_sm90.cuh: the target rows resident,
// the sources through a cp.async ring, every accumulator column in
// registers over the block's source range). The terms kernel
// (fused_phi_terms.cu) runs the same bodies with two weights.
// ---------------------------------------------------------------------------

// The CUDA-core body's one RBF: k_c = w = 2^(-gamma log2(e) sq) by exp2f.
struct SquareExp2 {
  float ng2;  // -gamma log2(e)

  __device__ __forceinline__ void operator()(float sq, float& kc,
                                             float& w) const {
    kc = exp2f(ng2 * sq);
    w = kc;
  }
};

// The CUDA-core body, at exactly MM coordinates.
template <int MM>
__global__ void __launch_bounds__(kSqThreads)
    fused_phi_counts_square_kernel(const float* __restrict__ targets,
                                   const float* __restrict__ sources,
                                   const float* __restrict__ scores,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ thr, int n_t,
                                   int n_s, int T, int chunk,
                                   float* __restrict__ work,
                                   unsigned long long* __restrict__ counts) {
  const SquareExp2 weights{-(gamma[0] * kLog2e)};
  square_cuda_body<MM>(targets, sources, scores, weights, thr, n_t, n_s, T,
                       chunk, work, counts);
}

// The tensor-core body, kT thresholds (3, or kMaxT for a runtime T); the
// wide body (square_wide_sm90_body, 512 threads) at MM = kWideMM, any m
// past kMaxM, m_arg being the padded row width there.
template <int MM, bool kExact, int kT>
__global__ void __launch_bounds__(SqThreads<MM>::value)
    fused_phi_counts_square_kernel(const float* __restrict__ targets,
                                   const float* __restrict__ sources,
                                   const float* __restrict__ scores,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ thr, int n_t,
                                   int n_s, int m_arg, int T, int chunk,
                                   float* __restrict__ work,
                                   unsigned long long* __restrict__ counts) {
  const int w = 2 * (kExact ? MM : m_arg) + 1;
  const OneRbf weights{-gamma[0] * kLog2e};
  float* part = work + static_cast<size_t>(blockIdx.y) * n_t * w;
  if constexpr (MM == kWideMM) {
    square_wide_sm90_body<kT>(targets, sources, scores, weights, thr, n_t,
                              n_s, m_arg, T, chunk, part, counts);
  } else {
    square_mma_body<MM, kExact, kT>(targets, sources, scores, weights, thr,
                                    n_t, n_s, m_arg, T, chunk, part, counts);
  }
}

// K1's bf16 instance (every m): square_bf16_sm90.cuh's body at NT
// accumulator tiles and kT thresholds, on the packed operands; work holds
// the splits' partials (splits, n_t, 2m + 1). The runtime-T instances
// (kT = kMaxT, which no driver path takes) ask for one block an SM: the
// 16 registers of their thresholds and counts would spill under two. The
// split plan (sq_bf16_chunk) does not know T and sizes its waves for the
// T = 3 instance's blocks an SM, so at NT = 2 a runtime-T launch runs its
// splits in two waves where the plan counted one: slower, never wrong.
template <int kT, int NT>
__global__ void __launch_bounds__(SqBf16<NT>::kThreads,
                                  kT == 3 ? SqBf16<NT>::kMinBlocks : 1)
    fused_phi_counts_square_bf16_kernel(
        SqBf16Operands ops, const float* __restrict__ gamma,
        const float* __restrict__ thr, int n_t, int n_s, int m, int T,
        int chunk, float* __restrict__ work,
        unsigned long long* __restrict__ counts) {
  float* part = work + static_cast<size_t>(blockIdx.y) * n_t * (2 * m + 1);
  square_bf16_body<kT, NT>(ops, -gamma[0] * kLog2e, thr, n_t, n_s, m, T,
                           chunk, part, counts);
}

// The finishing pass: D scaled by 2 gamma.
__global__ void fused_phi_counts_square_finish_kernel(
    const float* __restrict__ work, int splits, int n_t, int m, int rowsum,
    const float* __restrict__ gamma, const float* __restrict__ targets,
    int n_s, float* __restrict__ phi) {
  square_finish(work, splits, n_t, m, rowsum, 2.0f * gamma[0], targets, n_s,
                phi);
}

void launch_square_finish(const float* work, int splits, int n_t, int m,
                          int rowsum, const float* gamma,
                          const float* targets, int n_s, float* phi,
                          cudaStream_t s) {
  const long long outs = static_cast<long long>(n_t) * m;
  fused_phi_counts_square_finish_kernel<<<
      static_cast<unsigned int>((outs + kSqFinishThreads - 1) /
                                kSqFinishThreads),
      kSqFinishThreads, 0, s>>>(work, splits, n_t, m, rowsum, gamma, targets,
                                n_s, phi);
}

template <int MM, bool kExact>
int launch_square_mma(const float* targets, const float* sources,
                      const float* scores, const float* gamma,
                      const float* thr, int n_t, int n_s, int m, int T,
                      int chunk, int splits, float* work,
                      unsigned long long* counts, cudaStream_t s) {
  // The wide body's plan: its rows a block, its passes along the grid's z
  // (1 up to m = 512) and its dynamic shared memory.
  constexpr bool wide = MM == kWideMM;
  const SqWidePlan wp = sq_wide_plan(wide ? m : 4, false);
  const size_t smem = wide ? wp.smem : SqMma<MM>::kSmemBytes;
  const int rows = wide ? wp.rows : kSqMmaRows;
  const dim3 grid((n_t + rows - 1) / rows, splits, wide ? wp.passes : 1);
  auto go = [&](auto kt) {
    constexpr int kT = decltype(kt)::value;
    auto* kernel = &fused_phi_counts_square_kernel<MM, kExact, kT>;
    if (smem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    kernel<<<grid, SqThreads<MM>::value, smem, s>>>(
        targets, sources, scores, gamma, thr, n_t, n_s, m, T, chunk, work,
        counts);
    return 0;
  };
  return T == 3 ? go(std::integral_constant<int, 3>{})
                : go(std::integral_constant<int, kMaxT>{});
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
// the caller sums over the ranks before one epilogue.
//
// Bound on this card: the same per-pair work as the square sweep (3m+1
// FLOPs for sq, one ex2, T compares), paid once per UNORDERED pair, plus
// 4m FMAs for the two contraction directions from the pair's one
// difference. The operands are a few hundred KB, so the sweep is bound by
// instruction issue.
//
// Design at m = 1-8 and 11 (MicroWidth): the micro-tile body of the terms
// triangle kernels (micro_tile.cuh, micro_tri_body) with one RBF's weights
// (OneRbf: k = 2^(-gamma log2(e) sq), gamma read on the device). The
// triangle is cut into tiles of 128 particles (SymTile); a block sweeps one
// tile pair (bi <= bj) of the tile list with 2 warps of 2 rows a thread
// (one warp of 4 rows up to m = 2); the pair's weight stays in registers
// and feeds both directions; T is compile-time at T = 3 (a runtime T <= 8
// runs the 8-threshold instance); interior chunks run unmasked; rows and
// columns flush with float32 atomics into the (2m, n) accumulator; a launch
// of fewer than 1056 tile pairs splits each pair's chunks over the grid's
// second dimension (tri_splits). At every other m (9, 10, 12 and up) the
// wide instance runs wide_tri_sm90.cuh's tensor-core body in tiles of 128
// (kWideSymTile), one persistent block an SM walking the tile list, on
// rows the wrapper pads to a multiple of 4 floats; at m = 9, 10 and 12-64
// it replaced a one-row-a-thread body whose MM = 16, 32, 50 and 64
// instances took 1.8-7.5x its time at n = 10,000 (PERF.md,
// chip_profile.py --mid-width). Both bodies enter each self pair in both
// directions, leave D unscaled (the wrapper multiplies it by 2 gamma) and
// count the upper triangle with its diagonal. Every body goes under both
// names, so a profiler trace tells the whole sweep from a chunk.
// ---------------------------------------------------------------------------

namespace {

using namespace svgd;

template <int MM, bool kExact, int kT>
__device__ __forceinline__ void counts_tri(
    const float* __restrict__ coords, const float* __restrict__ scores,
    const float* __restrict__ gamma, const float* __restrict__ thr, int n,
    int m_arg, int T, int nb, long long t0, long long count,
    float* __restrict__ acc, unsigned long long* __restrict__ counts) {
  const OneRbf weights{-gamma[0] * kLog2e};
  if constexpr (MM == kWideMM) {
    wide_tri_sm90_body<kT>(coords, scores, weights, thr, n, m_arg, T,
                           WideTriWork{nb, t0, count}, acc, counts);
  } else {
    micro_tri_body<MM, kExact, kT>(coords, scores, weights, thr, n, m_arg, T,
                                   nb, t0, acc, counts);
  }
}

// K2's bf16 instance (every m): bf16_tri_sm90.cuh's body over the whole
// triangle of tiles of kBf16Tile, on the packed operands, into the
// (2m + 1, n) accumulator [KS | KX | rowsum].
template <int kT>
__global__ void __launch_bounds__(kBf16Threads, 1)
    fused_phi_counts_sym_bf16_kernel(Bf16Operands ops,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ thr, int n,
                                     int m, int T, int nb, long long items,
                                     float* __restrict__ acc,
                                     unsigned long long* __restrict__ counts) {
  bf16_tri_body<kT>(ops, -gamma[0] * kLog2e, thr, n, m, T, items,
                    Bf16TriWork{nb, n, acc}, counts);
}

template <int MM, bool kExact, int kT>
__global__ void __launch_bounds__(TriThreads<MM>::value)
    fused_phi_counts_sym_kernel(const float* __restrict__ coords,
                                const float* __restrict__ scores,
                                const float* __restrict__ gamma,
                                const float* __restrict__ thr, int n,
                                int m_arg, int T, int nb, long long t0,
                                long long count, float* __restrict__ acc,
                                unsigned long long* __restrict__ counts) {
  counts_tri<MM, kExact, kT>(coords, scores, gamma, thr, n, m_arg, T, nb, t0,
                             count, acc, counts);
}

template <int MM, bool kExact, int kT>
__global__ void __launch_bounds__(TriThreads<MM>::value)
    fused_phi_counts_sym_chunk_kernel(const float* __restrict__ coords,
                                      const float* __restrict__ scores,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ thr, int n,
                                      int m_arg, int T, int nb, long long t0,
                                      long long count,
                                      float* __restrict__ acc,
                                      unsigned long long* __restrict__ counts) {
  counts_tri<MM, kExact, kT>(coords, scores, gamma, thr, n, m_arg, T, nb, t0,
                             count, acc, counts);
}

// Launch of the single-RBF triangle sweep over tiles [t0, t0 + count) of
// the tile list (SymTile<MM> particles a side; count > 0): the wide body's
// instance (one persistent block an SM) or the micro-tile one of MM, each
// for T = 3 or any T <= 8.
template <int MM, bool kExact>
void launch_counts_sym(bool chunk, const float* coords, const float* scores,
                       const float* gamma, const float* thr, int n, int m,
                       int T, long long t0, long long count, float* acc,
                       unsigned long long* counts, cudaStream_t s) {
  constexpr int tile = SymTile<MM>::value;
  const int nb = (n + tile - 1) / tile;
  if constexpr (MM == kWideMM) {
    auto go = [&](auto kt) {
      constexpr int kT = decltype(kt)::value;
      auto* kernel = chunk ? &fused_phi_counts_sym_chunk_kernel<MM, false, kT>
                           : &fused_phi_counts_sym_kernel<MM, false, kT>;
      const unsigned int blocks = wide_sym_prepare<false>(kernel, count);
      kernel<<<blocks, kWideSymThreads, WideSym<false>::kSmemBytes, s>>>(
          coords, scores, gamma, thr, n, m, T, nb, t0, count, acc, counts);
    };
    if (T == 3) {
      go(std::integral_constant<int, 3>{});
    } else {
      go(std::integral_constant<int, kMaxT>{});
    }
  } else {
    const dim3 grid(static_cast<unsigned int>(count), tri_splits<MM>(count));
    constexpr int threads = MicroTri<MM>::kThreads;
    auto go = [&](auto kt) {
      constexpr int kT = decltype(kt)::value;
      if (chunk) {
        fused_phi_counts_sym_chunk_kernel<MM, kExact, kT>
            <<<grid, threads, 0, s>>>(coords, scores, gamma, thr, n, m, T, nb,
                                      t0, count, acc, counts);
      } else {
        fused_phi_counts_sym_kernel<MM, kExact, kT><<<grid, threads, 0, s>>>(
            coords, scores, gamma, thr, n, m, T, nb, t0, count, acc, counts);
      }
    };
    if (T == 3) {
      go(std::integral_constant<int, 3>{});
    } else {
      go(std::integral_constant<int, kMaxT>{});
    }
  }
}

}  // namespace

extern "C" {

// The number of source splits of a square/cross launch (the workspace's
// first dimension) for n_t targets, n_s sources and dimension m, of K1's
// and of the terms kernel's alike (square_mma.cuh's plan up to kMaxM,
// square_wide_sm90.cuh's past it, at the row width m padded to a multiple
// of 4); -1 for arguments the sweeps do not take. ops/sym_plan.square_splits
// mirrors it.
int svgd_square_splits(int n_t, int n_s, int m) {
  if (n_t <= 0 || n_s <= 0 || m < 1) return -1;
  int splits = 0;
  square_plan_chunk(n_t, n_s, m, &splits);
  return splits;
}

// phi (n_t, m) and counts (T,) of the square/cross sweep. targets (n_t, m)
// and sources (n_s, m) centered on the source mean, scores (n_s, m), all
// float32 row-major; gamma (1,), thr (T,) float32 on the device; counts
// zeroed int64; work a float32 workspace of (splits, n_t, 2m + 1), splits
// being svgd_square_splits(n_t, n_s, m). m >= 1, 1 <= T <= 8. From
// m = kSquareTensorMinM the body copies sources and scores 16 bytes at a
// time (cp.async): both must start on a 16-byte boundary; past m = 64 the
// targets too, and m must be a multiple of 4 (the wrappers pad the rows
// with zero columns; phi then has the padded width, its padded columns 0).
int svgd_fused_phi_counts_square(const float* targets, const float* sources,
                                 const float* scores, const float* gamma,
                                 const float* thr, int n_t, int n_s, int m,
                                 int T, float* phi, long long* counts,
                                 float* work, int splits, void* stream) {
  if (n_t <= 0 || n_s <= 0 || T < 1 || T > kMaxT || m < 1) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  if (tensor) {
    int rc = 0;
#define SVGD_LAUNCH_SQ_MMA(MM_, EX_)                                      \
  rc = launch_square_mma<MM_, EX_>(targets, sources, scores, gamma, thr,  \
                                   n_t, n_s, m, T, chunk, splits, work, c, \
                                   s)
    SVGD_DISPATCH_SQ_MMA(m, SVGD_LAUNCH_SQ_MMA)
#undef SVGD_LAUNCH_SQ_MMA
    if (rc != 0) return rc;
  } else {
    const dim3 grid((n_t + kSqThreads - 1) / kSqThreads, splits);
#define SVGD_LAUNCH_SQUARE(MM_)                                    \
  fused_phi_counts_square_kernel<MM_><<<grid, kSqThreads, 0, s>>>( \
      targets, sources, scores, gamma, thr, n_t, n_s, T, chunk, work, c)
    SVGD_DISPATCH_SQ_CUDA_CORES(m, SVGD_LAUNCH_SQUARE)
#undef SVGD_LAUNCH_SQUARE
  }
  launch_square_finish(work, splits, n_t, m, tensor ? 1 : 0, gamma, targets,
                       n_s, phi, s);
  return static_cast<int>(cudaGetLastError());
}

// The split count of K1's bf16 instance (svgd_fused_phi_counts_square_bf16):
// square_bf16_sm90.cuh's plan (sq_bf16_chunk); -1 as svgd_square_splits.
// ops/sym_plan.square_splits(..., bf16=True) mirrors it.
int svgd_square_bf16_splits(int n_t, int n_s, int m) {
  if (n_t <= 0 || n_s <= 0 || m < 1) return -1;
  int splits = 0;
  sq_bf16_chunk(n_t, n_s, m, &splits);
  return splits;
}

// The bytes of K1's bf16 workspace (sq_bf16_work: the splits' partials,
// the rounded rows, the record) for svgd_square_bf16_splits' split count;
// square: the square form (one set of rows); -1 as svgd_square_splits.
// ops/sym_plan.square_bf16_work mirrors it.
long long svgd_square_bf16_work_bytes(int n_t, int n_s, int m, int square) {
  if (n_t <= 0 || n_s <= 0 || m < 1 || (square && n_t != n_s)) return -1;
  int splits = 0;
  sq_bf16_chunk(n_t, n_s, m, &splits);
  return static_cast<long long>(
      sq_bf16_work(n_t, n_s, m, splits, square != 0).bytes);
}

// K1's bf16 pack (the first of the instance's launches; the wrapper sums
// the squares into the norms between it and the sweep): targets (n_t, m)
// and sources (n_s, m) the centred float32 coordinates and scores (n_s, m)
// float32, any alignment; square: the square form, targets are the sources
// (n_t == n_s, targets and sq_t unread); sq_t (n_t, m) and sq_s (n_s, m)
// float32 the rows' squares; work the 16-byte-aligned workspace of
// svgd_square_bf16_work_bytes(n_t, n_s, m, square), splits =
// svgd_square_bf16_splits(n_t, n_s, m); counts (T,) int64, zeroed here.
int svgd_square_bf16_pack(const float* targets, const float* sources,
                          const float* scores, float* sq_t, float* sq_s,
                          void* work, long long* counts, int n_t, int n_s,
                          int m, int T, int square, int splits,
                          void* stream) {
  int want = 0;
  if (n_t <= 0 || n_s <= 0 || T < 1 || T > kMaxT || m < 1 ||
      (square && n_t != n_s) ||
      (reinterpret_cast<uintptr_t>(work) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sq_bf16_chunk(n_t, n_s, m, &want);
  if (splits != want) return static_cast<int>(cudaErrorInvalidValue);
  const SqBf16Work w = sq_bf16_work(n_t, n_s, m, splits, square != 0);
  auto* base = static_cast<unsigned char*>(work);
  const SqBf16Pack out{sq_t, sq_s, reinterpret_cast<float*>(base + w.x_t),
                       reinterpret_cast<float*>(base + w.x_s),
                       reinterpret_cast<__nv_bfloat16*>(base + w.rec)};
  const int rows = (square ? 0 : n_t) + n_s;
  const dim3 grid((rows + kSqBf16PackRows - 1) / kSqBf16PackRows,
                  (bf16_record_width(m) + 31) / 32);
  square_bf16_pack_kernel<<<grid, dim3(32, kSqBf16PackRows), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      targets, sources, scores, square ? 0 : n_t, n_s, m, out,
      reinterpret_cast<unsigned long long*>(counts), T);
  return static_cast<int>(cudaGetLastError());
}

// K1's bf16 sweep and finishing pass at any m >= 1, after the pack: q_t
// (n_t,) and q_s (n_s,) the float32 norms of the centred coordinates (the
// wrapper's sums of the pack's squares; q_t is q_s in the square form),
// q_s on a 16-byte boundary; targets (n_t, m) the centred float32 targets
// of the finishing pass; work the pack's workspace (its partials filled
// here); square, splits as the pack's; the rest as
// svgd_fused_phi_counts_square's, counts zeroed by the pack. Launches: the
// sweep, the finishing pass.
int svgd_fused_phi_counts_square_bf16(
    const float* q_t, const float* q_s, const float* targets,
    const float* gamma, const float* thr, int n_t, int n_s, int m, int T,
    int square, float* phi, long long* counts, void* work, int splits,
    void* stream) {
  if (n_t <= 0 || n_s <= 0 || T < 1 || T > kMaxT || m < 1 ||
      (square && n_t != n_s) ||
      ((reinterpret_cast<uintptr_t>(work) |
        reinterpret_cast<uintptr_t>(q_s)) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int want = 0;
  const int chunk = sq_bf16_chunk(n_t, n_s, m, &want);
  if (splits != want) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const SqBf16Work w = sq_bf16_work(n_t, n_s, m, splits, square != 0);
  const auto* base = static_cast<const unsigned char*>(work);
  const SqBf16Operands ops{
      q_t, reinterpret_cast<const float*>(base + w.x_t), q_s,
      reinterpret_cast<const float*>(base + w.x_s),
      reinterpret_cast<const __nv_bfloat16*>(base + w.rec)};
  float* part = static_cast<float*>(work);
  const SqBf16Plan p = sq_bf16_plan(m);
  const dim3 grid((n_t + kSqBf16Rows - 1) / kSqBf16Rows, splits, p.chunks);
  auto go = [&](auto kt, auto nt) {
    constexpr int kT = decltype(kt)::value;
    constexpr int NT = decltype(nt)::value;
    auto* kernel = &fused_phi_counts_square_bf16_kernel<kT, NT>;
    if (p.smem > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    kernel<<<grid, SqBf16<NT>::kThreads, p.smem, s>>>(
        ops, gamma, thr, n_t, n_s, m, T, chunk, part, c);
    return 0;
  };
  auto by_tiles = [&](auto kt) {
    switch (p.nt) {
      case 2: return go(kt, std::integral_constant<int, 2>{});
      case 4: return go(kt, std::integral_constant<int, 4>{});
      case 8: return go(kt, std::integral_constant<int, 8>{});
      default: return go(kt, std::integral_constant<int, 16>{});
    }
  };
  const int rc = T == 3 ? by_tiles(std::integral_constant<int, 3>{})
                        : by_tiles(std::integral_constant<int, kMaxT>{});
  if (rc != 0) return rc;
  launch_square_finish(part, splits, n_t, m, 1, gamma, targets, n_s, phi, s);
  return static_cast<int>(cudaGetLastError());
}

// Upper-triangle sweep over one particle set. coords (n, m) centered,
// scores (n, m), gamma (1,), thr (T,) float32 on the device; acc a zeroed
// (2m, n) float32 accumulator [KS | D]; counts a zeroed int64 (T,) buffer that
// receives the upper count U (diagonal included). m >= 1; wherever the wide
// body serves m (tri_wide: every m but 1-8 and 11; its 16-byte copies) m a
// multiple of 4 and coords and scores on a 16-byte boundary (the wrappers
// pad the rows with zero columns).
int svgd_fused_phi_counts_sym(const float* coords, const float* scores,
                              const float* gamma, const float* thr, int n,
                              int m, int T, float* acc, long long* counts,
                              void* stream) {
  if (n <= 0 || T < 1 || T > kMaxT ||
      (tri_wide(m) && !wide_rows_ok(m, coords, scores))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_SYM(MM_, EX_)                                          \
  {                                                                        \
    const long long pairs = upper_pairs(n, SymTile<MM_>::value);           \
    if (pairs < 0) return static_cast<int>(cudaErrorInvalidValue);        \
    launch_counts_sym<MM_, EX_>(false, coords, scores, gamma, thr, n, m, T, \
                                0LL, pairs, acc, c, s);                    \
  }
  SVGD_DISPATCH_TRI_M(m, SVGD_LAUNCH_SYM)
#undef SVGD_LAUNCH_SYM
  return static_cast<int>(cudaGetLastError());
}

// K2's bf16 instance, at any m >= 1: coords (n, m) centered and scores
// (n, m) float32 on the device, as svgd_fused_phi_counts_sym's (any
// alignment); work a 16-byte-aligned workspace of sym_plan.bf16_work_bytes
// (n, m) bytes, which the pack kernel fills with the rounded operands; acc
// a zeroed (2m + 1, n) float32 accumulator that receives [KS | KX |
// rowsum] (each self pair in both directions); counts the upper count U.
// Two launches: the pack, then the triangle in tiles of kBf16Tile.
int svgd_fused_phi_counts_sym_bf16(const float* coords, const float* scores,
                                   const float* gamma, const float* thr,
                                   int n, int m, int T, void* work,
                                   float* acc, long long* counts,
                                   void* stream) {
  if (n <= 0 || m < 1 || T < 1 || T > kMaxT ||
      (reinterpret_cast<uintptr_t>(work) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items = upper_pairs(n, kBf16Tile);
  if (items < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + kBf16Tile - 1) / kBf16Tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  const Bf16Operands ops = bf16_tri_pack(coords, scores, n, m, work, s);
  auto go = [&](auto* kernel) {
    const unsigned int blocks = bf16_tri_prepare(kernel, items);
    kernel<<<blocks, kBf16Threads, Bf16Tri::kSmemBytes, s>>>(
        ops, gamma, thr, n, m, T, nb, items, acc, c);
    return static_cast<int>(cudaGetLastError());
  };
  return T == 3 ? go(&fused_phi_counts_sym_bf16_kernel<3>)
                : go(&fused_phi_counts_sym_bf16_kernel<kMaxT>);
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
  if (n <= 0 || T < 1 || T > kMaxT ||
      (tri_wide(m) && !wide_rows_ok(m, coords, scores))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_SYM_CHUNK(MM_, EX_)                                    \
  {                                                                        \
    if (!tile_range_ok(n, SymTile<MM_>::value, t0, count)) {               \
      return static_cast<int>(cudaErrorInvalidValue);                      \
    }                                                                      \
    if (count > 0) {                                                       \
      launch_counts_sym<MM_, EX_>(true, coords, scores, gamma, thr, n, m,  \
                                  T, t0, count, acc, c, s);                \
    }                                                                      \
  }
  SVGD_DISPATCH_TRI_M(m, SVGD_LAUNCH_SYM_CHUNK)
#undef SVGD_LAUNCH_SYM_CHUNK
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

namespace {

// The tile side of the triangle instance SVGD_DISPATCH_TRI_M picks for m.
int sym_tile_of(int m, int terms, int* tile) {
#define SVGD_SYM_TILE(MM_, EX_) \
  *tile = terms ? TermsTriTile<MM_>::value : SymTile<MM_>::value
  SVGD_DISPATCH_TRI_M(m, SVGD_SYM_TILE)
#undef SVGD_SYM_TILE
  return 0;
}

}  // namespace

extern "C" {

// The side of the tiles in the triangle chunk kernels' tile list for
// dimension m: svgd_fused_phi_counts_sym_chunk's (terms = 0) or
// svgd_fused_phi_terms_sym_chunk's (terms = 1). A rank's [t0, t0 + count)
// is a range of this list. -1 for an m below 1.
int svgd_sym_tile(int m, int terms) {
  int tile = -1;
  sym_tile_of(m, terms, &tile);
  return tile;
}

}  // extern "C"
