// Fused phi + median-count sweep of a composed RBF kernel with ANISOTROPIC
// terms, for Hopper (sm_90a).
//
// A `+ - * /` composition whose constant slots may be full matrices
// (kernels/algebra.py) flattens to isotropic terms, which share the
// Euclidean squared distance sq, and anisotropic terms with a full
// precision P_t each:
//
//   k(x_i, x_j) = sum_iso s exp(-gamma sq_ij) + sum_t s_t exp(-d^T P_t d),
//   d = x_i - x_j, at most 8 gradient accumulators (1 if any isotropic
//   term, plus one per anisotropic term).
//
// One sweep gives phi and the counts of the EUCLIDEAN pair squared
// distances at or below each threshold (the median selection's edges):
//
//   phi_i = (KS_i + 2 D_iso_i + sum_t D_t,i (P_t + P_t^T)) / n
//   KS_i = sum_j k(x_i, x_j) s_j,   D_iso_i = sum_j w_ij (x_i - x_j),
//   w = sum_iso s gamma exp(-gamma sq),   D_t,i = sum_j s_t k_t (x_i - x_j),
//
// the sums over every j, the self pair (k_t(i, i) = 1 for every term)
// included once.
//
// Replaces svgdcpp_tpu/ops/pallas_phi.py:_sym_aniso_terms_kernel (K14,
// called through _phi_rbf_aniso_terms_fused_pallas_sym_impl).
//
// The quadratic forms. The TPU kernel builds each anisotropic form with the
// Gram identity q_i + q_j - 2 x_i (P_sym/2) x_j, which cancels in float32
// and needs HIGHEST-precision dots and a pinned diagonal. Here the caller
// factors P_sym/2 = L_t L_t^T (Cholesky, in float64; the route's gate
// proves every term positive definite; the driver keeps the factors while
// the step carries the same P), so with z_t = X_c L_t,
// d^T P_t d = |z_ti - z_tj|^2: the difference form, exact 0 at the self
// pair, no cancellation. Since (x_i - x_j) L_t = z_ti - z_tj, the gradient
// direction follows from the same rows:
// D_t P_sym = 2 (sum_j s_t k_t (z_ti - z_tj)) L_t^T. The kernels accumulate
// that sum, D_zt, and apply 2 L_t^T (one-pass kernel) or leave it to the
// wrapper (term-group kernel). The Euclidean sq is K2's difference form in
// the plain version's order up to m = 4 (sweep_common.cuh), so the counts
// equal the plain version's there.
//
// Two kernels. Isotropic terms and ONE anisotropic term (at most two
// gradient accumulators; the anisotropic posterior's median RBF + RBF(P))
// take the one-pass kernel fused_phi_aniso_terms_sym_kernel up to m = 32
// (exact instances at m = 2 and 11, runtime-m ones with MM = 8, 16 and 32
// for the rest); two or more anisotropic terms, or one past m = 32, the
// term-group kernel fused_phi_aniso_terms_groups_kernel. At MM = 64 the
// one-pass kernel's row (5 x 64 sums and coordinates) spilled 3.2 KB and
// ran 1.6-1.9x slower than the term groups at m = 50 and 64 (PERF.md
// section 6); at MM = 32 it spills 156-216 B and still ran 1.2x faster.
//
// The one-pass kernel (svgd_fused_phi_aniso_terms_sym). Every ordered pair
// (i, j) once, in one pass for both groups: the Euclidean difference d and
// sq (the counts and the isotropic terms' (k_c, w)), the rows' z_i - z_j
// and its form (the anisotropic term's k_t), then k_c = sum s k once for
// KS and the two directions D_iso += w d and D_z += s_t k_t (z_i - z_j),
// all into row i's sums. It sweeps the square, not the triangle, so no
// column direction: the triangle would halve the pairs but, at m = 11,
// carry a column's 33 sums through 33 shuffles or shared-memory records a
// step and read each column's 33 operands per lane, traffic that bound the
// terms panel kernel's step by the shared-memory pipe rather than by issue
// at the same m (PERF.md section 6); here a warp's lanes all
// read the same column (broadcast), each lane holds R rows (8 at m = 2, 1
// at m = 11), and the pair's work is FP32 arithmetic and two ex2 on the
// special function unit: at m = 11, T = 3 the step loop issues 103
// instructions an ordered pair, 82 of them FP32 (chip_profile.py --sass),
// and the instance takes 96 registers (ptxas), 5 blocks an SM. One row a
// thread at m = 11 keeps it there: two rows amortize the column's shared
// reads over two pairs but need more registers than leave room for as many
// blocks. The block stages its columns' x and s in shared memory and forms
// their z = x L there from L (P_sym/2 = L L^T, m x m, cached by the caller
// for a constant P), so no z array is built on the host; its rows' z are
// formed the same way. A second grid dimension splits the columns (rows'
// sums are then partial); at the end each row's n phi contribution,
// KS + 2 D_iso + 2 D_z L^T, goes to the zeroed (m, n) accumulator with one
// float32 atomicAdd per coordinate and block (the wrapper divides by n),
// and the counts of all n^2 ordered pairs (self pairs included) through
// the deterministic integer flush. Rows past n sit at +inf: their sq is
// +inf, which no threshold counts, and their sums are never stored.
// Thresholds are held at a compile-time count (3, or 8 padded with -1).
// A runtime-m instance holds MM coordinates with zeros past m in x, z, s
// and L, which add nothing to any sum; up to m = 4 its sq takes the plain
// order as the exact instances do. At MM = 32 a row's 5 MM sums and
// coordinates exceed the registers (the compiler spills some) and a block
// has 64 threads (AnisoShape).
//
// Work per unordered pair, as the term-group kernel runs it:
// each term group
// computes its squared distance (3m+1 FP32 ops), one ex2 per term on the
// special function unit plus 4 ops per term to combine, and 10m for the
// two contraction directions (4 FMAs and 2 subtractions per coordinate, an
// FMA counted as 2); group 0 adds T compares. The function itself needs
// less (KS once, each difference once): chip_smoke.py's sweep_bound counts
// that. The operands are a few MB, so the sweep is compute-bound.
//
// The term-group kernel: the composed kernels' triangle sweep
// (terms_sym.cuh, K8/K9's port) with one more grid dimension, the term
// group, from z_t = X_c L_t that the wrapper forms. The triangle enters the
// self pair in both directions, so the wrapper subtracts (sum s) s_i once
// and forms the counts 2U - n. Group 0 sweeps the
// Euclidean coordinates: the isotropic terms' (k_c, w) and the counts (with
// no isotropic term, the counts alone). Group 1 + t sweeps z_t with its one
// term (gamma = 1, sign s_t). Each group flushes into its own (2m, n)
// accumulator [KS_g | D_g] of a zeroed (1 + n_aniso, 2m, n) buffer, and the
// wrapper sums the KS_g. So a thread holds one row, 2m sums and its counts
// in registers whatever the number of terms: holding every term's row and
// sums at once would need about (2 + 2 n_aniso) m registers, past the 255
// a thread has at n_w = 8 and m = 11. The cost is that the KS contraction
// runs once per group instead of once per pair.
//
// Past m = 64 (kMaxM), where terms_sym.cuh's rows would spill, the term
// groups run on wide_tri_sm90.cuh's tensor-core body (K2's and K8/K9's
// past 64: tiles of 128 particles, one persistent block an SM walking the
// triangle, a producer warp feeding a cp.async ring, the Gram tile and
// both contractions in 3xTF32), each group a sweep of its own rows into
// its own (2w, n) slab of the (1 + n_aniso, 2w, n) accumulator, w the
// rows' width padded to a multiple of 4 by the wrapper (the body's 16-byte
// copies; z_t's columns past m are exact zeros, from L_t padded with zero
// rows and columns). A group of one term is K2's single-RBF form, one
// weight tile a pair (OneRbf, WideSym<false>, 196,640 B):
// fused_phi_aniso_terms_wide_groups_kernel sweeps every anisotropic group
// (z_t with gamma 1, T = 0: no counts) and, with exactly one isotropic
// term, group 0 (x with its gamma, read on the device, and the counts),
// the group along the grid's y. Its KS and D are unsigned and D carries k
// alone: the wrapper applies s and 2 gamma s to group 0, s_t to group
// 1 + t (ops/phi.aniso_groups_finish). Two or more isotropic terms take
// group 0 through fused_phi_aniso_terms_wide_iso_kernel, K8/K9's
// two-weight instance (AnyTerms, WideSym<true>, 225,312 B), a launch of
// its own before the groups'. With no isotropic term group 0 does not
// sweep, and the wrapper takes the counts from the count kernel's self
// form (K16). The self pair enters both directions at sq = 0, k = 1, as
// in the narrower groups, so the wrapper subtracts (sum s) s_i once.
//
// The iso gammas and the thresholds are read from device memory (the host
// never reads them); the signs are static and arrive by value. The kernels
// allocate nothing. The entry points return cudaGetLastError() after the
// launch.

// The kGroups instances of terms_sym.cuh's sweep, under their own name.
#define SVGD_TERMS_SYM_KERNEL fused_phi_aniso_terms_groups_kernel
#include "terms_sym.cuh"
#include "wide_tri_sm90.cuh"

namespace {

using namespace svgd;

// The one-pass kernel's shape at MM: threads a block, rows a thread,
// columns a shared stage holds, and a staged column's record
// [x (MM) | z (MM) | s (MM)] padded to 16 bytes. At MM = 32 half the
// threads and columns keep the stage and each thread's two scratch rows
// within 48 KB of static shared memory.
template <int MM>
struct AnisoShape {
  static constexpr int threads = MM <= 16 ? 128 : 64;
  static constexpr int rows = MM <= 2 ? 8 : 1;
  static constexpr int cols = MM <= 16 ? 128 : 64;
  static constexpr int rec = (3 * MM + 3) / 4 * 4;
};

// The isotropic terms' (k_c, w): one term's constants in registers
// (NIso = 1), or any number of terms from shared memory (NIso = 0; the
// caller has run load_terms into g2, sn, sg).
template <int NIso>
__device__ __forceinline__ auto iso_weights(const float* __restrict__ gammas,
                                            const TermSigns& signs, int n_iso,
                                            const float* g2, const float* sn,
                                            const float* sg) {
  if constexpr (NIso == 1) {
    return FixedTerms<1>(gammas, signs);
  } else {
    return AnyTerms{g2, sn, sg, n_iso};
  }
}

// z = x L for one point: z[l] = sum_k x[k] L[k][l], L row-major in shared
// memory, z in memory. The loop over l stays rolled, so that no more than
// one column of L is held in registers at a time: unrolled, the compiler
// loads all m^2 entries at once, and at m = 11 that register peak set the
// kernel's register count.
template <int MM>
__device__ __forceinline__ void project(const float* x, const float* sh_l,
                                        float* z) {
#pragma unroll 1
  for (int l = 0; l < MM; ++l) {
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < MM; ++k) v = fmaf(x[k], sh_l[k * MM + l], v);
    z[l] = v;
  }
}

template <int MM, bool kExact, int NIso, int kT>
__global__ void __launch_bounds__(AnisoShape<MM>::threads)
    fused_phi_aniso_terms_sym_kernel(
        const float* __restrict__ coords, const float* __restrict__ scores,
        const float* __restrict__ lower, const float* __restrict__ gammas,
        TermSigns iso_signs, int n_iso, float aniso_sign,
        const float* __restrict__ thr, int n, int m_arg, int T,
        int split_len, float* __restrict__ acc,
        unsigned long long* __restrict__ counts) {
  using Shape = AnisoShape<MM>;
  constexpr int kThreads = Shape::threads;
  constexpr int R = Shape::rows;
  constexpr int kCols = Shape::cols;
  constexpr int kRec = Shape::rec;
  static_assert(2 * kThreads * MM <= kCols * kRec,
                "sh_col holds each thread's two scratch rows");
  __shared__ __align__(16) float sh_col[kCols * kRec];
  __shared__ float sh_l[MM * MM];
  __shared__ float sh_g2[kMaxTerms];
  __shared__ float sh_sn[kMaxTerms];
  __shared__ float sh_sg[kMaxTerms];

  // m coordinates of MM: past m, x, z, s and L hold zeros, which add
  // nothing to any sum (a runtime instance, kExact false).
  const int m = kExact ? MM : m_arg;
  const int tid = static_cast<int>(threadIdx.x);
  const int i0 = static_cast<int>(blockIdx.x) * kThreads * R;
  const int c_begin = static_cast<int>(blockIdx.y) * split_len;
  const int c_end = min(n, c_begin + split_len);
  for (int e = tid; e < MM * MM; e += kThreads) {
    const int k = e / MM, l = e - k * MM;
    sh_l[e] = (kExact || (k < m && l < m)) ? lower[k * m + l] : 0.0f;
  }
  if (NIso == 0) load_terms(gammas, iso_signs, n_iso, sh_g2, sh_sn, sh_sg);
  const auto iso = iso_weights<NIso>(gammas, iso_signs, n_iso, sh_g2, sh_sn,
                                     sh_sg);
  const float nga = -kLog2e;  // the anisotropic term: 2^(-log2(e) form)
  float th[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) th[t] = t < T ? thr[t] : -1.0f;
  __syncthreads();  // L and the terms' constants are set

  // Row i = i0 + kThreads r + tid: x (+inf past n), z = x L (through the
  // thread's own slots of sh_col, free until the first stage), and its
  // sums.
  float xi[R][MM];
  float zi[R][MM];
  float ks[R][MM];
  float kd[R][MM];
  float kz[R][MM];
  float* own = sh_col + tid * MM;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * kThreads + tid;
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      xi[r][k] = i >= n ? __int_as_float(0x7f800000)
                 : (kExact || k < m) ? coords[static_cast<size_t>(i) * m + k]
                                     : 0.0f;
      ks[r][k] = 0.0f;
      kd[r][k] = 0.0f;
      kz[r][k] = 0.0f;
    }
    project<MM>(xi[r], sh_l, own);
#pragma unroll
    for (int k = 0; k < MM; ++k) zi[r][k] = own[k];
  }
  unsigned int cnt[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) cnt[t] = 0u;

  for (int j0 = c_begin; j0 < c_end; j0 += kCols) {
    const int tile_n = min(kCols, c_end - j0);
    __syncthreads();  // the previous stage is consumed
    for (int e = tid; e < tile_n * MM; e += kThreads) {
      const int jj = e / MM, k = e - jj * MM;
      const bool in = kExact || k < m;
      const size_t at = static_cast<size_t>(j0 + jj) * m + k;
      sh_col[jj * kRec + k] = in ? coords[at] : 0.0f;
      sh_col[jj * kRec + 2 * MM + k] = in ? scores[at] : 0.0f;
    }
    __syncthreads();
    for (int jj = tid; jj < tile_n; jj += kThreads) {
      float* rec = sh_col + jj * kRec;
      project<MM>(rec, sh_l, rec + MM);
    }
    __syncthreads();
    for (int jj = 0; jj < tile_n; ++jj) {
      float op[kRec];
      const float4* rec4 = reinterpret_cast<const float4*>(sh_col + jj * kRec);
#pragma unroll
      for (int v = 0; v < kRec / 4; ++v) {
        const float4 a = rec4[v];
        op[4 * v] = a.x;
        op[4 * v + 1] = a.y;
        op[4 * v + 2] = a.z;
        op[4 * v + 3] = a.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d[MM];
        float dz[MM];
        float sq = 0.0f;
        float form = 0.0f;
#pragma unroll
        for (int k = 0; k < MM; ++k) {
          d[k] = __fsub_rn(xi[r][k], op[k]);
          dz[k] = zi[r][k] - op[MM + k];
          form = fmaf(dz[k], dz[k], form);
        }
        if ((kExact || MM <= 8) && (kExact ? MM <= 4 : m <= 4)) {
          sq = pair_sq<MM, kExact>(xi[r], op, m);  // the plain order
        } else {
#pragma unroll
          for (int k = 0; k < MM; ++k) sq = fmaf(d[k], d[k], sq);
        }
        float kc, w;
        iso(sq, kc, w);
        const float wa = aniso_sign * ex2_ftz(nga * form);
        kc += wa;
#pragma unroll
        for (int k = 0; k < MM; ++k) {
          ks[r][k] = fmaf(kc, op[2 * MM + k], ks[r][k]);
          kd[r][k] = fmaf(w, d[k], kd[r][k]);
          kz[r][k] = fmaf(wa, dz[k], kz[r][k]);
        }
        count_pair_fixed<kT, false>(sq, th, true, cnt);
      }
    }
  }

  // Row i's n phi contribution KS + 2 D_iso + 2 D_z L^T, through the
  // thread's own slots of sh_col (the loop over k rolled, as in project).
  __syncthreads();  // the last stage is consumed
  float* own_kz = sh_col + kThreads * MM + tid * MM;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * kThreads + tid;
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      own[k] = fmaf(2.0f, kd[r][k], ks[r][k]);
      own_kz[k] = kz[r][k];
    }
    if (i < n) {
#pragma unroll 1
      for (int k = 0; k < m; ++k) {
        float g = 0.0f;
#pragma unroll
        for (int l = 0; l < MM; ++l) g = fmaf(own_kz[l], sh_l[k * MM + l], g);
        atomicAdd(acc + static_cast<size_t>(k) * n + i, fmaf(2.0f, g, own[k]));
      }
    }
  }
  flush_counts(cnt, T, counts);
}

// Blocks a one-pass launch aims for (a few waves on a 132-SM card); the
// columns are split in multiples of a stage until the grid has about this
// many.
constexpr int kAnisoTargetBlocks = 1024;

// One-pass launches at MM with T <= 3 or up to kMaxT thresholds held.
template <int MM, bool kExact, int NIso>
void launch_one_pass_t(dim3 grid, const float* coords, const float* scores,
                       const float* lower, const float* gammas,
                       const TermSigns& si, int n_iso, float aniso_sign,
                       const float* thr, int n, int m, int T, int split_len,
                       float* acc, unsigned long long* c, cudaStream_t s) {
  constexpr int kThreads = AnisoShape<MM>::threads;
  if (T <= 3) {
    fused_phi_aniso_terms_sym_kernel<MM, kExact, NIso, 3>
        <<<grid, kThreads, 0, s>>>(coords, scores, lower, gammas, si, n_iso,
                                   aniso_sign, thr, n, m, T, split_len, acc,
                                   c);
  } else {
    fused_phi_aniso_terms_sym_kernel<MM, kExact, NIso, kMaxT>
        <<<grid, kThreads, 0, s>>>(coords, scores, lower, gammas, si, n_iso,
                                   aniso_sign, thr, n, m, T, split_len, acc,
                                   c);
  }
}

// The one-pass launch at MM: with one isotropic term its constants in
// registers (exact instances), else any number from shared memory.
template <int MM, bool kExact>
int launch_one_pass(const float* coords, const float* scores,
                    const float* lower, const float* gammas,
                    const TermSigns& si, int n_iso, float aniso_sign,
                    const float* thr, int n, int m, int T, float* acc,
                    unsigned long long* c, cudaStream_t s) {
  using Shape = AnisoShape<MM>;
  const int rows = Shape::threads * Shape::rows;
  const int row_blocks = (n + rows - 1) / rows;
  int splits = (kAnisoTargetBlocks + row_blocks - 1) / row_blocks;
  splits = max(1, min(splits, (n + Shape::cols - 1) / Shape::cols));
  int split_len = (n + splits - 1) / splits;
  split_len = (split_len + Shape::cols - 1) / Shape::cols * Shape::cols;
  splits = (n + split_len - 1) / split_len;
  const dim3 grid(row_blocks, splits);
  if constexpr (kExact) {
    if (n_iso == 1) {
      launch_one_pass_t<MM, kExact, 1>(grid, coords, scores, lower, gammas,
                                       si, n_iso, aniso_sign, thr, n, m, T,
                                       split_len, acc, c, s);
      return static_cast<int>(cudaGetLastError());
    }
  }
  launch_one_pass_t<MM, kExact, 0>(grid, coords, scores, lower, gammas, si,
                                   n_iso, aniso_sign, thr, n, m, T,
                                   split_len, acc, c, s);
  return static_cast<int>(cudaGetLastError());
}

// The single-term groups past kMaxM (see the top of the file): group
// g0 + blockIdx.y, whose blocks walk the whole triangle of tiles of
// kWideSymTile, one weight tile (OneRbf, k_c = w = k). Group 0 (g0 = 0,
// one isotropic term) sweeps x with k = 2^(-gamma log2(e) sq), gamma read
// on the device, and counts; group 1 + t sweeps z_t with k =
// 2^(-|z_i - z_j|^2 log2(e)) and T = 0 (no counts). The signs and group
// 0's 2 gamma are the wrapper's.
template <int kT>
__global__ void __launch_bounds__(kWideSymThreads)
    fused_phi_aniso_terms_wide_groups_kernel(
        const float* __restrict__ coords, const float* __restrict__ z,
        const float* __restrict__ scores, const float* __restrict__ gamma,
        const float* __restrict__ thr, int n, int w, int T, int nb, int g0,
        long long count, float* __restrict__ acc,
        unsigned long long* __restrict__ counts) {
  const int group = g0 + static_cast<int>(blockIdx.y);
  const bool euclid = group == 0;
  const float* rows =
      euclid ? coords : z + static_cast<size_t>(group - 1) * n * w;
  const OneRbf weights{euclid ? -gamma[0] * kLog2e : -kLog2e};
  wide_tri_sm90_body<kT>(rows, scores, weights, thr, n, w, euclid ? T : 0,
                         WideTriWork{nb, 0LL, count},
                         acc + static_cast<size_t>(group) * 2 * w * n,
                         counts);
}

// Group 0 past kMaxM with two or more isotropic terms: K8/K9's two-weight
// instance of the body (AnyTerms: k_c = sum s k in one weight tile, w =
// sum s gamma k in the other) on x, with the counts, into group 0's slab.
template <int kT>
__global__ void __launch_bounds__(kWideSymThreads)
    fused_phi_aniso_terms_wide_iso_kernel(
        const float* __restrict__ coords, const float* __restrict__ scores,
        const float* __restrict__ gammas, TermSigns iso_signs, int n_iso,
        const float* __restrict__ thr, int n, int w, int T, int nb,
        long long count, float* __restrict__ acc,
        unsigned long long* __restrict__ counts) {
  __shared__ float sh_g2[kMaxTerms];
  __shared__ float sh_sn[kMaxTerms];
  __shared__ float sh_sg[kMaxTerms];
  // The body's first barrier comes before its first pair.
  load_terms(gammas, iso_signs, n_iso, sh_g2, sh_sn, sh_sg);
  wide_tri_sm90_body<kT>(coords, scores,
                         AnyTerms{sh_g2, sh_sn, sh_sg, n_iso}, thr, n, w, T,
                         WideTriWork{nb, 0LL, count}, acc, counts);
}

// The wide launches (width w, a multiple of 4): group 0's terms kernel
// where n_iso >= 2, then the single-term groups, group 0 among them where
// n_iso = 1 and not at all where n_iso = 0; each one persistent block an
// SM and group (wide_sym_prepare), kT = 3 or kMaxT.
int launch_aniso_wide(const float* coords, const float* z,
                      const float* scores, const float* gammas,
                      const TermSigns& si, int n_iso, int n_aniso,
                      const float* thr, int n, int w, int T, float* acc,
                      unsigned long long* c, cudaStream_t s) {
  const long long pairs = upper_pairs(n, kWideSymTile);
  if (pairs < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + kWideSymTile - 1) / kWideSymTile;
  if (n_iso >= 2) {
    auto go = [&](auto* kernel) {
      const unsigned int blocks = wide_sym_prepare<true>(kernel, pairs);
      kernel<<<blocks, kWideSymThreads, WideSym<true>::kSmemBytes, s>>>(
          coords, scores, gammas, si, n_iso, thr, n, w, T, nb, pairs, acc,
          c);
    };
    if (T == 3) {
      go(&fused_phi_aniso_terms_wide_iso_kernel<3>);
    } else {
      go(&fused_phi_aniso_terms_wide_iso_kernel<kMaxT>);
    }
  }
  const int g0 = n_iso == 1 ? 0 : 1;
  auto go = [&](auto* kernel) {
    const unsigned int blocks = wide_sym_prepare<false>(kernel, pairs);
    const dim3 grid(blocks, 1 + n_aniso - g0);
    kernel<<<grid, kWideSymThreads, WideSym<false>::kSmemBytes, s>>>(
        coords, z, scores, gammas, thr, n, w, T, nb, g0, pairs, acc, c);
  };
  // Without group 0 no group counts, and the 3-threshold instance
  // compares least.
  if (T == 3 || g0 == 1) {
    go(&fused_phi_aniso_terms_wide_groups_kernel<3>);
  } else {
    go(&fused_phi_aniso_terms_wide_groups_kernel<kMaxT>);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The one-pass anisotropic sweep (see the top of the file): isotropic terms
// and ONE anisotropic term. coords (n, m) centered on their mean, scores
// (n, m), lower (m, m) the factor L of the term's P_sym/2 = L L^T
// (row-major), iso gammas (n_iso,) and thr (T,), all float32 on the
// device; iso_signs (n_iso,) a HOST array and aniso_sign a number, passed
// by value; acc a zeroed (m, n) float32 buffer that receives n phi^T;
// counts a zeroed int64 (T,) buffer that receives the counts of all n^2
// ordered pairs. 1 <= m <= 32, 0 <= n_iso <= 16, 1 <= T <= 8.
int svgd_fused_phi_aniso_terms_sym(const float* coords, const float* scores,
                                   const float* lower, const float* gammas,
                                   const float* iso_signs, int n_iso,
                                   float aniso_sign, const float* thr, int n,
                                   int m, int T, float* acc,
                                   long long* counts, void* stream) {
  if (n <= 0 || T < 1 || T > kMaxT || n_iso < 0 || n_iso > kMaxTerms) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TermSigns si = make_signs(iso_signs, n_iso);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_ONE(MM_, EX_)                                          \
  return launch_one_pass<MM_, EX_>(coords, scores, lower, gammas, si,      \
                                   n_iso, aniso_sign, thr, n, m, T, acc,   \
                                   c, s)
  if (m == 2) SVGD_LAUNCH_ONE(2, true);
  if (m == 11) SVGD_LAUNCH_ONE(11, true);
  if (m >= 1 && m <= 8) SVGD_LAUNCH_ONE(8, false);
  if (m >= 9 && m <= 16) SVGD_LAUNCH_ONE(16, false);
  if (m >= 17 && m <= 32) SVGD_LAUNCH_ONE(32, false);
#undef SVGD_LAUNCH_ONE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The term-group sweep over one particle set: any composition with
// anisotropic terms. coords (n, m) centered on their mean, z (n_aniso, n,
// m) the rows z_t = coords L_t, scores (n, m), iso gammas (n_iso,), thr
// (T,), all float32 on the device;
// iso_signs (n_iso,) and aniso_signs (n_aniso,) HOST arrays, passed by value
// to the kernel; acc a zeroed (1 + n_aniso, 2m, n) float32 buffer, group g's
// [KS_g | D_g]; counts a zeroed int64 (T,) buffer that receives the upper
// count U of the Euclidean distances (diagonal included). m >= 1,
// 0 <= n_iso <= 16, 1 <= n_aniso <= 8, 1 <= T <= 8. Past m = 64 (the wide
// kernels) m is the rows' padded width, a multiple of 4, coords, z and
// scores start on 16-byte boundaries, group 1 + t's KS_g and D_g carry
// neither s_t nor, with one isotropic term, group 0's s and 2 gamma
// (see the top of the file), and with no isotropic term counts is left
// as it is.
int svgd_fused_phi_aniso_terms_groups(const float* coords, const float* z,
                                      const float* scores,
                                      const float* gammas,
                                      const float* iso_signs, int n_iso,
                                      const float* aniso_signs, int n_aniso,
                                      const float* thr, int n, int m, int T,
                                      float* acc, long long* counts,
                                      void* stream) {
  if (n <= 0 || T < 1 || T > kMaxT || n_iso < 0 || n_iso > kMaxTerms ||
      n_aniso < 1 || n_aniso > kMaxAniso) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TermSigns si = make_signs(iso_signs, n_iso);
  AnisoSigns sa{};
  for (int t = 0; t < n_aniso; ++t) sa.s[t] = aniso_signs[t];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
  if (m > kMaxM) {
    if (!wide_rows_ok(m, coords, scores) || !wide_rows_ok(m, z, z)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_aniso_wide(coords, z, scores, gammas, si, n_iso, n_aniso,
                             thr, n, m, T, acc, c, s);
  }
#define SVGD_LAUNCH_ANISO(MM_, EX_)                                        \
  {                                                                        \
    constexpr int tile = SymTermsTile<MM_>::value;                         \
    const long long pairs = upper_pairs(n, tile);                          \
    if (pairs < 0) return static_cast<int>(cudaErrorInvalidValue);        \
    const dim3 grid(static_cast<unsigned int>(pairs), 1 + n_aniso);        \
    fused_phi_aniso_terms_groups_kernel<MM_, EX_, true><<<grid, tile, 0, s>>>(\
        coords, z, scores, gammas, si, n_iso, sa, thr, n, m, T,            \
        (n + tile - 1) / tile, 0LL, acc, c);                               \
  }
  SVGD_DISPATCH_M_2_11(m, SVGD_LAUNCH_ANISO)
#undef SVGD_LAUNCH_ANISO
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
