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
// One pass gives phi and the counts of the EUCLIDEAN pair squared distances
// at or below each threshold (the median selection's edges):
//
//   phi_i = (KS_i - (sum s) s_i + 2 D_iso_i + sum_t D_t,i (P_t + P_t^T)) / n
//   KS_i = sum_j k(x_i, x_j) s_j,   D_iso_i = sum_j w_ij (x_i - x_j),
//   w = sum_iso s gamma exp(-gamma sq),   D_t,i = sum_j s_t k_t (x_i - x_j),
//
// the (sum s) s_i term removing the self pair that the triangle enters in
// both directions (k_t(i, i) = 1 for every term).
//
// Replaces svgdcpp_tpu/ops/pallas_phi.py:_sym_aniso_terms_kernel (K14,
// called through _phi_rbf_aniso_terms_fused_pallas_sym_impl).
//
// The quadratic forms. The TPU kernel builds each anisotropic form with the
// Gram identity q_i + q_j - 2 x_i (P_sym/2) x_j, which cancels in float32
// and needs HIGHEST-precision dots and a pinned diagonal. Here the wrapper
// (ops/cuda_phi.py) factors P_sym/2 = L_t L_t^T once per step (Cholesky;
// the route's gate proves every term positive definite) and passes
// z_t = X_c L_t, so d^T P_t d = |z_ti - z_tj|^2: the difference form, exact
// 0 at the self pair, no cancellation. Since (x_i - x_j) L_t = z_ti - z_tj,
// the gradient direction follows from the same rows:
// D_t P_sym = 2 (sum_j s_t k_t (z_ti - z_tj)) L_t^T. The kernel accumulates
// that sum, D_zt, and the wrapper applies 2 L_t^T. The Euclidean sq is K2's
// difference form in the plain version's order (sweep_common.cuh), so the
// counts equal the plain version's at m <= 4.
//
// Work per unordered pair, as this design runs it: each term group
// computes its squared distance (3m+1 FP32 ops), one ex2 per term on the
// special function unit plus 4 ops per term to combine, and 10m for the
// two contraction directions (4 FMAs and 2 subtractions per coordinate, an
// FMA counted as 2); group 0 adds T compares. The function itself needs
// less (KS once, each difference once): chip_smoke.py's sweep_bound counts
// that. The operands are a few MB, so the sweep is compute-bound.
//
// Design: the composed kernels' triangle sweep (terms_sym.cuh, K8/K9's
// port) with one more grid dimension, the term group. Group 0 sweeps the
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
// The iso gammas and the thresholds are read from device memory (the host
// never reads them); the signs are static and arrive by value. The kernel
// allocates nothing. The entry point returns cudaGetLastError() after the
// launch.

// The kGroups instances of terms_sym.cuh's sweep, under their own name.
#define SVGD_TERMS_SYM_KERNEL fused_phi_aniso_terms_sym_kernel
#include "terms_sym.cuh"

extern "C" {

// Anisotropic composed-kernel triangle sweep over one particle set. coords
// (n, m) centered on their mean, z (n_aniso, n, m) the rows z_t = coords L_t,
// scores (n, m), iso gammas (n_iso,), thr (T,), all float32 on the device;
// iso_signs (n_iso,) and aniso_signs (n_aniso,) HOST arrays, passed by value
// to the kernel; acc a zeroed (1 + n_aniso, 2m, n) float32 buffer, group g's
// [KS_g | D_g]; counts a zeroed int64 (T,) buffer that receives the upper
// count U of the Euclidean distances (diagonal included). 1 <= m <= 64,
// 0 <= n_iso <= 16, 1 <= n_aniso <= 8, 1 <= T <= 8.
int svgd_fused_phi_aniso_terms_sym(const float* coords, const float* z,
                                   const float* scores, const float* gammas,
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
#define SVGD_LAUNCH_ANISO(MM_, EX_)                                        \
  {                                                                        \
    constexpr int tile = SymTermsTile<MM_>::value;                         \
    const long long pairs = upper_pairs(n, tile);                          \
    if (pairs < 0) return static_cast<int>(cudaErrorInvalidValue);        \
    const dim3 grid(static_cast<unsigned int>(pairs), 1 + n_aniso);        \
    fused_phi_aniso_terms_sym_kernel<MM_, EX_, true><<<grid, tile, 0, s>>>(\
        coords, z, scores, gammas, si, n_iso, sa, thr, n, m, T,            \
        (n + tile - 1) / tile, 0LL, acc, c);                               \
  }
  SVGD_DISPATCH_M_2_11(m, SVGD_LAUNCH_ANISO)
#undef SVGD_LAUNCH_ANISO
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
