// RBF phi with one full, fixed precision matrix, for Hopper (sm_90a): the
// sweep over one particle set, no counts, and the decomposition of P.
//
//   k(x_i, x_j) = exp(-d^T P d),  d = x_i - x_j,
//   phi_i = (1/n) sum_j [k_ij s_j + k_ij (P + P^T)(x_i - x_j)],
//
// for a P fixed over the step: a CONSTANT scale, a HESSIAN scale (which may
// be indefinite) or a median's gamma I.
//
// Replaces svgdcpp_tpu/ops/pallas_phi.py:_phi_kernel (K15, called through
// _phi_rbf_pallas_impl; the opt-in phi_impl='pallas' route, 'cuda' here).
//
// The quadratic form. _phi_kernel builds it with the Gram identity
// q_i + q_j - x_i P_sym x_j; so does the wide sweep below, which runs at
// every m but the micro-tile body's (1-8 and 11: k15_wide of
// sweep_common.cuh). At those, P may be indefinite, so Cholesky does not
// apply: P_sym/2 = V diag(lam) V^T is decomposed (svgd_sym_eigen below, or
// by the caller) and the wrapper (ops/cuda_phi.py) passes z = X_c V and
// lam, so d^T P d = sum_k lam_k (z_ik - z_jk)^2: the difference form,
// exact 0 at the self pair, no cancellation. psd != 0
// clamps it at 0, as _phi_kernel does. Since x_i - x_j = (z_i - z_j) V^T,
// the gradient direction is
// sum_j k (x_i - x_j) P_sym = 2 (sum_j k (z_i - z_j)) diag(lam) V^T:
// the kernel accumulates KS and D_z = sum_j k (z_i - z_j), and the wrapper
// applies 2 diag(lam) V^T.
//
// The decomposition (svgd_sym_eigen): P_sym/2 on the card in float64, by
// the cyclic Jacobi method in one block, so the wrapper reads nothing on
// the host (the HESSIAN scale brings a new P every step). The symmetric
// matrix, padded to an even order mp, and V live in shared memory; each
// sweep runs mp - 1 rounds of the round-robin ordering, whose mp/2 pairs
// (p, q) are disjoint and rotate together: the pairs' rotations first (one
// thread each, the textbook t = sgn(theta) / (|theta| + sqrt(theta^2 + 1))
// that zeroes a_pq), then every 2x2 block of A (J_a^T A J_b, the upper
// blocks computed and mirrored, so A stays exactly symmetric) and the
// pairs' columns of V, one barrier after each phase. A pair whose a_pq is
// negligible beside both a_pp and a_qq (100 |a_pq| vanishes in float64
// against each) is not rotated but zeroed, and the first sweep with no
// rotation ends the loop. kJacobiSweeps = 10 bounds it: off-diagonal mass
// falls quadratically and reaches the float64 rounding level by the
// seventh sweep at m = 64 on positive definite, indefinite and clustered
// spectra (a float64 rehearsal of this ordering); the loop ends after
// about six sweeps at m = 11 and nine at m = 64, the last without a
// rotation. Its plain version is torch.linalg.eigh (ops/cuda_phi.py).
// Bound: a few hundred KB of float64 arithmetic at m = 64 and a few KB at
// m = 11, so the kernel is bound by the latency of its 2 (mp - 1) barriers
// a sweep, not by the card's rates.
//
// The sweep (svgd_phi_rbf_square) at m = 1-8 and 11 is a triangle sweep on
// the micro-tile body (micro_tile.cuh, micro_tri_body, with FixedPForm):
// each unordered pair once, its form sum_k lam_k log2(e) dz_k^2 with
// lam log2(e) in registers, one ex2 and no counts, adding k s_j and
// k (z_i - z_j) to row i and k s_i and -k (z_i - z_j) to column j; the
// self pair enters KS once, so the output is the square sweep's. Tiles of
// 128 particles, a block per tile pair (2 warps of 2 rows a thread; one
// warp of 4 rows up to m = 2); a launch of few tile pairs (n = 1500: 78)
// splits each tile pair's chunks over the grid's second dimension
// (tri_splits), so the card still fills. Per unordered pair the function
// needs 4m FP32 operations for the form (the difference, a multiply and an
// FMA a coordinate), a clamp and one ex2, and 4m for KS and D_z in both
// directions (an FMA counted as 2 operations, chip_smoke.py's sweep_bound);
// the operands are a few hundred KB, so the sweep is bound by instruction
// issue.
//
// At every other m (9, 10 and 12 up) the micro-tile body's rows would
// spill, and past m = 64 (kMaxM) the decomposition would not fit one
// block (its order table alone takes 260 KB at m = 512), so the wide sweep
// (svgd_phi_rbf_wide) takes P itself, in _phi_kernel's own form, with no
// decomposition: the wrapper forms
// Y = X_c (P_sym/2) and q_i = x_i . y_i in float64 on the device and casts
// them to float32 (the product the JAX package forms outside its kernel),
// pads X_c, Y and S with zero columns to a multiple of 4 floats
// (sym_plan.wide_row_width: the body's 16-byte copies), and
// wide_tri_sm90.cuh's body sweeps the upper triangle of tiles of 128 on
// one persistent block an SM with its FixedPGram form: the Gram tile
// G = X_I Y_J^T in 3xTF32 (symmetric in the pair, since P_sym is, so one
// weight tile serves both directions), sq = q_i + q_j - 2 G clamped at 0
// only where psd, the self pair pinned to 0, k = exp(-sq) (above 1 for an
// indefinite P) and no counts; then both contractions W [S | X] into the
// zeroed (2m, n) accumulator [KS | D], D = sum_j k (x_i - x_j) from the
// sums as the body forms it. The self pair enters KS in both directions;
// the wrapper subtracts s_i once and applies 2 D (P_sym/2) in float64.
// K2's wide instance sweeps the same triangle at the same widths: the two
// differ in the Gram tile's form alone, and this one counts nothing. The
// Gram form cancels where the difference form does not: the pinned self
// pair is exact, and every other pair's form carries float32 rounding of
// q and G on the scale of |x_c|^2 |P|, as the JAX kernel's does.
//
// The bfloat16 operand opt-in (phi_rbf_pallas(..., dot_dtype='bfloat16'),
// pallas_phi.py:169-201): svgd_phi_rbf_wide_bf16 runs at any m >= 1 on
// bf16_tri_sm90.cuh's body with kAsym: the pack kernel rounds X, Y (whose
// rounding is exactly half that of the JAX kernel's x_c P_sym) and the
// record [S | X | 1] to bf16 once and copies the wrapper's float32 q; the
// body takes both rounded Gram tiles, since bf16(x_i) . bf16(y_j) is not
// bf16(x_j) . bf16(y_i): G2 = Y_I X_J^T for the columns' weights, then
// G1 = X_I Y_J^T for the rows', on bf16 mma.sync with float32
// accumulation; the weights exp(-sq) rounded to bf16, the self pair
// formed like any other and entered once in all (the JAX kernel sweeps
// the square and pins nothing), into the zeroed (2m + 1, n) accumulator
// [KS | KX | rowsum]. The wrapper forms D = rowsum x - KX with the float32
// x, applies 2 D (P_sym/2) in float64 and subtracts nothing.
//
// The entry points return cudaGetLastError() after their launches.

#include "bf16_tri_sm90.cuh"
#include "micro_tile.cuh"
#include "wide_tri_sm90.cuh"

namespace {

using namespace svgd;

// The triangle sweep at the micro-tile body's widths.
template <int MM, bool kExact>
__global__ void __launch_bounds__(MicroTri<MM>::kThreads)
    phi_rbf_sym_kernel(const float* __restrict__ z,
                       const float* __restrict__ scores,
                       const float* __restrict__ lam, int n, int m_arg,
                       int psd, int nb, float* __restrict__ out) {
  const int m = kExact ? MM : m_arg;
  FixedPForm<MM> form;
#pragma unroll
  for (int k = 0; k < MM; ++k) {
    form.lam2[k] = (kExact || k < m) ? lam[k] * kLog2e : 0.0f;
  }
  form.qmin = psd ? 0.0f : -INFINITY;
  micro_tri_body<MM, kExact, 0>(z, scores, form, nullptr, n, m, 0, nb, 0LL,
                                out, nullptr);
}

// The wide sweep (see the top of the file): the upper triangle of tiles of
// kWideSymTile, one persistent block an SM, no counts.
__global__ void __launch_bounds__(kWideSymThreads)
    phi_rbf_wide_kernel(const float* __restrict__ coords,
                        const float* __restrict__ y,
                        const float* __restrict__ q,
                        const float* __restrict__ scores, int n, int m,
                        float qmin, int nb, long long count,
                        float* __restrict__ out) {
  wide_tri_sm90_body<0>(coords, scores, OneRbf{-kLog2e}, nullptr, n, m, 0,
                        WideTriWork{nb, 0LL, count}, out, nullptr,
                        FixedPGram{y, q, qmin});
}

// K15's bf16 instance (every m): bf16_tri_sm90.cuh's body with kAsym over
// the whole triangle of tiles of kBf16Tile, on the packed operands, into
// the (2m + 1, n) accumulator [KS | KX | rowsum].
__global__ void __launch_bounds__(kBf16Threads, 1)
    phi_rbf_wide_bf16_kernel(Bf16Operands ops, int n, int m, float qmin,
                             int nb, long long items,
                             float* __restrict__ acc) {
  bf16_tri_body<0, true>(ops, -kLog2e, nullptr, n, m, 0, items,
                         Bf16TriWork{nb, n, acc}, nullptr, qmin);
}

// The clamp's floor: 0 for a P taken as positive semidefinite, else none.
inline float form_floor(int psd) { return psd ? 0.0f : -INFINITY; }

// The Jacobi decomposition of P_sym/2 (see the top of the file).
constexpr int kJacobiSweeps = 10;
constexpr int kJacobiMaxThreads = 1024;

__global__ void __launch_bounds__(kJacobiMaxThreads)
    sym_eigen_jacobi_kernel(const double* __restrict__ p, int m,
                            double* __restrict__ lam,
                            double* __restrict__ v_out) {
  extern __shared__ double sh[];
  // The circle ordering's pairs of every round, computed once: round r
  // pairs mp - 1 with r, and (r + k) mod (mp - 1) with (r - k) mod (mp - 1).
  __shared__ unsigned char sh_order[kMaxM - 1][kMaxM / 2][2];
  __shared__ int sh_p[kMaxM / 2];
  __shared__ int sh_q[kMaxM / 2];
  __shared__ double sh_c[kMaxM / 2];
  __shared__ double sh_s[kMaxM / 2];
  __shared__ int sh_rotated[kJacobiSweeps];  // a rotation in sweep k
  const int mp = m + (m & 1);  // an odd m gains a decoupled zero row
  const int half = mp / 2;
  const int ld = mp + 1;
  double* a = sh;
  double* v = sh + mp * ld;
  const int tid = static_cast<int>(threadIdx.x);
  const int nt = static_cast<int>(blockDim.x);
  for (int e = tid; e < mp * mp; e += nt) {
    const int i = e / mp;
    const int j = e - i * mp;
    a[i * ld + j] = (i < m && j < m) ? 0.5 * (p[i * m + j] + p[j * m + i])
                                     : 0.0;
    v[i * ld + j] = i == j ? 1.0 : 0.0;
  }
  for (int k = tid; k < kJacobiSweeps; k += nt) sh_rotated[k] = 0;
  for (int e = tid; e < (mp - 1) * half; e += nt) {
    const int r = e / half;
    const int k = e - r * half;
    const int pp = k == 0 ? mp - 1 : (r + k) % (mp - 1);
    const int qq = k == 0 ? r : (r - k + mp - 1) % (mp - 1);
    sh_order[r][k][0] = static_cast<unsigned char>(min(pp, qq));
    sh_order[r][k][1] = static_cast<unsigned char>(max(pp, qq));
  }
  __syncthreads();
  for (int sweep = 0; sweep < kJacobiSweeps; ++sweep) {
    for (int r = 0; r < mp - 1; ++r) {
      if (tid < half) {
        const int pp = sh_order[r][tid][0];
        const int qq = sh_order[r][tid][1];
        const double apq = a[pp * ld + qq];
        const double app = a[pp * ld + pp];
        const double aqq = a[qq * ld + qq];
        double c = 1.0;
        double s = 0.0;
        // A pair negligible against both diagonal entries at float64
        // precision is not rotated; its 2x2 block's update zeroes it.
        const double g = 100.0 * fabs(apq);
        if (fabs(app) + g != fabs(app) || fabs(aqq) + g != fabs(aqq)) {
          sh_rotated[sweep] = 1;
          // t = sgn(theta) / (|theta| + sqrt(theta^2 + 1)) with
          // theta = tau / (2 a_pq), in one division.
          const double tau = aqq - app;
          const double t =
              (tau >= 0.0 ? 2.0 * apq : -2.0 * apq) /
              (fabs(tau) + sqrt(fma(tau, tau, 4.0 * apq * apq)));
          c = rsqrt(fma(t, t, 1.0));
          s = t * c;
        }
        sh_p[tid] = pp;
        sh_q[tid] = qq;
        sh_c[tid] = c;
        sh_s[tid] = s;
      }
      __syncthreads();
      // A <- J^T A J by 2x2 blocks (pair ia's rows, pair ib's columns),
      // the upper blocks computed and mirrored; V <- V J.
      for (int e = tid; e < half * half; e += nt) {
        const int ia = e / half;
        const int ib = e - ia * half;
        if (ia > ib) continue;
        const int pa = sh_p[ia], qa = sh_q[ia], pb = sh_p[ib], qb = sh_q[ib];
        const double ca = sh_c[ia], sa = sh_s[ia];
        const double cb = sh_c[ib], sb = sh_s[ib];
        const double x = a[pa * ld + pb], y = a[pa * ld + qb];
        const double z = a[qa * ld + pb], w = a[qa * ld + qb];
        const double x1 = cb * x - sb * y, y1 = sb * x + cb * y;
        const double z1 = cb * z - sb * w, w1 = sb * z + cb * w;
        const double x2 = ca * x1 - sa * z1;
        const double w2 = sa * y1 + ca * w1;
        const double y2 = ia == ib ? 0.0 : ca * y1 - sa * w1;
        const double z2 = ia == ib ? 0.0 : sa * x1 + ca * z1;
        a[pa * ld + pb] = x2;
        a[pa * ld + qb] = y2;
        a[qa * ld + pb] = z2;
        a[qa * ld + qb] = w2;
        a[pb * ld + pa] = x2;
        a[qb * ld + pa] = y2;
        a[pb * ld + qa] = z2;
        a[qb * ld + qa] = w2;
      }
      for (int e = tid; e < mp * half; e += nt) {
        const int i = e / half;
        const int ib = e - i * half;
        const int pb = sh_p[ib], qb = sh_q[ib];
        const double cb = sh_c[ib], sb = sh_s[ib];
        const double vp = v[i * ld + pb], vq = v[i * ld + qb];
        v[i * ld + pb] = cb * vp - sb * vq;
        v[i * ld + qb] = sb * vp + cb * vq;
      }
      __syncthreads();
    }
    // Block-uniform: a sweep without a rotation leaves A diagonal to
    // working precision, and every later sweep would repeat it.
    if (!sh_rotated[sweep]) break;
  }
  for (int e = tid; e < m * m; e += nt) {
    const int i = e / m;
    const int k = e - i * m;
    v_out[e] = v[i * ld + k];
    if (i == 0) lam[k] = a[k * ld + k];
  }
}

// The fixed-P triangle sweep for the micro-tile instance MM.
template <int MM, bool kExact>
void launch_phi_rbf(const float* z, const float* scores, const float* lam,
                    int n, int m, int psd, float* out, cudaStream_t s) {
  static_assert(MicroTri<MM>::enabled, "the micro-tile body serves MM");
  constexpr int tile = MicroTri<MM>::kSide;
  const int nb = (n + tile - 1) / tile;
  const long long pairs = static_cast<long long>(nb) * (nb + 1) / 2;
  const dim3 grid(static_cast<unsigned int>(pairs), tri_splits<MM>(pairs));
  phi_rbf_sym_kernel<MM, kExact><<<grid, MicroTri<MM>::kThreads, 0, s>>>(
      z, scores, lam, n, m, psd, nb, out);
}

}  // namespace

extern "C" {

// (lam (m,), V (m, m)) with P_sym/2 = V diag(lam) V^T, P_sym = P + P^T,
// for p (m, m) float64 row-major on the device; lam (m,) and v (m, m)
// float64 on the device, written by the kernel (any order of the
// eigenvalues). 1 <= m <= 64. No sweep needs it past m = 11: K15 takes P
// itself wherever k15_wide holds.
int svgd_sym_eigen(const double* p, int m, double* lam, double* v,
                   void* stream) {
  if (m < 1 || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  const int mp = m + (m & 1);
  const int work = mp * (mp / 2);
  int threads = (work + 31) / 32 * 32;
  if (threads > kJacobiMaxThreads) threads = kJacobiMaxThreads;
  const size_t bytes = 2 * static_cast<size_t>(mp) * (mp + 1) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      sym_eigen_jacobi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  sym_eigen_jacobi_kernel<<<1, threads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(p, m, lam, v);
  return static_cast<int>(cudaGetLastError());
}


// [KS | D] (2m, n) of the wide fixed-P sweep (the port's float32 sweep at
// every m but 1-8 and 11: k15_wide). coords
// (n, m) the centered x_c, y (n, m) the rows x_c (P_sym/2), q (n,) the
// norms q_i = x_i . y_i, scores (n, m), all float32 row-major on the
// device, m a multiple of 4 and coords, y and scores on a 16-byte boundary
// (the wrapper pads the rows with zero columns); psd != 0 clamps the form
// at 0; out a zeroed (2m, n) float32 buffer, KS with each self pair twice.
int svgd_phi_rbf_wide(const float* coords, const float* y, const float* q,
                      const float* scores, int n, int m, int psd, float* out,
                      void* stream) {
  if (n <= 0 || m < 1 || !wide_rows_ok(m, coords, scores) ||
      (reinterpret_cast<uintptr_t>(y) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long count = upper_pairs(n, kWideSymTile);
  if (count < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + kWideSymTile - 1) / kWideSymTile;
  const unsigned int blocks =
      wide_sym_prepare<false>(phi_rbf_wide_kernel, count);
  phi_rbf_wide_kernel<<<blocks, kWideSymThreads, WideSym<false>::kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      coords, y, q, scores, n, m, form_floor(psd), nb, count, out);
  return static_cast<int>(cudaGetLastError());
}

// K15's bf16 instance, at any m >= 1: coords, y, q and scores as
// svgd_phi_rbf_wide's, at any alignment and unpadded; psd as there; work a
// 16-byte-aligned workspace of sym_plan.bf16_work_bytes(n, m, gram_y=True)
// bytes, which the pack kernel fills with the rounded operands; out a
// zeroed (2m + 1, n) float32 accumulator that receives [KS | KX | rowsum]
// (each self pair once). Two launches: the pack, then the triangle in
// tiles of kBf16Tile.
int svgd_phi_rbf_wide_bf16(const float* coords, const float* y,
                           const float* q, const float* scores, int n, int m,
                           int psd, void* work, float* out, void* stream) {
  if (n <= 0 || m < 1 || (reinterpret_cast<uintptr_t>(work) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items = upper_pairs(n, kBf16Tile);
  if (items < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + kBf16Tile - 1) / kBf16Tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bf16Operands ops = bf16_tri_pack(coords, scores, n, m, work, s, y, q);
  const unsigned int blocks = bf16_tri_prepare(phi_rbf_wide_bf16_kernel,
                                               items);
  phi_rbf_wide_bf16_kernel<<<blocks, kBf16Threads, Bf16Tri::kSmemBytes, s>>>(
      ops, n, m, form_floor(psd), nb, items, out);
  return static_cast<int>(cudaGetLastError());
}

// [KS | D_z] (2m, n) of the fixed-P triangle sweep at the micro widths
// (m = 1-8 and 11; any other m returns cudaErrorInvalidValue). z (n, m)
// the rows z = X_c V, scores (n, m), lam (m,) the eigenvalues of P_sym/2,
// all float32 row-major on the device; psd != 0 clamps the form at 0; out
// a zeroed (2m, n) float32 buffer, KS with each self pair once.
int svgd_phi_rbf_square(const float* z, const float* scores, const float* lam,
                        int n, int m, int psd, float* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVGD_LAUNCH_PHI_RBF(MM_, EX_)                                   \
  launch_phi_rbf<MM_, EX_>(z, scores, lam, n, m, psd, out, s);
  SVGD_DISPATCH_MICRO_2_11(m, SVGD_LAUNCH_PHI_RBF)
#undef SVGD_LAUNCH_PHI_RBF
  return static_cast<int>(cudaGetLastError());
}

// 1 where the float32 K15 takes svgd_phi_rbf_wide at dimension m
// (k15_wide), else 0: ops/sym_plan.k15_wide's copy is held to it.
int svgd_k15_wide(int m) { return k15_wide(m) ? 1 : 0; }

}  // extern "C"
