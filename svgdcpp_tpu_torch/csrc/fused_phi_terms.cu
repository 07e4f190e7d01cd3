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
//     upper-triangle sweeps.
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

#include "sweep_common.cuh"

namespace {

using namespace svgd;

constexpr int kMaxTerms = 16;  // MAX_RBF_TERMS of kernels/algebra.py

struct TermSigns {
  float s[kMaxTerms];
};

// Per-term constants in shared memory (broadcast reads): -gamma_t log2(e),
// s_t and s_t gamma_t. Called by every thread before the block's first
// __syncthreads().
__device__ __forceinline__ void load_terms(const float* __restrict__ gammas,
                                           const TermSigns& signs, int nterms,
                                           float* sh_g2, float* sh_sn,
                                           float* sh_sg) {
  for (int t = threadIdx.x; t < nterms; t += blockDim.x) {
    const float g = gammas[t];
    sh_g2[t] = -g * kLog2e;
    sh_sn[t] = signs.s[t];
    sh_sg[t] = signs.s[t] * g;
  }
}

// (k_c, w) of one pair from its squared distance.
__device__ __forceinline__ void combine_terms(float sq, int nterms,
                                              const float* sh_g2,
                                              const float* sh_sn,
                                              const float* sh_sg, float* kc,
                                              float* w) {
  float a = 0.0f;
  float b = 0.0f;
#pragma unroll
  for (int t = 0; t < kMaxTerms; ++t) {
    if (t >= nterms) break;
    const float kt = exp2f(sh_g2[t] * sq);
    a = fmaf(sh_sn[t], kt, a);
    b = fmaf(sh_sg[t], kt, b);
  }
  *kc = a;
  *w = b;
}

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

// ---------------------------------------------------------------------------
// fused_phi_terms_sym (K8, K9)
//
// fused_phi_counts_sym's design (fused_phi.cu) with TWO padded shared
// tiles, k_c and w, in place of k: one block per upper-triangle tile pair
// (bi <= bj) from a linear block index, diagonal tile masked to j >= i.
// Thread r accumulates row i = bi*kTile + r in registers and stores the
// pair's (k_c, w) to the shared tiles; then thread r owns column
// j = bj*kTile + r and accumulates k_c s_i and w (x_j - x_i) from them.
// Both directions flush with float32 atomicAdd into a zeroed (2m, n)
// accumulator [KS | D]. The self pair (k_t = 1 for every term) enters KS in
// both directions, so the wrapper subtracts (sum_t s_t) s_i once: the JAX
// epilogue's per-term "acc - B" (pallas_phi.py:2514-2528) summed over the
// terms. The counts receive U, the upper count with the diagonal; the
// wrapper forms 2U - n. Tiles are 64 particles up to m = 12 and 32 above,
// so the six shared tiles stay within 48 KB of static shared memory.
// ---------------------------------------------------------------------------

template <int MM>
struct SymTermsTile {
  static constexpr int value = MM <= 12 ? 64 : 32;
};

template <int MM, bool kExact>
__global__ void __launch_bounds__(SymTermsTile<MM>::value)
    fused_phi_terms_sym_kernel(const float* __restrict__ coords,
                               const float* __restrict__ scores,
                               const float* __restrict__ gammas,
                               TermSigns signs, int nterms,
                               const float* __restrict__ thr, int n, int m_arg,
                               int T, int nb, float* __restrict__ acc,
                               unsigned long long* __restrict__ counts) {
  constexpr int kTile = SymTermsTile<MM>::value;
  __shared__ float sh_kc[kTile][kTile + 1];
  __shared__ float sh_w[kTile][kTile + 1];
  __shared__ float sh_xi[kTile * MM];
  __shared__ float sh_si[kTile * MM];
  __shared__ float sh_xj[kTile * MM];
  __shared__ float sh_sj[kTile * MM];
  __shared__ float sh_g2[kMaxTerms];
  __shared__ float sh_sn[kMaxTerms];
  __shared__ float sh_sg[kMaxTerms];

  load_terms(gammas, signs, nterms, sh_g2, sh_sn, sh_sg);

  const int m = kExact ? MM : m_arg;
  int bi, bj;
  decode_upper_pair(static_cast<long long>(blockIdx.x), nb, &bi, &bj);
  const int r = threadIdx.x;
  const int i0 = bi * kTile;
  const int j0 = bj * kTile;

  for (int e = r; e < kTile * m; e += kTile) {
    const int p = e / m;
    const bool ok_i = i0 + p < n;
    const bool ok_j = j0 + p < n;
    sh_xi[e] = ok_i ? coords[static_cast<size_t>(i0) * m + e] : 0.0f;
    sh_si[e] = ok_i ? scores[static_cast<size_t>(i0) * m + e] : 0.0f;
    sh_xj[e] = ok_j ? coords[static_cast<size_t>(j0) * m + e] : 0.0f;
    sh_sj[e] = ok_j ? scores[static_cast<size_t>(j0) * m + e] : 0.0f;
  }
  __syncthreads();

  float th[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) th[t] = (t < T) ? thr[t] : 0.0f;

  // Row direction: thread r owns particle i.
  const int i = i0 + r;
  const bool row_ok = i < n;
  float xi[MM];
  float acc_s[MM];
  float acc_d[MM];
#pragma unroll
  for (int k = 0; k < MM; ++k) {
    xi[k] = (kExact || k < m) ? sh_xi[r * m + k] : 0.0f;
    acc_s[k] = 0.0f;
    acc_d[k] = 0.0f;
  }
  unsigned int cnt[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) cnt[t] = 0u;

  for (int jj = 0; jj < kTile; ++jj) {
    const int j = j0 + jj;
    float kc = 0.0f;
    float w = 0.0f;
    if (row_ok && j < n && j >= i) {
      const float* xj = sh_xj + jj * m;
      const float* sj = sh_sj + jj * m;
      const float sq = pair_sq<MM, kExact>(xi, xj, m);
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
    sh_kc[r][jj] = kc;
    sh_w[r][jj] = w;
  }
  if (row_ok) {
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      if (kExact || k < m) {
        atomicAdd(acc + static_cast<size_t>(k) * n + i, acc_s[k]);
        atomicAdd(acc + static_cast<size_t>(m + k) * n + i, acc_d[k]);
      }
    }
  }
  flush_counts(cnt, T, counts);
  __syncthreads();  // the k_c and w tiles are complete

  // Column direction: thread r owns particle j. Masked pairs hold 0.
  const int j = j0 + r;
  if (j < n) {
    float xj[MM];
    float col_s[MM];
    float col_d[MM];
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      xj[k] = (kExact || k < m) ? sh_xj[r * m + k] : 0.0f;
      col_s[k] = 0.0f;
      col_d[k] = 0.0f;
    }
    for (int ii = 0; ii < kTile; ++ii) {
      const float kc = sh_kc[ii][r];
      const float w = sh_w[ii][r];
      const float* x_i = sh_xi + ii * m;
      const float* s_i = sh_si + ii * m;
#pragma unroll
      for (int k = 0; k < MM; ++k) {
        if (kExact || k < m) {
          col_s[k] = fmaf(kc, s_i[k], col_s[k]);
          col_d[k] = fmaf(w, xj[k] - x_i[k], col_d[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      if (kExact || k < m) {
        atomicAdd(acc + static_cast<size_t>(k) * n + j, col_s[k]);
        atomicAdd(acc + static_cast<size_t>(m + k) * n + j, col_d[k]);
      }
    }
  }
}

TermSigns make_signs(const float* signs, int nterms) {
  TermSigns out{};
  for (int t = 0; t < nterms; ++t) out.s[t] = signs[t];
  return out;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = reinterpret_cast<unsigned long long*>(counts);
#define SVGD_LAUNCH_TERMS_SYM(MM_, EX_)                                    \
  {                                                                        \
    constexpr int tile = SymTermsTile<MM_>::value;                         \
    const long long pairs = upper_pairs(n, tile);                          \
    if (pairs < 0) return static_cast<int>(cudaErrorInvalidValue);        \
    fused_phi_terms_sym_kernel<MM_, EX_>                                   \
        <<<static_cast<unsigned int>(pairs), tile, 0, s>>>(                \
            coords, scores, gammas, sg, nterms, thr, n, m, T,              \
            (n + tile - 1) / tile, acc, c);                                \
  }
  SVGD_DISPATCH_M(m, SVGD_LAUNCH_TERMS_SYM)
#undef SVGD_LAUNCH_TERMS_SYM
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
