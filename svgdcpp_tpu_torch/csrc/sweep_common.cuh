// Device helpers shared by the sweeps (fused_phi.cu, fused_phi_terms.cu,
// counts_sym.cuh, terms_sym.cuh, micro_tile.cuh, square_mma.cuh,
// wide_tri.cuh, fused_phi_aniso.cu, phi_rbf.cu, fused_phi_panel.cu,
// count_le.cu): the pair's squared distance in the plain version's order,
// the flushed-to-zero ex2 of the weights, threshold counting (at a runtime
// or a compile-time number of thresholds), the exact count flush, the
// upper-triangle tile decode, the pair's weights (one RBF, or the
// signed-term combination of the composed kernels), and the dispatch from
// a runtime dimension m to a kernel instance.
//
// Kernel instances. A kernel is a template over <MM, kExact>: with kExact
// the dimension is exactly MM (every loop over the coordinates is unrolled
// with no guard); without it the dimension is a runtime m <= MM and every
// coordinate k >= m is skipped by a guard that the unrolled loop folds into
// predicates. Per-thread vectors are MM-long register arrays either way.
// SVGD_DISPATCH_M picks the exact instance for m = 1..8, 11 and 50 (the
// flagship, hierarchical-BLR and flat-BLR widths), the runtime instance
// with MM = 16, 32 or 64 for every other m up to 64 (kMaxM), and past it
// the wide instance, MM = kWideMM, whose body holds no per-coordinate
// array (square_mma.cuh's square_wide_body; the triangles'
// wide_tri_sm90.cuh). The bf16 instances of K2 and K3 take no MM: they run
// bf16_tri_sm90.cuh's body at every m.
// SVGD_DISPATCH_M_2_11, for the kernels with fewer main
// paths (the panels, K14's term groups, K15), has exact instances for
// m = 2 and 11 only and runtime ones with MM = 8, 16, 32 or 64, and
// refuses m past kMaxM: each of those kernels takes its wide instance
// before it.

#pragma once

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace svgd {

constexpr int kMaxT = 8;  // thresholds held in registers
// The largest dimension of the instances whose rows live in MM-long
// register arrays; past it the wide instance, MM = kWideMM (0: no
// dimension fixed at compile time), serves any m.
constexpr int kMaxM = 64;
constexpr int kWideMM = 0;
constexpr float kLog2e = 1.4426950408889634f;

// The square sweeps: one thread per target row, kSqThreads rows a block,
// sources staged through shared memory SqTile<MM>::value rows at a time
// (shorter for wide m, so the coordinate and score tiles stay within 48 KB
// of static shared memory).
constexpr int kSqThreads = 128;

template <int MM>
struct SqTile {
  static constexpr int value = MM <= 16 ? 256 : (MM <= 32 ? 128 : 64);
};

// sq = |xi - xj|^2 over the first m coordinates, summed from k = 0 up, each
// product and sum rounded on its own (no FMA contraction): the plain torch
// version's difference form, so the counts of both agree exactly.
template <int MM, bool kExact>
__device__ __forceinline__ float pair_sq(const float* xi, const float* xj,
                                         int m) {
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < MM; ++k) {
    if (kExact || k < m) {
      const float d = __fsub_rn(xi[k], xj[k]);
      sq = k == 0 ? __fmul_rn(d, d) : __fadd_rn(sq, __fmul_rn(d, d));
    }
  }
  return sq;
}

// 2^x on the special function unit, subnormal results flushed to zero: a
// weight below 2^-126 is far below the float32 resolution of a row's KS,
// which holds the self pair's k = 1.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void count_pair(float sq, const float* th, int T,
                                           unsigned int* cnt) {
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    if (t < T) cnt[t] += (sq <= th[t]) ? 1u : 0u;
  }
}

// cnt += (sq <= th), as one compare into a predicate and one predicated
// add: written in PTX, since the compiler otherwise selects between cnt and
// cnt + 1, a third instruction.
__device__ __forceinline__ void add_if_le(unsigned int& cnt, float sq,
                                          float th) {
  asm("{\n\t.reg .pred p;\n\tsetp.le.f32 p, %1, %2;\n\t"
      "@p add.u32 %0, %0, 1;\n\t}"
      : "+r"(cnt)
      : "f"(sq), "f"(th));
}

// count_pair over a compile-time number of thresholds kT, for a pair whose
// validity is `ok` where kGuard is set (else the pair is valid): two
// instructions per threshold on an unguarded pair, no guard on T. A kernel
// that takes a runtime T <= kMaxT calls it with kT = kMaxT; the counters
// past T take any thresholds and are never flushed.
template <int kT, bool kGuard>
__device__ __forceinline__ void count_pair_fixed(float sq, const float* th,
                                                 bool ok, unsigned int* cnt) {
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    if (kGuard) {
      cnt[t] += (ok && sq <= th[t]) ? 1u : 0u;
    } else {
      add_if_le(cnt[t], sq, th[t]);
    }
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

// Tile pair (bi <= bj) of the upper triangle from a linear block index t.
// Row i of the triangle holds nb - i tiles; rows before i hold
// off(i) = i*nb - i*(i-1)/2. Solve off(i) <= t < off(i+1) in double, then
// correct the rounding with integer steps.
__device__ __forceinline__ void decode_upper_pair(long long t, int nb, int* bi,
                                                  int* bj) {
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

// Number of blocks of an upper-triangle launch over n particles in tiles of
// `tile`, or -1 when it does not fit a one-dimensional grid.
inline long long upper_pairs(int n, int tile) {
  const long long nb = (n + tile - 1) / tile;
  const long long pairs = nb * (nb + 1) / 2;
  return pairs > 0x7fffffffLL ? -1 : pairs;
}

// The widths whose rows the micro-tile triangle body (micro_tile.cuh,
// micro_tri_body) keeps in registers: m = 1-8 and 11. Wider rows would
// spill.
template <int MM>
struct MicroWidth {
  static constexpr bool value = MM >= 1 && (MM <= 8 || MM == 11);
};

// The wide triangle body's tiles (wide_tri.cuh's wide_pair_body): 64
// particles a side, for its users (K14's groups, K15 and its bf16
// instance, the panels). The bf16 triangle body's are kBf16Tile = 128
// (bf16_tri_sm90.cuh).
constexpr int kWideTile = 64;

// The float32 triangle sweeps' tiles past kMaxM (wide_tri_sm90.cuh: K2/K4
// and K8-K11 at MM = kWideMM): 128 particles a side, for one RBF and for
// terms alike.
constexpr int kWideSymTile = 128;

// The single-RBF one-row-a-thread triangle body (counts_sym.cuh): tiles of
// 64 particles up to m = 16 and 32 above, so the padded pair tile and the
// four coordinate/score tiles stay within 48 KB of static shared memory.
template <int MM>
struct SymRowTile {
  static constexpr int value = MM <= 16 ? 64 : 32;
};

// The single-RBF triangle kernels' tiles (fused_phi.cu, K2's and K4's
// ports): 128 particles a side where the micro-tile body serves the
// instance and past kMaxM (kWideSymTile), else SymRowTile. svgd_sym_tile exports it and
// ops/sym_plan.sym_tile mirrors it.
template <int MM>
struct SymTile {
  static constexpr int value =
      MM == kWideMM ? kWideSymTile
                    : (MicroWidth<MM>::value ? 128 : SymRowTile<MM>::value);
};

// The composed kernels' triangle sweeps: tiles of 64 particles up to m = 12
// and 32 above, so two padded pair tiles and four coordinate/score tiles
// stay within 48 KB of static shared memory.
template <int MM>
struct SymTermsTile {
  static constexpr int value = MM <= 12 ? 64 : 32;
};

// The terms triangle kernels' tiles (fused_phi_terms.cu): 128 particles a
// side where the micro-tile body serves the instance (MicroWidth) and past
// kMaxM (kWideSymTile), else the one-row-a-thread body's SymTermsTile
// (terms_sym.cuh). svgd_sym_tile
// exports it and ops/sym_plan.sym_tile mirrors it.
template <int MM>
struct TermsTriTile {
  static constexpr int value =
      MM == kWideMM ? kWideSymTile
                    : (MicroWidth<MM>::value ? 128 : SymTermsTile<MM>::value);
};

// The triangle sweeps' launch over tiles [t0, t0 + count) of the tile list:
// the whole triangle (t0 = 0, count = upper_pairs) or one rank's chunk. An
// empty chunk launches nothing. Returns false for a range outside the list.
inline bool tile_range_ok(int n, int tile, long long t0, long long count) {
  const long long pairs = upper_pairs(n, tile);
  return pairs >= 0 && t0 >= 0 && count >= 0 && t0 + count <= pairs;
}

// Signed RBF terms sharing one squared distance sq:
//   k_c = sum_t s_t exp(-gamma_t sq),   w = sum_t s_t gamma_t exp(-gamma_t sq).
constexpr int kMaxTerms = 16;  // MAX_RBF_TERMS of kernels/algebra.py

struct TermSigns {
  float s[kMaxTerms];
};

// The anisotropic sweep's term groups (terms_sym.cuh): MAX_ANISO_TERMS of
// ops/cuda_phi.py.
constexpr int kMaxAniso = 8;

struct AnisoSigns {
  float s[kMaxAniso];
};

inline TermSigns make_signs(const float* signs, int nterms) {
  TermSigns out{};
  for (int t = 0; t < nterms; ++t) out.s[t] = signs[t];
  return out;
}

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

// The pair's weights (k_c, w) from its sq: k_c multiplies the scores into
// KS and w the differences into D. One RBF: k_c = w = 2^(-gamma log2(e) sq)
// (D is scaled by 2 gamma in the epilogue).
struct OneRbf {
  static constexpr bool kFixedP = false;
  float ng2;  // -gamma log2(e)

  __device__ __forceinline__ void operator()(float sq, float& kc,
                                             float& w) const {
    kc = ex2_ftz(ng2 * sq);
    w = kc;
  }
};

// The same for a composed kernel, for the sweeps that keep the weights in
// registers (micro_tile.cuh, square_mma.cuh, fused_phi_aniso.cu). NT
// signed terms: k_c = sum_t s_t k_t, w = sum_t s_t gamma_t k_t,
// k_t = 2^(-gamma_t log2(e) sq), the terms' constants -gamma_t log2(e),
// s_t and s_t gamma_t in registers, set once per thread.
template <int NT>
struct FixedTerms {
  static constexpr bool kFixedP = false;  // the Euclidean sq (micro_tile.cuh)
  float ng2[NT];
  float sn[NT];
  float sg[NT];

  __device__ __forceinline__ FixedTerms(const float* __restrict__ gammas,
                                        const TermSigns& signs) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float g = gammas[t];
      ng2[t] = -g * kLog2e;
      sn[t] = signs.s[t];
      sg[t] = signs.s[t] * g;
    }
  }

  __device__ __forceinline__ void operator()(float sq, float& kc,
                                             float& w) const {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float e = ex2_ftz(ng2[t] * sq);
      kc = t == 0 ? sn[t] * e : fmaf(sn[t], e, kc);
      w = t == 0 ? sg[t] * e : fmaf(sg[t], e, w);
    }
  }
};

// The same over a runtime number of terms, 0 <= nterms <= kMaxTerms (none:
// k_c = w = 0), with the constants in shared memory (load_terms).
struct AnyTerms {
  static constexpr bool kFixedP = false;
  const float* g2;
  const float* sn;
  const float* sg;
  int nterms;

  __device__ __forceinline__ void operator()(float sq, float& kc,
                                             float& w) const {
    kc = 0.0f;
    w = 0.0f;
    // Rolled: the body inlines this loop into every row of every unrolled
    // step, and a partially unrolled copy spills at MM = 2.
#pragma unroll 1
    for (int t = 0; t < nterms; ++t) {
      const float e = ex2_ftz(g2[t] * sq);
      kc = fmaf(sn[t], e, kc);
      w = fmaf(sg[t], e, w);
    }
  }
};

}  // namespace svgd

// LAUNCH(MM, kExact) for the instance that serves dimension m, the wide
// one (kWideMM) past kMaxM; an m below 1 returns cudaErrorInvalidValue from
// the enclosing function.
#define SVGD_DISPATCH_M(m, LAUNCH)                                      \
  switch (m) {                                                          \
    case 1: LAUNCH(1, true); break;                                     \
    case 2: LAUNCH(2, true); break;                                     \
    case 3: LAUNCH(3, true); break;                                     \
    case 4: LAUNCH(4, true); break;                                     \
    case 5: LAUNCH(5, true); break;                                     \
    case 6: LAUNCH(6, true); break;                                     \
    case 7: LAUNCH(7, true); break;                                     \
    case 8: LAUNCH(8, true); break;                                     \
    case 11: LAUNCH(11, true); break;                                   \
    case 50: LAUNCH(50, true); break;                                   \
    default:                                                            \
      if (m >= 9 && m <= 16) {                                          \
        LAUNCH(16, false);                                              \
      } else if (m >= 17 && m <= 32) {                                  \
        LAUNCH(32, false);                                              \
      } else if (m >= 33 && m <= svgd::kMaxM) {                         \
        LAUNCH(64, false);                                              \
      } else if (m > svgd::kMaxM) {                                     \
        LAUNCH(svgd::kWideMM, false);                                   \
      } else {                                                          \
        return static_cast<int>(cudaErrorInvalidValue);                 \
      }                                                                 \
  }

// As SVGD_DISPATCH_M with fewer exact instances; an m outside 1..kMaxM
// returns cudaErrorInvalidValue (the panels' SVGD_DISPATCH_PANEL_M and
// K14's entry take their wide instances past kMaxM before this dispatch,
// and K15's wide sweep has an entry of its own, svgd_phi_rbf_wide).
#define SVGD_DISPATCH_M_2_11(m, LAUNCH)                                 \
  switch (m) {                                                          \
    case 2: LAUNCH(2, true); break;                                     \
    case 11: LAUNCH(11, true); break;                                   \
    default:                                                            \
      if (m >= 1 && m <= 8) {                                           \
        LAUNCH(8, false);                                               \
      } else if (m >= 9 && m <= 16) {                                   \
        LAUNCH(16, false);                                              \
      } else if (m >= 17 && m <= 32) {                                  \
        LAUNCH(32, false);                                              \
      } else if (m >= 33 && m <= svgd::kMaxM) {                         \
        LAUNCH(64, false);                                              \
      } else {                                                          \
        return static_cast<int>(cudaErrorInvalidValue);                 \
      }                                                                 \
  }
