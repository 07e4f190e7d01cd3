// The square/cross sweep's tensor-core body (K1's port past m = 4,
// fused_phi.cu): the per-pair work of one RBF at wide m moved onto
// Hopper's tensor cores, as the TPU kernel puts it on its matrix unit
// (pallas_phi.py:_fused_kernel, jnp.dot(k_tile, b_ref)).
//
// A block of kSqMmaWarps warps owns kSqMmaRows = 64 target rows, 16 a warp,
// and sweeps one split of the sources (a range of whole kSqMmaCols-column
// tiles, blockIdx.y of gridDim.y). Per tile of 32 sources:
//
//   1. the tile's coordinates and scores arrive in shared memory by
//      cp.async, a tile ahead (double-buffered raw copies);
//   2. the block splits them into the operand records [S | X | 1 | 0..]
//      of each source, every value a TF32 pair (big = tf32(v), small =
//      tf32(v - big)), and the sources' squared norms;
//   3. per group of 8 sources each warp forms the Gram tile
//      G = X_t X_s^T (16 x 8) with mma.sync m16n8k8 in 3xTF32 (big*big +
//      big*small + small*big: float32-level products, never plain TF32),
//      sq = max(0, |x_i|^2 + |x_j|^2 - 2 G) and k = 2^(-gamma log2(e) sq)
//      on the CUDA cores, counts sq against the thresholds, and adds
//      K (16 x 8) . [S | X | 1] (8 x W) into its accumulator fragments,
//      again in 3xTF32. The Gram tile's fragment (columns 2t, 2t+1 of
//      thread t of a quad) is the product's A fragment (columns t, t+4)
//      once the 8 sources are taken in the order 0, 2, 4, 6, 1, 3, 5, 7,
//      so k never leaves registers; the B fragment reads the records in
//      the same order.
//
// The accumulators [KS | KX | rowsum] (W = 2m + 1 columns, padded to a
// multiple of 8) stay in MMA fragments, 4 floats a thread per 8 columns,
// the target rows in A fragments (TF32 pairs), so no thread holds the 3m
// floats of a row. At the end each block writes its split's partial
// accumulators to the workspace and its counts through flush_counts; the
// finishing pass (fused_phi.cu) sums the splits in order and forms
// D = rowsum x_i - KX, as the plain version does at these widths
// (ops/phi.phi_rbf_terms_cross_fused_counts): with the Gram sq and the
// 3xTF32 products both agree with it at float32 level. On grid inputs
// (multiples of 1/8) every product and sum is exact, so the counts equal
// the plain version's.

#pragma once

#include "sweep_common.cuh"

namespace svgd {

constexpr int kSqMmaWarps = 4;
constexpr int kSqMmaThreads = 32 * kSqMmaWarps;
constexpr int kSqMmaRows = 16 * kSqMmaWarps;  // target rows a block
constexpr int kSqMmaCols = 32;                // sources a tile

// The body's shape for width MM: KS k-steps of 8 coordinates for the Gram
// tile, NB blocks of 8 accumulator columns for W = 2m + 1, operand records
// kLd floats apart (kLd = 4 mod 8: the B fragments' reads, rows g or 2t,
// 2t + 1 of a group, fall in distinct banks), and the dynamic shared
// memory: two raw tiles of coordinates and scores, the big and small
// records, and the sources' squared norms.
template <int MM>
struct SqMma {
  static constexpr int KS = (MM + 7) / 8;
  static constexpr int NB = (2 * MM + 1 + 7) / 8;
  static constexpr int kLd = 8 * NB + 4;
  static constexpr int kRaw = kSqMmaCols * MM;  // floats of one raw array
  static constexpr int kRec = kSqMmaCols * kLd;  // floats of one record set
  static constexpr size_t kSmemBytes =
      sizeof(float) * (4 * kRaw + 2 * kRec + kSqMmaCols);
};

__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x = big + small to about 2^-22 of x: the 3xTF32 operand pair.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_of(x);
  small = tf32_of(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two small products first, then big * big.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const float* rec_big,
                                           const float* rec_small, int off0,
                                           int off1) {
  const uint32_t bb0 = __float_as_uint(rec_big[off0]);
  const uint32_t bb1 = __float_as_uint(rec_big[off1]);
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, __float_as_uint(rec_small[off0]),
           __float_as_uint(rec_small[off1]));
  mma_tf32(d, ab, bb0, bb1);
}

// 16 bytes from global to shared memory, the bytes past `valid` (0-16)
// zero-filled; committed by the caller.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int valid) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// The raw copies of one tile: the kSqMmaCols sources from j0 on, m floats
// each, coordinates and scores (zero past n_s).
__device__ __forceinline__ void sq_mma_fetch(const float* __restrict__ sources,
                                             const float* __restrict__ scores,
                                             int n_s, int m, int j0,
                                             float* raw_x, float* raw_s) {
  const long long total = static_cast<long long>(n_s) * m;
  const long long base = static_cast<long long>(j0) * m;
  const int vecs = kSqMmaCols * m / 4;
  for (int v = threadIdx.x; v < vecs; v += kSqMmaThreads) {
    const long long at = base + 4LL * v;
    const long long left = total - at;
    const int valid = left >= 4 ? 16 : (left > 0 ? 4 * static_cast<int>(left)
                                                 : 0);
    const long long src = valid > 0 ? at : 0;
    cp_async16(raw_x + 4 * v, sources + src, valid);
    cp_async16(raw_s + 4 * v, scores + src, valid);
  }
}

// The block body (see the top of the file). part: this split's (n_t, W)
// slice of the workspace, W = 2m + 1; kT thresholds (3, or kMaxT for a
// runtime T padded with the first threshold).
template <int MM, bool kExact, int kT>
__device__ __forceinline__ void square_mma_body(
    const float* __restrict__ targets, const float* __restrict__ sources,
    const float* __restrict__ scores, float ng2, const float* __restrict__ thr,
    int n_t, int n_s, int m_arg, int T, int chunk, float* __restrict__ part,
    unsigned long long* __restrict__ counts) {
  using S = SqMma<MM>;
  constexpr int KS = S::KS;
  constexpr int NB = S::NB;
  constexpr int LD = S::kLd;
  extern __shared__ __align__(16) float sh[];
  float* raw = sh;                   // [2][x | s][kRaw]
  float* rec_big = sh + 4 * S::kRaw;
  float* rec_small = rec_big + S::kRec;
  float* norm_s = rec_small + S::kRec;

  const int m = kExact ? MM : m_arg;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the fragment's row (and B's column)
  const int t = lane & 3;   // the thread in the quad
  const int j_begin = static_cast<int>(blockIdx.y) * chunk;
  const int j_end = min(n_s, j_begin + chunk);
  const int tiles = (j_end - j_begin + kSqMmaCols - 1) / kSqMmaCols;

  float th[kT];
#pragma unroll
  for (int q = 0; q < kT; ++q) th[q] = thr[q < T ? q : 0];

  // The warp's 16 target rows as A fragments of TF32 pairs, and their
  // squared norms (each thread holds 2 of every 8 coordinates of rows g
  // and g + 8; the quad sums the rest).
  const int r0 = static_cast<int>(blockIdx.x) * kSqMmaRows + 16 * warp + g;
  const bool ok0 = r0 < n_t;
  const bool ok1 = r0 + 8 < n_t;
  uint32_t a_big[KS][4];
  uint32_t a_small[KS][4];
  float nt0 = 0.0f;
  float nt1 = 0.0f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 8 * ks + t + 4 * h;
      const bool kin = k < m;
      const float v0 =
          ok0 && kin ? targets[static_cast<size_t>(r0) * m + k] : 0.0f;
      const float v1 =
          ok1 && kin ? targets[static_cast<size_t>(r0 + 8) * m + k] : 0.0f;
      nt0 = fmaf(v0, v0, nt0);
      nt1 = fmaf(v1, v1, nt1);
      tf32_split(v0, a_big[ks][2 * h], a_small[ks][2 * h]);
      tf32_split(v1, a_big[ks][2 * h + 1], a_small[ks][2 * h + 1]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    nt0 += __shfl_xor_sync(0xffffffffu, nt0, off);
    nt1 += __shfl_xor_sync(0xffffffffu, nt1, off);
  }

  float acc[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[b][q] = 0.0f;
  }
  unsigned int cnt[kMaxT];
#pragma unroll
  for (int q = 0; q < kMaxT; ++q) cnt[q] = 0u;

  // The records' constant columns: 1 at 2m, zeros past it.
  for (int e = tid; e < kSqMmaCols * LD; e += kSqMmaThreads) {
    const int c = e % LD;
    rec_big[e] = c == 2 * m ? 1.0f : 0.0f;
    rec_small[e] = 0.0f;
  }

  if (tiles > 0) {
    sq_mma_fetch(sources, scores, n_s, m, j_begin, raw, raw + S::kRaw);
  }
  cp_async_commit();
  for (int c = 0; c < tiles; ++c) {
    const int j0 = j_begin + c * kSqMmaCols;
    float* rx = raw + (c & 1) * 2 * S::kRaw;
    if (c + 1 < tiles) {
      float* nx = raw + ((c + 1) & 1) * 2 * S::kRaw;
      sq_mma_fetch(sources, scores, n_s, m, j0 + kSqMmaCols, nx,
                   nx + S::kRaw);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile c has landed; the records are free
    const float* rs = rx + S::kRaw;
    for (int e = tid; e < kSqMmaCols * m; e += kSqMmaThreads) {
      const int j = e / m;
      const int k = e - j * m;
      uint32_t hi, lo;
      tf32_split(rs[e], hi, lo);
      rec_big[j * LD + k] = __uint_as_float(hi);
      rec_small[j * LD + k] = __uint_as_float(lo);
      tf32_split(rx[e], hi, lo);
      rec_big[j * LD + m + k] = __uint_as_float(hi);
      rec_small[j * LD + m + k] = __uint_as_float(lo);
    }
    {  // the sources' squared norms, 4 threads a source
      const int j = tid >> 2;
      float q = 0.0f;
      for (int k = tid & 3; k < m; k += 4) {
        const float v = rx[j * m + k];
        q = fmaf(v, v, q);
      }
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      if ((tid & 3) == 0) norm_s[j] = q;
    }
    __syncthreads();  // the records are complete

#pragma unroll 1
    for (int n0 = 0; n0 < kSqMmaCols; n0 += 8) {
      // Gram tile: B(k, n) = x_s[n0 + n][k] at record column m + k; the
      // three products in three chains of KS steps, summed small first.
      float gbb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float gbs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float gsb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int bg = (n0 + g) * LD + m + t;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t bb0 = __float_as_uint(rec_big[bg + 8 * ks]);
        const uint32_t bb1 = __float_as_uint(rec_big[bg + 8 * ks + 4]);
        mma_tf32(gsb, a_small[ks], bb0, bb1);
        mma_tf32(gbs, a_big[ks], __float_as_uint(rec_small[bg + 8 * ks]),
                 __float_as_uint(rec_small[bg + 8 * ks + 4]));
        mma_tf32(gbb, a_big[ks], bb0, bb1);
      }
      float gr[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) gr[q] = gbb[q] + (gbs[q] + gsb[q]);
      const int jl = n0 + 2 * t;  // sources jl, jl + 1 of the fragment
      const float ns0 = norm_s[jl];
      const float ns1 = norm_s[jl + 1];
      const bool c0 = j0 + jl < n_s;
      const bool c1 = j0 + jl + 1 < n_s;
      const float sq[4] = {
          fmaxf(__fsub_rn(__fadd_rn(nt0, ns0), 2.0f * gr[0]), 0.0f),
          fmaxf(__fsub_rn(__fadd_rn(nt0, ns1), 2.0f * gr[1]), 0.0f),
          fmaxf(__fsub_rn(__fadd_rn(nt1, ns0), 2.0f * gr[2]), 0.0f),
          fmaxf(__fsub_rn(__fadd_rn(nt1, ns1), 2.0f * gr[3]), 0.0f)};
      const bool ok[4] = {ok0 && c0, ok0 && c1, ok1 && c0, ok1 && c1};
      float kv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        kv[q] = (q & 1 ? c1 : c0) ? ex2_ftz(ng2 * sq[q]) : 0.0f;
        count_pair_fixed<kT, true>(sq[q], th, ok[q], cnt);
      }
      // K as the product's A fragment: (g, t) <- source 2t, (g, t + 4) <-
      // source 2t + 1, rows g and g + 8.
      uint32_t k_big[4], k_small[4];
      tf32_split(kv[0], k_big[0], k_small[0]);
      tf32_split(kv[2], k_big[1], k_small[1]);
      tf32_split(kv[1], k_big[2], k_small[2]);
      tf32_split(kv[3], k_big[3], k_small[3]);
      const int bk = jl * LD + g;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        mma_3xtf32(acc[b], k_big, k_small, rec_big, rec_small, bk + 8 * b,
                   bk + LD + 8 * b);
      }
    }
  }
  cp_async_wait<0>();

  // The split's partial [KS | KX | rowsum] of the warp's rows.
  const int w = 2 * m + 1;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + (q >> 1) * 8;
      const int col = 8 * b + 2 * t + (q & 1);
      if (row < n_t && col < w) {
        part[static_cast<size_t>(row) * w + col] = acc[b][q];
      }
    }
  }
  flush_counts(cnt, T, counts);
}

}  // namespace svgd
