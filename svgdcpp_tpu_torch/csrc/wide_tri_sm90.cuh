// The upper-triangle sweep's float32 body past kMaxM (m > 64) for the
// single-RBF triangle kernels (fused_phi.cu: K2's and K4's ports) and the
// terms triangle kernels (fused_phi_terms.cu: K8/K9's and K10/K11's), the
// instance MM = kWideMM of each. It computes what wide_tri.cuh's
// wide_pair_body computes for them (the (2m, n) accumulator [KS | D], D
// unscaled for one RBF and weighted by w for terms, each self pair entered
// in both directions and pinned to sq = 0, the upper count U with the
// diagonal), with the Gram tile and both contractions in 3xTF32 on the
// tensor cores, and is laid out for Hopper's shared memory. wide_pair_body
// keeps serving the other wide users (K14's term groups, K15 and its bf16
// instance, the panels); K2's and K3's bf16 instances run
// bf16_tri_sm90.cuh's body, built on this one's loop structure.
//
// What bounds it. At (10000, 123) the parent body took 3.65 ms, of which
// the contraction's fragment loads took about 1.9 ms: 64 x 64 tile pairs
// whose 3xTF32 operands (big and small parts) were read from shared memory
// for every mma with two-way bank conflicts, so shared-memory bandwidth,
// not the tensor cores, set the pace; the norms, recomputed from device
// memory by every tile pair, took 0.19 ms, the synchronous staging about
// 0.7 ms, the flush's float32 atomics about 0.1 ms. The floor here is
// mma.sync's TF32 rate, well below wgmma's (chip_profile.py
// --wide-breakdown measures both this body's parts and that rate; PERF.md
// section 6). This body:
//
//   * Tiles of kWideSymTile = 128 particles a side: twice the work per
//     staged byte of 64 x 64 and half the atomics per pair of particles.
//   * Persistent blocks, one an SM (the launcher's grid is the SM count),
//     each walking its tile pairs t0 + blockIdx.x + k gridDim.x of the
//     upper triangle's row-major tile list, so that the next pair's first
//     slices load while this pair finishes.
//   * Warp specialisation: 8 consumer warps compute; a ninth, the
//     producer, issues every cp.async, kStages - 1 stages ahead, into a
//     ring of stages of two 128 x 32 slots: a pair is KG = ceil(m / 32)
//     Gram slices (slot 0 = X_I, slot 1 = X_J), then KG chunks of the
//     scores and KG of the coordinates (slot 0 = the J rows, dir 0's
//     records; slot 1 = the I rows, dir 1's). Nothing is staged
//     synchronously and no slot is single-buffered. The copies are 16
//     bytes: the rows must start on 16-byte boundaries (wide_rows_ok; the
//     wrappers pad them to a multiple of 4 floats past 64,
//     ops/sym_plan.wide_row_width), since 4-byte copies of odd m's rows,
//     one cp.async an element, cost the producer more than the padding.
//   * The raw float32 slots are split into TF32 pairs where a warp loads
//     its fragment, by truncation (split_tf32, two instructions, where
//     cvt.rna's rounding slowed the fragment loads; --wide-breakdown's
//     "rounded split"). Splitting once into stored pairs would double the
//     bytes each fragment load reads and the ring's footprint.
//   * Strides and swizzles that make every fragment load conflict-free: the
//     slots' rows are kSlotLd = 40 floats (8 mod 32) apart, the Gram slices
//     XOR-swizzled (column ^ 4 where bit 2 of the row is set), and the
//     weight tiles (128 x kWLd = 136) swizzled alike, so that both the rows
//     of W (dir 0) and its columns (dir 1, W^T) load without conflicts.
//   * Warp tiles of 32 x 64 for the Gram tile (4 row groups x 2 column
//     groups) and of 32 x 32 for each contraction chunk (warps 0-3 the rows
//     of I against W [S_J | X_J], warps 4-7 the columns of J against W^T
//     [S_I | X_I]), so that each fragment feeds two or four products; the
//     inner loops carry no guard where a slice or chunk is whole.
//   * The norms accumulate from the staged Gram slices (no device memory
//     read of their own); x_i and x_j of D's epilogue come from the staged
//     coordinate chunks; the flush stays float32 atomics from the registers
//     (about 0.1 ms in the parent; half as many here).
//
// Per pair: the Gram tile (64 accumulators a thread, dead after the
// weights), then sq = max(0, |x_i|^2 + |x_j|^2 - 2 G), the weights and the
// counts once a pair into the weight tiles (k_c, and for terms w in a
// second tile) and the row and column sums of D's weight (on the diagonal
// tile j >= i only, the self pair at sq = 0). Each contraction chunk adds,
// for dir 0, KS_i (or D_i = rowsum_i x_i - (W X_J)_i) and, for dir 1, KS_j
// (or D_j = colsum_j x_j - (W^T X_I)_j) into the accumulator with float32
// atomics.
//
// Shared memory (dynamic, WideSym): one RBF a 3-stage ring of 2 x 128 x 40
// floats a stage (122,880 B), its weight tile 128 x 136 floats (69,632 B),
// norms, partial sums and thresholds 1032 floats (4,128 B): 196,640 B;
// terms a 2-stage ring and two weight tiles: 225,312 B. One block of 288
// threads an SM; nine warps on four schedulers cap a thread at 168
// registers.

#pragma once

#include "micro_tile.cuh"
#include "square_mma.cuh"

namespace svgd {

constexpr int kWideSymWarps = 8;      // the consumer warps
constexpr int kWideSymConsumers = 32 * kWideSymWarps;
constexpr int kWideSymThreads = kWideSymConsumers + 32;  // + the producer
constexpr int kWideSymCols = 32;      // columns of a slice or chunk
constexpr int kSlotLd = 40;           // slot rows' stride (8 mod 32)
constexpr int kWLd = 136;             // W's stride (8 mod 32)

// The shared memory of the body with kTwo weights a pair (terms: k_c and
// w, a weight tile each) or one (OneRbf): a ring of kStages stages of two
// slots, the weight tiles, and the norms and partial sums. One RBF takes
// three stages (196,640 B); terms two (225,312 B), which leaves room for
// their second tile and keeps w out of the registers.
template <bool kTwo>
struct WideSym {
  static constexpr int kStages = kTwo ? 2 : 3;
  static constexpr int kSlot = kWideSymTile * kSlotLd;
  static constexpr int kStage = 2 * kSlot;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kW = kWideSymTile * kWLd;
  // norms [I | J], row sums of I [2 column groups], column sums of J
  // [4 row groups], the kMaxT thresholds
  static constexpr int kSums = 2 * kWideSymTile + 2 * kWideSymTile +
                               4 * kWideSymTile + kMaxT;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kRing + (kTwo ? 2 : 1) * kW + kSums);
};

// The swizzled column of element (row, col) of a Gram slice or of W: the
// columns' bit 2 flipped where the row's bit 2 is set.
__device__ __forceinline__ int swz(int row, int col) {
  return col ^ (row & 4);
}

// Whether the body takes these operands: rows of m floats that start on
// 16-byte boundaries (its cp.async copies are 16 bytes). The entries
// refuse others past kMaxM.
inline bool wide_rows_ok(int m, const float* coords, const float* scores) {
  return (m & 3) == 0 && ((reinterpret_cast<uintptr_t>(coords) |
                           reinterpret_cast<uintptr_t>(scores)) & 15u) == 0;
}

// The barrier of the consumer warps alone (the producer warp never waits
// on it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kWideSymConsumers) : "memory");
}

// x = big + small, big x's TF32 truncation (its low 13 bits cleared; exact
// in the mma), small the exact float32 remainder, which the mma reads
// truncated to TF32: the 3xTF32 pair to about 2^-21 of x in two
// instructions, in place of square_mma.cuh's rounded tf32_split.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// A fragment (m16n8k8, row) of rows r0 + g (+8), columns k0 + t (+4) of a
// float32 tile whose element (r, k) is at at(r, k), split into TF32 big and
// small parts.
template <class At>
__device__ __forceinline__ void a_fragment(const float* base, const At& at,
                                           int r0, int k0, int g, int t,
                                           uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
  split_tf32(base[at(r0 + g, k0 + t)], big[0], small[0]);
  split_tf32(base[at(r0 + g + 8, k0 + t)], big[1], small[1]);
  split_tf32(base[at(r0 + g, k0 + t + 4)], big[2], small[2]);
  split_tf32(base[at(r0 + g + 8, k0 + t + 4)], big[3], small[3]);
}

// d += a b in 3xTF32, the small products first.
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4], uint32_t bb0,
                                       uint32_t bs0, uint32_t bb1,
                                       uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// The body: tile pairs [t0, t0 + count) of the upper triangle of nb tiles
// of kWideSymTile, block b taking t0 + b, t0 + b + gridDim.x, ...; kT
// thresholds (3, or kMaxT for a runtime T); weights(sq, k_c, w) the pair's
// weights (one weight where W is OneRbf, k_c = w). Composed kernels'
// constants in shared memory (AnyTerms) must be stored before the call:
// the body's first barrier comes before its first pair. Warps 0-7 compute;
// warp 8, the producer, issues every stage's copies.
template <int kT, class Wt>
__device__ __forceinline__ void wide_tri_sm90_body(
    const float* __restrict__ coords, const float* __restrict__ scores,
    const Wt& weights, const float* __restrict__ thr, int n, int m, int T,
    int nb, long long t0, long long count, float* __restrict__ acc,
    unsigned long long* __restrict__ counts) {
  constexpr bool kTwo = kTwoBands<Wt>;
  using L = WideSym<kTwo>;
  constexpr int kStages = L::kStages;
  constexpr int S = kWideSymTile;
  constexpr int C = kWideSymCols;
  extern __shared__ __align__(16) float sh[];
  float* ring = sh;
  float* wt = ring + L::kRing;          // k_c (one RBF: k)
  float* wd = wt + (kTwo ? L::kW : 0);  // D's weight w (one RBF: k)
  float* norm = wd + L::kW;             // [I | J]
  float* rowpart = norm + 2 * S;        // [column group][row of I]
  float* colpart = rowpart + 2 * S;     // [row group][column of J]
  float* thr_sh = colpart + 4 * S;      // the thresholds (kT = kMaxT)

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int kg = (m + C - 1) / C;  // Gram slices = chunks of a band
  const int ns = 3 * kg;           // stages a pair
  const long long first = blockIdx.x;
  const long long pairs =
      count > first ? (count - first + gridDim.x - 1) / gridDim.x : 0;
  const long long total = pairs * ns;

  auto spot = [&](long long k, int* bi, int* bj) {
    decode_upper_pair(t0 + first + k * gridDim.x, nb, bi, bj);
  };

  if (warp == kWideSymWarps) {
    // The producer: stage q of the block's stream into ring slot
    // q % kStages, kStages - 1 stages ahead of the consumers.
    auto issue = [&](long long q) {
      const long long k = q / ns;
      const int s = static_cast<int>(q - k * ns);
      int bi, bj;
      spot(k, &bi, &bj);
      const bool gram = s < kg;
      const int c0 = (gram ? s : (s - kg) % kg) * C;
      const float* src = gram || s >= 2 * kg ? coords : scores;
      // Slot 0: X_I (Gram) or the J rows (chunks); slot 1: X_J or the I
      // rows.
      const int rows[2] = {(gram ? bi : bj) * S, (gram ? bj : bi) * S};
      float* stage = ring + static_cast<int>(q % kStages) * L::kStage;
      // 16 bytes a copy: lane -> 4 columns of every fourth row.
      const int k4 = 4 * (lane & 7);
      const int left = min(max(m - c0 - k4, 0), 4);
#pragma unroll
      for (int slot = 0; slot < 2; ++slot) {
        float* dst = stage + slot * L::kSlot;
#pragma unroll 4
        for (int r = lane >> 3; r < S; r += 4) {
          const int part = rows[slot] + r;
          const int valid = part < n ? left : 0;
          cp_async16(dst + r * kSlotLd + (gram ? swz(r, k4) : k4),
                     valid > 0
                         ? src + static_cast<size_t>(part) * m + c0 + k4
                         : src,
                     4 * valid);
        }
      }
    };
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) {
      if (q < total) issue(q);
      cp_async_commit();
    }
#pragma unroll 1
    for (long long q = 0; q < total; ++q) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage q landed; stage q - 1's slot is free
      if (q + kStages - 1 < total) issue(q + kStages - 1);
      cp_async_commit();
    }
    cp_async_wait<0>();
    return;
  }

  // The thresholds: 3 in registers; a runtime T's kMaxT in shared memory,
  // read at each compare, which keeps the instance of two terms within the
  // 168 registers of nine warps (visible after the first stage's barrier).
  constexpr bool kThrShared = kT == kMaxT;
  float th_reg[kThrShared || kT == 0 ? 1 : kT];
#pragma unroll
  for (int q = 0; q < (kThrShared ? 0 : kT); ++q) {
    th_reg[q] = thr[q < T ? q : 0];
  }
  if (kThrShared && tid < kMaxT) thr_sh[tid] = thr[tid < T ? tid : 0];
  const float* th = kThrShared ? thr_sh : th_reg;
  unsigned int cnt[kMaxT];
#pragma unroll
  for (int q = 0; q < kMaxT; ++q) cnt[q] = 0u;

  const auto slot_at = [](int r, int k) { return r * kSlotLd + swz(r, k); };
  const auto rec_at = [](int r, int k) { return r * kSlotLd + k; };
  const auto w_at = [](int r, int k) { return r * kWLd + swz(r, k); };
  const auto wt_at = [](int r, int k) { return k * kWLd + swz(k, r); };

  // The Gram warp tile: rows 32 gr .. + 31 of I, columns 64 gc .. + 63 of J.
  const int gr = warp & 3;
  const int gc = warp >> 2;
  // The contraction warp tile: direction dir, output rows 32 cr .. + 31.
  const int dir = warp >> 2;
  const int cr = warp & 3;

  float out[2][4][4];  // a contraction chunk

  // One k-step of the Gram tile acc_g on the slice pair (slot0 = X_I,
  // slot1 = X_J).
  auto gram_step = [&](float (&acc_g)[2][8][4], const float* slot0,
                       const float* slot1, int ks) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a_fragment(slot0, slot_at, 32 * gr + 16 * h, 8 * ks, g, t, ab[h],
                 as[h]);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int r = 64 * gc + 8 * c + g;
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(slot1[slot_at(r, 8 * ks + t)], bb0, bs0);
      split_tf32(slot1[slot_at(r, 8 * ks + t + 4)], bb1, bs1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_3x(acc_g[h][c], ab[h], as[h], bb0, bs0, bb1, bs1);
      }
    }
  };

  // A contraction chunk of cn columns (kFull: cn = C) in direction kDir
  // with the weight tile w: dir 0 the rows of I, A = W, B = the J rows
  // (slot 0); dir 1 the columns of J, A = W^T, B = the I rows (slot 1).
  auto contract = [&](auto dir_c, auto full_c, const float* w,
                      const float* rec, int cn) {
    constexpr int kDir = decltype(dir_c)::value;
    constexpr bool kFull = decltype(full_c)::value;
#pragma unroll 2
    for (int ks = 0; ks < S / 8; ++ks) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (kDir == 0) {
          a_fragment(w, w_at, 32 * cr + 16 * h, 8 * ks, g, t, ab[h], as[h]);
        } else {
          a_fragment(w, wt_at, 32 * cr + 16 * h, 8 * ks, g, t, ab[h], as[h]);
        }
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (kFull || 8 * b < cn) {
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(rec[rec_at(8 * ks + t, 8 * b + g)], bb0, bs0);
          split_tf32(rec[rec_at(8 * ks + t + 4, 8 * b + g)], bb1, bs1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma_3x(out[h][b], ab[h], as[h], bb0, bs0, bb1, bs1);
          }
        }
      }
    }
  };

  // The next stage of the block's stream, after the barrier that shows it
  // landed (and that every warp is done with the stage before).
  int ring_at = 0;
  auto next_stage = [&]() {
    __syncthreads();
    const float* stage = ring + ring_at * L::kStage;
    ring_at = ring_at + 1 == kStages ? 0 : ring_at + 1;
    return stage;
  };

#pragma unroll 1
  for (long long k = 0; k < pairs; ++k) {
    int bi, bj;
    spot(k, &bi, &bj);
    const int i0 = bi * S;
    const int j0 = bj * S;
    const bool diag = bi == bj;
    {
      float acc_g[2][8][4];  // the Gram tile, live until the weights
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc_g[h][c][e] = 0.0f;
        }
      }
      float nacc = 0.0f;  // this thread's norm: row tid of I, or of J
#pragma unroll 1
      for (int s = 0; s < kg; ++s) {
        const float* slot0 = next_stage();
        const float* slot1 = slot0 + L::kSlot;
        // 1. The Gram tile's slice s, and this thread's norm over it (the
        // row's 32 columns in a lane-rotated order: conflict-free).
        {
          const float* row = (tid < S ? slot0 : slot1) + (tid & (S - 1)) *
                                                             kSlotLd;
#pragma unroll 8
          for (int u = 0; u < C; ++u) {
            const float v = row[(u + lane) & (C - 1)];
            nacc = fmaf(v, v, nacc);
          }
        }
        const int kn = min(C, m - s * C);
        if (kn == C) {
#pragma unroll
          for (int ks = 0; ks < C / 8; ++ks) {
            gram_step(acc_g, slot0, slot1, ks);
          }
        } else {
#pragma unroll 1
          for (int ks = 0; 8 * ks < kn; ++ks) {
            gram_step(acc_g, slot0, slot1, ks);
          }
        }
      }
      // 2. sq, the weights and the counts, once a pair.
      norm[tid] = nacc;
      consumers_sync();  // the norms of I and J
      // Column by column of this warp's 64: the column sums over its 32
      // rows reduce over g at once; the row sums over its 64 columns
      // accumulate and reduce over t at the end.
      float rs[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float cs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = 32 * gr + 16 * h + g + 8 * (e >> 1);
            const int jl = 64 * gc + 8 * c + 2 * t + (e & 1);
            const bool ok =
                i0 + il < n && j0 + jl < n && (!diag || jl >= il);
            float sq = __fsub_rn(__fadd_rn(norm[il], norm[S + jl]),
                                 2.0f * acc_g[h][c][e]);
            sq = fmaxf(sq, 0.0f);
            if (diag && il == jl) sq = 0.0f;
            float a, b;
            weights(sq, a, b);
            count_pair_fixed<kT, true>(sq, th, ok, cnt);
            const float dw = ok ? b : 0.0f;
            wt[w_at(il, jl)] = ok ? a : 0.0f;
            if constexpr (kTwo) wd[w_at(il, jl)] = dw;
            rs[h][e >> 1] += dw;
            cs[e & 1] += dw;
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = cs[e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) colpart[gr * S + 64 * gc + 8 * c + 2 * t + e] = v;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v = rs[h][r];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0) rowpart[gc * S + 32 * gr + 16 * h + 8 * r + g] = v;
        }
      }
    }
#pragma unroll 1
    for (int s = kg; s < ns; ++s) {
      const float* slot0 = next_stage();
      const float* slot1 = slot0 + L::kSlot;
      // 3. A contraction chunk: the scores' columns (k_c) or the
      // coordinates' (D's weight w).
      const bool xband = s >= 2 * kg;
      const float* w = xband ? wd : wt;
      const int c0 = (xband ? s - 2 * kg : s - kg) * C;
      const int cn = min(C, m - c0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
#pragma unroll
          for (int e = 0; e < 4; ++e) out[h][b][e] = 0.0f;
        }
      }
      using Dir0 = std::integral_constant<int, 0>;
      using Dir1 = std::integral_constant<int, 1>;
      using Full = std::true_type;
      using Part = std::false_type;
      if (dir == 0) {
        if (cn == C) {
          contract(Dir0{}, Full{}, w, slot0, cn);
        } else {
          contract(Dir0{}, Part{}, w, slot0, cn);
        }
      } else if (cn == C) {
        contract(Dir1{}, Full{}, w, slot1, cn);
      } else {
        contract(Dir1{}, Part{}, w, slot1, cn);
      }
      // Flush: output row o (particle o0 + ol), column c0 + cl: KS, or
      // D = sum x - (W X) with x the output particle's own coordinate from
      // the other slot (dir 0: the I rows in slot 1; dir 1: the J rows in
      // slot 0).
      const int o0 = dir == 0 ? i0 : j0;
      const float* own = dir == 0 ? slot1 : slot0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int ol = 32 * cr + 16 * h + 8 * r + g;
          const int o = o0 + ol;
          float sum = 0.0f;
          if (xband) {
            sum = dir == 0
                      ? rowpart[ol] + rowpart[S + ol]
                      : (colpart[ol] + colpart[S + ol]) +
                            (colpart[2 * S + ol] + colpart[3 * S + ol]);
          }
#pragma unroll
          for (int b = 0; b < 4; ++b) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cl = 8 * b + 2 * t + e;
              if (o < n && cl < cn) {
                float v = out[h][b][2 * r + e];
                if (xband) v = fmaf(sum, own[rec_at(ol, cl)], -v);
                const int col = (xband ? m : 0) + c0 + cl;
                atomicAdd(acc + static_cast<size_t>(col) * n + o, v);
              }
            }
          }
        }
      }
    }
  }
  flush_counts(cnt, T, counts);
}

// Allow a kernel on this body its dynamic shared memory (past the default
// 48 KB) and give its grid: one persistent block an SM, no more blocks
// than tile pairs. A refusal also fails the launch, which the entry's
// cudaGetLastError() reports.
template <bool kTwo, class Kernel>
inline unsigned int wide_sym_prepare(Kernel* kernel, long long count) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(WideSym<kTwo>::kSmemBytes));
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return static_cast<unsigned int>(count < sms ? count : sms);
}

// The threads of a triangle kernel's block for instance MM: this body's at
// MM = kWideMM, any m past kMaxM, else the micro-tile body's.
template <int MM>
struct TriThreads {
  static constexpr int value =
      MM == kWideMM ? kWideSymThreads : MicroTri<MM>::kThreads;
};

}  // namespace svgd
