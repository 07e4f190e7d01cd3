// The bfloat16 opt-in's upper-triangle body (the JAX package's
// dot_dtype='bfloat16'), at every m >= 1, for K2's bf16 instance
// (fused_phi.cu, fused_phi_counts_sym_bf16: the whole triangle), K3's
// (fused_phi_panel.cu, fused_phi_counts_sympanel_bf16: the tile pairs of
// every panel in the panel list's order) and K15's (phi_rbf.cu,
// phi_rbf_wide_bf16: the whole triangle in the fixed-P Gram form, kAsym
// below), on Hopper's bf16 tensor cores.
//
// It computes what the JAX kernels compute under bf16 (_sym_kernel through
// _phi_rbf_fused_pallas_sym_impl, pallas_phi.py:546 and :609-640, and
// _sym_panel_kernel through :927), and what their plain version
// ops/phi._pair_block(bf16=True) computes: the Gram tile of the
// bf16-rounded centred coordinates with float32 accumulation; the norms q
// of the unrounded float32 coordinates; sq = max(0, q_i + q_j - 2 G), the
// self pair pinned to 0; the counts (the upper count U, the diagonal
// included) from that sq; k = exp2(-gamma log2(e) sq) rounded to bf16 to
// nearest even; K contracted with the bf16 record [S | X | 1] in float32,
// both directions, into the accumulator [KS | KX | rowsum] (2m + 1 rows).
// The wrapper's epilogue forms D = rowsum x - KX with the float32 x, as the
// JAX epilogue does (pallas_phi.py:636-640), and takes each self pair's
// second entry out of KS.
//
// What bounds it. The function's per-pair work is the Gram dot (m MACs),
// sq, one ex2, the bf16 rounding, T compares and the two contractions
// (2(2m + 1) MACs): at small m the FP32 pipes and the special function
// unit (the sq, weight and count instructions, about 12 a pair), at large
// m the tensor cores. The parent body, which ran these instances before
// (chip_profile.py keeps its text as their parent), was sized
// for float32 past m = 64: 64 x 64 tile pairs a
// block, synchronous staging, Gram slices of 32 coordinates and records of
// 64 columns whatever m (at m = 2, 30 of 32 and 59 of 64 zero), each
// product one TF32 m16n8k8 pass on bf16 values in float32 slots, W^T read
// transposed from shared memory. This body:
//
//   * bf16 mma.sync m16n8k16, one pass: bf16 operands are exact, so there
//     is no split.
//   * The Gram depth and the record width follow m: ceil(m / 16) k-steps
//     and ceil((2m + 1) / 8) n8 tiles, staged in slots whose rows are the
//     next power of two of 16-byte segments up to 8 (64 bf16): at m = 2
//     one k-step over 16 coordinates and one n-tile of 8 columns.
//   * The operands are rounded once, by the pack kernel (bf16_tri_pack),
//     into the entry's workspace: q (float32), the Gram operand X (n rows
//     of bf16_gram_width(m), zero past m), the record R (n rows of
//     bf16_record_width(m): [S | X | 1 | 0...]) and, for K15, its second
//     Gram operand Y (as X), every row a multiple of 16 bytes; one launch
//     more a call, half the float32 bytes staged after.
//   * Weights from registers: warp w owns rows 16w .. 16w + 15 of I against
//     all 128 columns of J, so its Gram accumulators, rounded and packed to
//     bf16x2, are the A fragments of K over J: the rows of I take
//     K [S_J | X_J | 1] straight from registers. The columns of J need K^T,
//     whose fragments are not in any thread's registers: each thread also
//     stores its packed pairs into a bf16 weight tile W (swizzled,
//     conflict-free 32-bit stores), which the columns' warps read with
//     ldmatrix.trans.
//   * wide_tri_sm90.cuh's loop structure: tiles of kBf16Tile = 128 a side,
//     one persistent block an SM, here walking a contiguous range of the
//     work list with a cursor; producer warps issuing every cp.async (16
//     bytes) kBf16Stages - 1 stages ahead into a ring of stages of two
//     slots (I and J: a Gram slice, or a chunk of the records) with the
//     norms beside the last Gram slice; every fragment loaded by ldmatrix
//     from slots whose 16-byte segments are XOR-swizzled, so that the 8
//     rows of each 8 x 8 matrix fall in distinct banks. One producer warp
//     could not keep up (chip_profile.py --bf16: staging alone took 0.047
//     of the sweep's 0.110 ms at (10000, 2) and 0.473 of 0.756 at (10000,
//     123)); four issue a quarter of the copies each, at no cost in
//     registers: twelve warps on four schedulers keep nine's cap of 168.
//
// Per work item: the Gram tile (64 accumulators a thread), then sq, the
// counts and k once a pair into 32 registers of A fragments and the tile W,
// then for each record chunk the rows of I (A from registers, B = R_J by
// ldmatrix.trans) and the columns of J (A = W^T by ldmatrix.trans, B =
// R_I), each flushed with float32 atomics
// into the accumulator [KS | KX | rowsum] (the spot's out0 and out1,
// sweep_common.cuh's WideSpot). Rows past n are staged as zeros, so they
// add nothing to the other side, and a guarded item's weights past n are 0;
// a diagonal item keeps j >= i. Shared memory:
// 5 stages of 2 x 16 KB + 1 KB, and W 32 KB: 201,728 B, one block of 384
// threads (8 consumer warps, 4 producer warps) an SM.
//
// kAsym, K15's fixed-P form (the JAX kernel's _phi_kernel,
// pallas_phi.py:116-130, under bf16): the Gram operands are X and
// Y = X_c (P_sym/2), both rounded, the norms the wrapper's float32
// q_i = x_i . y_i (which the pack copies into the workspace's q), sq =
// q_i + q_j - 2 G clamped at 0 only where P is taken as positive
// semidefinite (qmin 0, else -inf), k = exp2(-log2(e) sq), no counts. The
// rounded Gram is not symmetric in the pair (bf16(x_i) . bf16(y_j) against
// bf16(x_j) . bf16(y_i)), so an item takes two Gram tiles in sequence into
// the same accumulators: first G2 = Y_I X_J^T, whose weights k(j <- i) go
// to W alone for the columns of J, then G1 = X_I Y_J^T, whose weights
// k(i <- j) go to the A fragments alone for the rows of I; 2 kg Gram
// stages an item, the norms beside the last of each pass. Nor is the self
// pair pinned: its form is left as the rounded Gram gives it, as the JAX
// kernel's square sweep forms it, and it enters once in all, from the rows'
// pass (the columns' pass keeps j > i on a diagonal item). The wrapper
// subtracts nothing.

#pragma once

#include <cuda_bf16.h>

#include "square_mma.cuh"

namespace svgd {

constexpr int kBf16Tile = 128;                      // particles a side
constexpr int kBf16Warps = 8;                       // consumer warps
constexpr int kBf16Consumers = 32 * kBf16Warps;
constexpr int kBf16Producers = 128;                 // 4 producer warps
constexpr int kBf16Threads = kBf16Consumers + kBf16Producers;
constexpr int kBf16SlotCols = 64;                   // bf16 of a slot row
constexpr int kBf16Stages = 5;
constexpr int kBf16PackRows = 8;                    // pack: a warp a row

struct Bf16Tri {
  static constexpr int kSlotBytes = kBf16Tile * kBf16SlotCols * 2;
  static constexpr int kNormBytes = 2 * kBf16Tile * 4;  // q of I and J
  static constexpr int kStageBytes = 2 * kSlotBytes + kNormBytes;
  static constexpr int kWBytes = kBf16Tile * kBf16Tile * 2;
  static constexpr size_t kSmemBytes =
      static_cast<size_t>(kBf16Stages) * kStageBytes + kWBytes;
};

// The widths of the packed operands (sym_plan.bf16_gram_width,
// bf16_record_width): the Gram operand's m padded to a k16 step, the
// record's 2m + 1 to an n8 tile.
__host__ __device__ constexpr int bf16_gram_width(int m) {
  return 16 * ((m + 15) / 16);
}
__host__ __device__ constexpr int bf16_record_width(int m) {
  return 8 * ((2 * m + 8) / 8);
}

// log2 of the 16-byte segments of a slot row holding global rows of
// `width` bf16: the next power of two of width / 8, at most 8 (64 bf16).
__host__ __device__ inline int bf16_slot_lg(int width) {
  const int segs = width / 8;
  int lg = 0;
  while (lg < 3 && (1 << lg) < segs) ++lg;
  return lg;
}

// The workspace's layout (sym_plan.bf16_work_bytes): q (n floats, to a
// 16-byte boundary), then X (n x gram width) and R (n x record width),
// then, for K15 alone, Y (n x gram width; null otherwise).
struct Bf16Operands {
  float* q;
  __nv_bfloat16* xg;
  __nv_bfloat16* rec;
  __nv_bfloat16* yg;
};

inline size_t bf16_work_q_bytes(int n) {
  return (static_cast<size_t>(n) * 4 + 15) / 16 * 16;
}

inline Bf16Operands bf16_operands(void* work, int n, int m, bool with_y) {
  auto* base = static_cast<unsigned char*>(work);
  auto* xg = reinterpret_cast<__nv_bfloat16*>(base + bf16_work_q_bytes(n));
  auto* rec = xg + static_cast<size_t>(n) * bf16_gram_width(m);
  return Bf16Operands{
      static_cast<float*>(work), xg, rec,
      with_y ? rec + static_cast<size_t>(n) * bf16_record_width(m) : nullptr};
}

// The segment (r, seg) of a slot row of 2^lg segments, XOR-swizzled so
// that 8 consecutive rows at one logical segment fall in 8 distinct 16-byte
// bank groups: the low lg bits of r >> (3 - lg).
__device__ __forceinline__ int bf16_slot_seg(int r, int seg, int lg) {
  return (r << lg) + (seg ^ ((r >> (3 - lg)) & ((1 << lg) - 1)));
}

__device__ __forceinline__ void cp_async16_shared(uint32_t dst,
                                                  const void* src,
                                                  int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b, bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16 (to nearest, ties to even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// A work list's cursor: the item's tile pair (bi, bj) for K2's; the panel's
// super-blocks (bi, bj) and the tile pair (a, b) within it for K3's.
// A block decodes its first item once (start) and steps from item to item
// (advance), so that neither the producer nor the consumers decode an item
// from its index on the way.
using Bf16Cursor = PanelTilePair;

// K2's work list: tile pair u of the upper triangle of nb tiles in
// row-major order, both directions into the (2m + 1, n) accumulator.
struct Bf16TriWork {
  int nb;
  int n;
  float* acc;

  __device__ __forceinline__ Bf16Cursor start(long long u) const {
    Bf16Cursor c{0, 0, 0, 0};
    decode_upper_pair(u, nb, &c.bi, &c.bj);
    return c;
  }
  __device__ __forceinline__ void advance(Bf16Cursor& c) const {
    if (++c.bj == nb) c.bj = ++c.bi;
  }
  __device__ __forceinline__ bool spot(const Bf16Cursor& c,
                                       WideSpot& s) const {
    s = WideSpot{c.bi * kBf16Tile, c.bj * kBf16Tile, c.bi == c.bj, acc, acc,
                 0, 0, n};
    return s.i0 < n && s.j0 < n;
  }
};

// K3's work list: the tile pairs of every panel, panel by panel in the
// order of sym_plan.panel_pairs (decode_panel_item, sweep_common.cuh, which
// the float32 panels past kMaxM share; sym_plan.bf16_panel_item mirrors it),
// both directions into the (2m + 1, n) accumulator, as K2's: the panels'
// windows, which the TPU's VMEM budget called for, would only be
// scattered onto it (at (10000, 123) 91 MB of windows, past the card's
// 50 MB L2, made the flush twice K2's). An item with a tile wholly past n
// has no spot: it adds nothing.
struct Bf16PanelWork {
  int nb, tw, w, n;
  float* acc;

  __device__ __forceinline__ Bf16Cursor start(long long u) const {
    return decode_panel_item(u, nb, tw);
  }
  __device__ __forceinline__ void advance(Bf16Cursor& c) const {
    if (c.bi != c.bj) {  // tw x tw, row-major
      if (++c.b < tw) return;
      c.b = 0;
      if (++c.a < tw) return;
      c.a = 0;
      if (++c.bj == nb) {  // the next row of super-blocks, or the diagonal
        c.bj = ++c.bi + 1;
        if (c.bj >= nb) c.bi = c.bj = 0;
      }
    } else {  // a <= b
      if (++c.b < tw) return;
      if (++c.a < tw) {
        c.b = c.a;
        return;
      }
      c.a = c.b = 0;
      c.bj = ++c.bi;
    }
  }
  __device__ __forceinline__ bool spot(const Bf16Cursor& c,
                                       WideSpot& s) const {
    const int i0 = c.bi * w + c.a * kBf16Tile;
    const int j0 = c.bj * w + c.b * kBf16Tile;
    s = WideSpot{i0, j0, c.bi == c.bj && c.a == c.b, acc, acc, 0, 0, n};
    return i0 < n && j0 < n;
  }
};

// The body over work items [0, items), block b taking the contiguous range
// [b items / grid, (b + 1) items / grid) (sym_plan.bf16_walk), so that the
// blocks in flight work in distinct parts of the list; the pack's operands
// ops; kT thresholds (3, or kMaxT for a runtime T, or 0 with T = 0 and
// counts null for none); ng2 = -gamma log2(e); kAsym K15's form (see the
// top of the file: ops.yg set, qmin the clamp's floor). Warps 0-7 compute;
// warps 8-11, the producers, issue every stage's copies.
template <int kT, bool kAsym = false, class Work>
__device__ __forceinline__ void bf16_tri_body(
    const Bf16Operands& ops, float ng2, const float* __restrict__ thr, int n,
    int m, int T, long long items, const Work& work,
    unsigned long long* __restrict__ counts, float qmin = 0.0f) {
  const float* __restrict__ q = ops.q;
  const __nv_bfloat16* __restrict__ xg = ops.xg;
  const __nv_bfloat16* __restrict__ rec = ops.rec;
  constexpr int S = kBf16Tile;
  using L = Bf16Tri;
  extern __shared__ __align__(128) unsigned char bf16_sh[];
  const uint32_t ring =
      static_cast<uint32_t>(__cvta_generic_to_shared(bf16_sh));
  const uint32_t wsh = ring + kBf16Stages * L::kStageBytes;
  unsigned char* wgen = bf16_sh + kBf16Stages * L::kStageBytes;

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int mk = bf16_gram_width(m);
  const int rw = bf16_record_width(m);
  const int sl_lg = bf16_slot_lg(mk);  // a Gram slice's segments
  const int cw_lg = bf16_slot_lg(rw);  // a record chunk's segments
  const int sl = 8 << sl_lg;
  const int cw = 8 << cw_lg;
  const int kg = (mk + sl - 1) / sl;   // Gram slices of a pass
  const int ng = kAsym ? 2 * kg : kg;  // Gram stages an item
  const int nc = (rw + cw - 1) / cw;   // record chunks
  const int ns = ng + nc;              // stages an item
  const long long lo = items * blockIdx.x / gridDim.x;
  const long long mine = items * (blockIdx.x + 1) / gridDim.x - lo;
  const long long total = mine * ns;

  if (warp >= kBf16Warps) {
    // The producers: stage st of the block's stream into ring slot
    // st % kBf16Stages, kBf16Stages - 1 stages ahead of the consumers. A
    // slot of 128 rows of 2^lg segments is 128 << lg copies of 16 bytes:
    // producer thread pt takes segment pt % 2^lg of rows pt >> lg, + 128 >>
    // lg, ..., so its segment and its row's swizzle stay the same (the
    // swizzle depends on a row's place within 16) and each copy steps by a
    // fixed stride.
    const int pt = tid - kBf16Consumers;
    Bf16Cursor pc = work.start(lo);
    WideSpot sp;
    bool live = work.spot(pc, sp);
    int ps = 0;  // the stage of pc's item to issue next
    // The rows of I of `base_i` into dst_i and of J of `base_j` into
    // dst_j: slot rows of 2^lg segments, global rows of `width` bf16 from
    // column c0.
    auto copy = [&](uint32_t dst_i, uint32_t dst_j, int lg, int width,
                    int c0, const __nv_bfloat16* base_i,
                    const __nv_bfloat16* base_j) {
      const int seg = pt & ((1 << lg) - 1);
      if (c0 + 8 * seg >= width) return;
      const int r0 = pt >> lg;
      const int step = kBf16Producers >> lg;  // rows between copies
      const uint32_t off = 16 * bf16_slot_seg(r0, seg, lg);
#pragma unroll
      for (int slot = 0; slot < 2; ++slot) {
        const int row = slot ? sp.j0 : sp.i0;
        const uint32_t dst = (slot ? dst_j : dst_i) + off;
        const __nv_bfloat16* from = (slot ? base_j : base_i) + c0 + 8 * seg +
                                    static_cast<size_t>(row + r0) * width;
        const int left = n - row - r0;  // rows to n
#pragma unroll 2
        for (int i = 0; i < (1 << lg); ++i) {
          const bool in = i * step < left;
          cp_async16_shared(
              dst + 16u * kBf16Producers * i,
              in ? static_cast<const void*>(
                       from + static_cast<size_t>(i) * step * width)
                 : static_cast<const void*>(xg),
              in ? 16 : 0);
        }
      }
    };
    auto issue = [&](long long st) {
      if (live) {
        const uint32_t stage =
            ring + static_cast<uint32_t>(st % kBf16Stages) * L::kStageBytes;
        // K15's first pass stages Y_I and X_J, its second X_I and Y_J;
        // the others' one pass X_I and X_J.
        const bool second = kAsym && ps >= kg;
        const int sg = second ? ps - kg : ps;  // the pass's slice
        if (ps < ng) {
          copy(stage, stage + L::kSlotBytes, sl_lg, mk, sg * sl,
               kAsym && !second ? ops.yg : xg, second ? ops.yg : xg);
        } else {
          copy(stage, stage + L::kSlotBytes, cw_lg, rw, (ps - ng) * cw, rec,
               rec);
        }
        if (ps < ng && sg == kg - 1 && pt < 2 * S / 4) {  // q of I and J
          const int part = ((pt >> 5) ? sp.j0 : sp.i0) + 4 * (pt & 31);
          const int v = min(max(n - part, 0), 4);
          cp_async16_shared(stage + 2 * L::kSlotBytes + 16 * pt,
                            v > 0 ? q + part : q, 4 * v);
        }
      }
      if (++ps == ns) {
        ps = 0;
        work.advance(pc);
        live = work.spot(pc, sp);
      }
    };
#pragma unroll
    for (int st = 0; st < kBf16Stages - 1; ++st) {
      if (st < total) issue(st);
      cp_async_commit();
    }
#pragma unroll 1
    for (long long st = 0; st < total; ++st) {
      cp_async_wait<kBf16Stages - 2>();
      __syncthreads();  // stage st landed; stage st - 1's slot is free
      if (st + kBf16Stages - 1 < total) issue(st + kBf16Stages - 1);
      cp_async_commit();
    }
    cp_async_wait<0>();
    return;
  }

  float th[kT > 0 ? kT : 1];
#pragma unroll
  for (int k = 0; k < kT; ++k) th[k] = thr[k < T ? k : 0];
  uint32_t kf[8][4];  // K's rows 16 warp .. + 15: A fragments over J
  unsigned int cnt[kMaxT];
#pragma unroll
  for (int k = 0; k < kMaxT; ++k) cnt[k] = 0u;

  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = 16 * warp + g;
  // The weight tile W: 128 x 128 bf16, row r's 16-byte segment s at
  // segment (r << 4) + (s ^ (r & 7)).
  // The lane's row of the 8 x 8 matrix it points an x4 load at: within 16
  // rows, matrices 1 and 3 (ra) or 2 and 3 (rb) in the second 8. A row's
  // swizzle depends on its place within 16 rows only, so each fragment's
  // address is a per-lane constant plus a multiple of 16 rows.
  const int ra = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int rb = (lane & 7) + 8 * (lane >> 4);
  auto swz = [](int r, int lg) { return (r >> (3 - lg)) & ((1 << lg) - 1); };
  // Gram: A = rows of I (16 warp + ra, segment 2 ks + (lane >> 4)), B = the
  // 16 rows of J of each n8 pair (rb, segment 2 ks + matrix bit 0).
  const int sw_ga = swz(ra, sl_lg);
  const int sw_gb = swz(rb, sl_lg);
  const uint32_t ga_row = 16u * static_cast<uint32_t>((16 * warp + ra)
                                                      << sl_lg);
  const uint32_t gb_row = 16u * static_cast<uint32_t>(rb << sl_lg);
  const uint32_t g16 = 256u << sl_lg;  // 16 rows of a Gram slot
  // Records (ldmatrix.trans B): rows ra of each k-step's 16, n8 pair pr's
  // segment 2 pr + (lane >> 4), the last segment where the chunk has fewer.
  const int sw_r = swz(ra, cw_lg);
  uint32_t r_off[4];
#pragma unroll
  for (int pr = 0; pr < 4; ++pr) {
    const int seg = min(2 * pr + (lane >> 4), (1 << cw_lg) - 1);
    r_off[pr] = 16u * static_cast<uint32_t>((ra << cw_lg) + (seg ^ sw_r));
  }
  const uint32_t r16 = 256u << cw_lg;  // 16 rows of a record slot
  // W^T (ldmatrix.trans A of the columns' direction): rows rb of each
  // k-step's 16 rows of I, the segment of columns 16 warp + 8 (matrix bit 0).
  const uint32_t wt_off =
      wsh + 16u * static_cast<uint32_t>((rb << 4) +
                                        ((2 * warp + ((lane >> 3) & 1)) ^
                                         (lane & 7)));

  // The next stage of the block's stream (its byte offset in the ring),
  // after the barrier that shows it landed and that every warp is done
  // with the stage before.
  int ring_at = 0;
  auto next_stage = [&]() {
    __syncthreads();
    const int off = ring_at * L::kStageBytes;
    ring_at = ring_at + 1 == kBf16Stages ? 0 : ring_at + 1;
    return off;
  };

  // out += A B over the slot's 128 particles (8 k-steps), B the records
  // at rslot, kNp n8 pairs of the chunk (the tiles past its 2m + 1 columns
  // are computed and never flushed); A the kf registers (dir 0) or W^T
  // loaded a k-step at a time (dir 1). The pair count is a compile-time
  // constant, so that no load waits behind a branch. With at most 2 pairs
  // the odd k-steps go to out[4 ..], a second chain of dependent mma,
  // summed at the end.
  auto contract = [&](auto dir_c, auto np_c, uint32_t rslot,
                      float (&out)[8][4]) {
    constexpr int kDir = decltype(dir_c)::value;
    constexpr int kNp = decltype(np_c)::value;
    constexpr bool kTwoChains = kNp <= 2;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t a[4];
      if constexpr (kDir == 1) {
        ldsm_x4_trans(wt_off + 4096u * kk, a);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = kf[kk][e];
      }
      const int base = kTwoChains && (kk & 1) ? 4 : 0;
#pragma unroll
      for (int pr = 0; pr < kNp; ++pr) {
        uint32_t b[4];
        ldsm_x4_trans(rslot + r16 * kk + r_off[pr], b);
        mma_bf16(out[base + 2 * pr], a, b[0], b[1]);
        mma_bf16(out[base + 2 * pr + 1], a, b[2], b[3]);
      }
    }
    if constexpr (kTwoChains) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) out[nt][e] += out[4 + nt][e];
      }
    }
  };
  // The contraction of a chunk of ntv n-tiles, by its pair count.
  auto contract_n = [&](auto dir_c, int ntv, uint32_t rslot,
                        float (&out)[8][4]) {
    switch ((ntv + 1) >> 1) {
      case 1:
        contract(dir_c, std::integral_constant<int, 1>{}, rslot, out);
        break;
      case 2:
        contract(dir_c, std::integral_constant<int, 2>{}, rslot, out);
        break;
      case 3:
        contract(dir_c, std::integral_constant<int, 3>{}, rslot, out);
        break;
      default:
        contract(dir_c, std::integral_constant<int, 4>{}, rslot, out);
    }
  };

  // The chunk's columns c0 .. of the output rows o0 + 16 warp + g (+ 8),
  // into dst (ld floats a column, particle base at 0).
  auto flush = [&](const float (&out)[8][4], float* dst, int base, int o0,
                   int c0, int ntv, int ld) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < ntv) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = o0 + row0 + 8 * (e >> 1);
          const int col = c0 + 8 * nt + 2 * t + (e & 1);
          if (o < n && col <= 2 * m) {
            atomicAdd(dst + static_cast<size_t>(col) * ld + (o - base),
                      out[nt][e]);
          }
        }
      }
    }
  };

  Bf16Cursor cur = work.start(lo);
#pragma unroll 1
  for (long long k = 0; k < mine; ++k, work.advance(cur)) {
    WideSpot sp;
    if (!work.spot(cur, sp)) {
#pragma unroll 1
      for (int s = 0; s < ns; ++s) next_stage();
      continue;
    }
    const bool diag = sp.diag;
    const bool guarded = diag || sp.i0 + S > n || sp.j0 + S > n;
    {
      float acc[16][4];
      int off = 0;  // the ring offset of the pass's last Gram stage
      // A Gram tile over the next kg stages into acc.
      auto gram = [&]() {
#pragma unroll
        for (int c = 0; c < 16; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
        }
#pragma unroll 1
        for (int s = 0; s < kg; ++s) {
          off = next_stage();
          const uint32_t x_i = ring + off;
          const uint32_t x_j = x_i + L::kSlotBytes + gb_row;
          const int kv = min(sl >> 4, (m - s * sl + 15) >> 4);
#pragma unroll 1
          for (int ks = 0; ks < kv; ++ks) {
            uint32_t a[4];
            ldsm_x4(x_i + ga_row + 16 * ((2 * ks + (lane >> 4)) ^ sw_ga), a);
            const uint32_t bk =
                x_j + 16 * ((2 * ks + ((lane >> 3) & 1)) ^ sw_gb);
#pragma unroll
            for (int p = 0; p < 8; ++p) {
              uint32_t b[4];
              ldsm_x4(bk + g16 * p, b);
              mma_bf16(acc[2 * p], a, b[0], b[1]);
              mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
            }
          }
        }
      };
      // sq, the counts and k once a pair, from the Gram tile in acc: into
      // the A fragments kf (kRows: the rows of I take K from registers)
      // and into W (kCols: the columns of J read K^T there). On a
      // diagonal item the pass that feeds the rows keeps j >= i, the self
      // pair pinned to 0 unless kAsym; K15's columns' pass keeps j > i.
      auto weigh = [&](auto guard_c, auto rows_c, auto cols_c) {
        constexpr bool kGuard = decltype(guard_c)::value;
        constexpr bool kRows = decltype(rows_c)::value;
        constexpr bool kCols = decltype(cols_c)::value;
        const float* nrm = reinterpret_cast<const float*>(
            bf16_sh + off + 2 * L::kSlotBytes);
        const float qi[2] = {nrm[row0], nrm[row0 + 8]};
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          const float2 qj =
              *reinterpret_cast<const float2*>(nrm + S + 8 * nt + 2 * t);
          float kv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = row0 + 8 * (e >> 1);
            const int jl = 8 * nt + 2 * t + (e & 1);
            float sq = fmaf(-2.0f, acc[nt][e],
                            __fadd_rn(qi[e >> 1], (e & 1) ? qj.y : qj.x));
            sq = fmaxf(sq, qmin);
            if constexpr (kGuard) {
              if (!kAsym && diag && il == jl) sq = 0.0f;
              const bool keep = !diag || (kRows ? jl >= il : jl > il);
              const bool ok = keep && sp.i0 + il < n && sp.j0 + jl < n;
              count_pair_fixed<kT, true>(sq, th, ok, cnt);
              kv[e] = ok ? ex2_ftz(ng2 * sq) : 0.0f;
            } else {
              count_pair_fixed<kT, false>(sq, th, true, cnt);
              kv[e] = ex2_ftz(ng2 * sq);
            }
          }
          const uint32_t lo = pack_bf16x2(kv[0], kv[1]);  // row g
          const uint32_t hi = pack_bf16x2(kv[2], kv[3]);  // row g + 8
          if constexpr (kRows) {
            kf[nt >> 1][2 * (nt & 1)] = lo;
            kf[nt >> 1][2 * (nt & 1) + 1] = hi;
          }
          if constexpr (kCols) {
            *reinterpret_cast<uint32_t*>(
                wgen + 16 * ((row0 << 4) + (nt ^ g)) + 4 * t) = lo;
            *reinterpret_cast<uint32_t*>(
                wgen + 16 * (((row0 + 8) << 4) + (nt ^ g)) + 4 * t) = hi;
          }
        }
      };
      auto weigh_pass = [&](auto rows_c, auto cols_c) {
        if (guarded) {
          weigh(std::true_type{}, rows_c, cols_c);
        } else {
          weigh(std::false_type{}, rows_c, cols_c);
        }
      };
      if constexpr (kAsym) {
        gram();  // G2 = Y_I X_J^T: k(j <- i), the columns' W
        weigh_pass(std::false_type{}, std::true_type{});
        gram();  // G1 = X_I Y_J^T: k(i <- j), the rows' kf
        weigh_pass(std::true_type{}, std::false_type{});
      } else {
        gram();
        weigh_pass(std::true_type{}, std::true_type{});
      }
    }
    // The record chunks: the rows of I (A = K from registers, B = R_J),
    // then the columns of J (A = K^T from W, complete once every consumer
    // passed the chunk's barrier; B = R_I).
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      const uint32_t r_i = ring + next_stage();
      const uint32_t r_j = r_i + L::kSlotBytes;
      const int c0 = c * cw;
      const int ntv = min(cw >> 3, (2 * m + 1 - c0 + 7) >> 3);
      float out[8][4];
#pragma unroll
      for (int dir = 0; dir < 2; ++dir) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) out[nt][e] = 0.0f;
        }
        if (dir == 0) {
          contract_n(std::integral_constant<int, 0>{}, ntv, r_j, out);
          flush(out, sp.out0, sp.base0, sp.i0, c0, ntv, sp.ld);
        } else {
          contract_n(std::integral_constant<int, 1>{}, ntv, r_i, out);
          flush(out, sp.out1, sp.base1, sp.j0, c0, ntv, sp.ld);
        }
      }
    }
  }
  flush_counts(cnt, T, counts);
}

// Allow a kernel on this body its dynamic shared memory and give its grid:
// one persistent block an SM, no more blocks than work items
// (sym_plan.wide_sym_blocks). A refusal also fails the launch, which the
// entry's cudaGetLastError() reports.
template <class Kernel>
inline unsigned int bf16_tri_prepare(Kernel* kernel, long long items) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(Bf16Tri::kSmemBytes));
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return static_cast<unsigned int>(items < sms ? items : sms);
}

// Column c of a particle's bf16 record R = [S | X | 1 | 0...] from its
// float32 scores s and centred coordinates x: the pack kernels' (K2's and
// K3's here, K1's in square_bf16_sm90.cuh).
__device__ __forceinline__ __nv_bfloat16 bf16_record_value(const float* x,
                                                           const float* s,
                                                           int m, int c) {
  const float v = c < m ? s[c]
                        : (c < 2 * m ? x[c - m] : (c == 2 * m ? 1.0f : 0.0f));
  return __float2bfloat16_rn(v);
}

// The operands' one rounding: a warp a particle (kRows particles a block)
// reads its float32 centred coordinates and scores and writes q (the
// float32 norm |x|^2, or the caller's q copied where given), X (bf16, zero
// past m), R = [S | X | 1 | 0...] (bf16) and, where y is given (K15's
// Y = X_c (P_sym/2), float32), Y (bf16, zero past m; ops.yg). A template,
// so that the three sources that include this header share it.
template <int kRows>
__global__ void __launch_bounds__(32 * kRows)
    bf16_tri_pack_kernel(const float* __restrict__ coords,
                         const float* __restrict__ scores,
                         const float* __restrict__ y,
                         const float* __restrict__ qg, int n, int m,
                         Bf16Operands ops) {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int i = static_cast<int>(blockIdx.x) * kRows +
                (static_cast<int>(threadIdx.x) >> 5);
  if (i >= n) return;  // uniform over the warp
  const int mk = bf16_gram_width(m);
  const int rw = bf16_record_width(m);
  const float* x = coords + static_cast<size_t>(i) * m;
  const float* s = scores + static_cast<size_t>(i) * m;
  float acc = 0.0f;
  for (int c = lane; c < mk; c += 32) {
    const float v = c < m ? x[c] : 0.0f;
    acc = fmaf(v, v, acc);
    ops.xg[static_cast<size_t>(i) * mk + c] = __float2bfloat16_rn(v);
    if (y != nullptr) {
      const float w = c < m ? y[static_cast<size_t>(i) * m + c] : 0.0f;
      ops.yg[static_cast<size_t>(i) * mk + c] = __float2bfloat16_rn(w);
    }
  }
  for (int c = lane; c < rw; c += 32) {
    ops.rec[static_cast<size_t>(i) * rw + c] = bf16_record_value(x, s, m, c);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) ops.q[i] = qg != nullptr ? qg[i] : acc;
}

// Launch the pack into `work` (16-byte aligned, sym_plan.bf16_work_bytes
// bytes, with Y's block where y is given) and return the packed operands:
// K2's and K3's from the coordinates and scores; K15's also from y and q,
// its rows x_c (P_sym/2) and norms x_i . y_i (float32, (n, m) and (n,)).
inline Bf16Operands bf16_tri_pack(const float* coords, const float* scores,
                                  int n, int m, void* work, cudaStream_t s,
                                  const float* y = nullptr,
                                  const float* q = nullptr) {
  const Bf16Operands ops = bf16_operands(work, n, m, y != nullptr);
  bf16_tri_pack_kernel<kBf16PackRows>
      <<<(n + kBf16PackRows - 1) / kBf16PackRows, 32 * kBf16PackRows, 0,
         s>>>(coords, scores, y, q, n, m, ops);
  return ops;
}

}  // namespace svgd
