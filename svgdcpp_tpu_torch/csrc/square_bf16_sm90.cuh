// K1's bfloat16 instance (fused_phi.cu, fused_phi_counts_square_bf16: the
// square and cross forms of the JAX package's _fused_kernel under
// dot_dtype='bfloat16', pallas_phi.py:365-378 through
// _phi_rbf_fused_pallas_cross_impl, :393-440, and the mesh's cross sweep,
// :1795-1816), at every m >= 1, for Hopper.
//
// It computes what the JAX kernel computes under bf16, and what its plain
// version ops/phi.phi_rbf_terms_cross_fused_counts(dot_dtype='bfloat16')
// computes: the Gram tile of the bf16-rounded centred coordinates with
// float32 accumulation; the norms q of the unrounded float32 coordinates;
// sq = max(0, q_i + q_j - 2 G), no self pair pinned (the square form has
// none); the counts of every ordered pair from that sq; k = exp2(-gamma
// log2(e) sq) rounded to bf16 to nearest even; K contracted with the bf16
// record [S | X | 1] in float32 into each split's partial [KS | KX |
// rowsum]; then square_mma.cuh's finishing pass, which sums the splits in
// split order and forms D = rowsum x_i - KX with the float32 x_i, as the
// JAX epilogue does (pallas_phi.py:429-433).
//
// What bounds it. Per ordered pair: the Gram dot (m MACs), sq, one ex2, the
// bf16 rounding, T compares and the contraction (2m + 1 MACs): the FP32
// pipes and the special function unit, about 12 instructions a pair and
// m more for the Gram. The body that ran this instance before
// (square_wide_body, whose text chip_profile.py's SQUARE_WIDE_PARENT_SOURCE
// keeps) was the float32 wide body of 4 warps and 64 target rows a block,
// tiles of 32 sources staged synchronously with scalar loads, Gram slices
// of 32 coordinates and record chunks of 128 columns whatever m (at m = 2,
// 30 of 32 and 123 of 128 zero), each value rounded where it was staged
// into a float32 slot and each product one TF32 m16n8k8 pass. This body:
//
//   * The Gram tile on the CUDA cores, one FMA a coordinate in coordinate
//     order from zero, on the rounded coordinates (exact products): the
//     float32 product's own sequence of roundings, so that with the norms
//     q of the same torch reduction (the wrapper's) sq is the plain
//     version's to the bit. A weight k sits within an ulp of a bf16
//     rounding boundary often enough that any other order of the Gram's
//     sum (a tensor core's, or the exact sum's) moves a few k a call by one
//     bf16 ulp, and one such k on a pair with a large score moved the flat
//     BLR's phi by 1e-3 of its largest value on an H100.
//   * The operands are rounded once a call by a pack kernel
//     (square_bf16_pack_kernel, a thread a column, on K2's record column):
//     the rounded coordinates as float32 rows of m padded to a multiple of
//     4 and the bf16 record R = [S | X | 1 | 0...] of bf16_record_width(m)
//     into the workspace, and each row's squares, which the wrapper sums
//     into q with the plain version's own torch reduction (K2's pack sums
//     them in a warp's order: one launch fewer, but not the plain
//     version's bits). The pack also zeroes the counts.
//   * The target rows stay with the block: 8 consumer warps own 16 rows
//     each, 128 a block; their coordinates sit in shared memory for the
//     block's whole source range (loaded once with the first stage; past
//     4 slices of 32, m > 128, they stream with each slice instead), their
//     q in registers, and the float32 accumulators of the chunk's record
//     columns in registers until the split ends.
//   * The sources stream through a cp.async ring of kSqBf16Stages stages,
//     filled kSqBf16Stages - 1 ahead by producer warps: per tile of
//     kSqBf16Tile = 64 sources, one stage a Gram slice of up to 32
//     coordinates (rows of 36 floats, or 4 at m <= 4: a quad's rows fall in
//     distinct banks), the last also holding the tile's record chunk and
//     norms (one stage a tile up to m = 32). Record rows follow m: NT n8
//     tiles (at m = 2 two, one of them zero), their 16-byte segments
//     XOR-swizzled so that ldmatrix.trans reads them conflict-free.
//   * Weights from registers: a warp's Gram values over a k16 step of
//     sources, two n8 tiles of the mma accumulator layout, give sq, the
//     counts and k once a pair, and the k of the two tiles packs
//     (pack_bf16x2) into the A fragment of one k16 step: K . R_J runs on
//     bf16 mma.sync m16n8k16 with A from registers and B = R_J by
//     ldmatrix.trans. The square form needs no K^T, so there is no weight
//     tile, no second direction and no float atomics.
//   * Record columns past 16 n8 tiles (m >= 64) are cut into chunks of
//     128 along the grid's z; each chunk recomputes the Gram tile and only
//     chunk 0 counts, so that each pair is counted once. The accumulator
//     tiles of an instance (NT = 2, 4, 8 or 16) are a compile-time array;
//     the tiles past the record's width read zero columns and are never
//     written.
//   * Source rows past n_s arrive as zeros, records included, so they add
//     nothing; the tile that holds them (and a block whose target rows
//     pass n_t, and every chunk past 0) takes the guarded weighing, which
//     counts only real pairs and zeroes their weights.
//   * The launch plan (sq_bf16_chunk) splits the sources over the grid's y
//     in whole tiles, the split count that fills whole waves of the SMs
//     (square_mma.cuh's square_wave_tiles); each split writes its partial
//     rows, so K1 stays free of float atomics and deterministic.

#pragma once

#include <cuda_bf16.h>

#include "bf16_tri_sm90.cuh"

namespace svgd {

constexpr int kSqBf16Rows = 128;          // target rows a block
constexpr int kSqBf16Warps = 8;           // consumer warps, 16 rows each
constexpr int kSqBf16Consumers = 32 * kSqBf16Warps;
constexpr int kSqBf16Tile = 64;           // sources a tile: the split grain
constexpr int kSqBf16Slice = 32;          // coordinates of a Gram slice
constexpr int kSqBf16SliceLd = 36;        // its rows' stride (4 mod 32)
constexpr int kSqBf16ChunkTiles = 16;     // n8 tiles of a record chunk
constexpr int kSqBf16Stages = 4;          // the ring's stages (a power of 2)
constexpr int kSqBf16ResidentSlices = 4;  // X_I resident up to this many

// The blocks an SM of an instance at nt accumulator tiles: two at nt = 2
// (m <= 7), one past it. A warp's registers come from its SM sub-partition's
// 16K, so a block of 9 or 10 warps holds 168 a thread alone and 96 beside a
// second block.
__host__ __device__ constexpr int sq_bf16_blocks_per_sm(int nt) {
  return nt <= 2 ? 2 : 1;
}

// An instance's block at NT accumulator tiles: one producer warp where two
// blocks share an SM, two where one block has it.
template <int NT>
struct SqBf16 {
  static constexpr int kMinBlocks = sq_bf16_blocks_per_sm(NT);
  static constexpr int kProducers = 64 / kMinBlocks;
  static constexpr int kThreads = kSqBf16Consumers + kProducers;
};

// The width of the rounded coordinates' rows: m floats padded to a
// multiple of 4 (ops/sym_plan.square_bf16_row_width).
__host__ __device__ constexpr int sq_bf16_row_width(int m) {
  return 4 * ((m + 3) / 4);
}

// The layout of a launch at dimension m (ops/sym_plan.square_bf16_plan
// mirrors it): the coordinates' and the record's row widths (wq, rw), the
// Gram slices (kg) and a slice's rows' stride in floats (ld), the
// accumulator tiles of an instance (nt, a power of 2 from 2 to 16) and the
// record chunks along the grid's z, the blocks an SM (bps), whether X_I
// stays resident; the bytes of a target slot (128 rows of a slice), the
// byte offsets within a ring stage of the sources' slice (xj), record
// chunk (rj) and norms (qj) and of the streamed targets' slice (xi), the
// stage's bytes and the dynamic shared memory.
struct SqBf16Plan {
  int wq, rw, kg, ld, nt, chunks, bps, resident;
  int slot_i, xj, rj, qj, xi, stage, smem;
};

__host__ __device__ inline SqBf16Plan sq_bf16_plan(int m) {
  SqBf16Plan p;
  p.wq = sq_bf16_row_width(m);
  p.rw = bf16_record_width(m);
  p.kg = (p.wq + kSqBf16Slice - 1) / kSqBf16Slice;
  p.ld = p.wq == 4 ? 4 : kSqBf16SliceLd;
  const int tiles = p.rw / 8;
  p.chunks = (tiles + kSqBf16ChunkTiles - 1) / kSqBf16ChunkTiles;
  p.nt = 2;
  while (p.nt < tiles && p.nt < kSqBf16ChunkTiles) p.nt *= 2;
  p.bps = sq_bf16_blocks_per_sm(p.nt);
  p.resident = p.kg <= kSqBf16ResidentSlices ? 1 : 0;
  p.slot_i = kSqBf16Rows * p.ld * 4;
  p.xj = 0;
  p.rj = kSqBf16Tile * p.ld * 4;
  p.qj = p.rj + kSqBf16Tile * 16 * p.nt;
  p.xi = p.qj + 4 * kSqBf16Tile;
  p.stage = p.xi + (p.resident ? 0 : p.slot_i);
  p.smem = kSqBf16Stages * p.stage + (p.resident ? p.kg * p.slot_i : 0);
  return p;
}

// The sources of one split of a launch (whole tiles of kSqBf16Tile;
// square_wave_tiles over target blocks x record chunks, bps blocks an SM)
// and the split count. ops/sym_plan.square_bf16_chunk mirrors it.
inline int sq_bf16_chunk(int n_t, int n_s, int m, int* splits) {
  const SqBf16Plan p = sq_bf16_plan(m);
  const long long rb = (n_t + kSqBf16Rows - 1) / kSqBf16Rows;
  const int tiles = (n_s + kSqBf16Tile - 1) / kSqBf16Tile;
  return kSqBf16Tile * square_wave_tiles(rb * p.chunks, tiles, p.bps, splits);
}

// The workspace of a launch, in 16-byte-aligned segments: the splits'
// partials (splits, n_t, 2m + 1) in float32; the sources' rounded rows
// (n_s, wq) and, in the cross form, the targets' (n_t, wq), float32; the
// sources' record (n_s, rw) in bf16. Byte offsets of the rows and the
// record, and the whole's bytes; in the square form x_t is x_s.
// ops/sym_plan.square_bf16_work mirrors it.
struct SqBf16Work {
  size_t x_s, x_t, rec, bytes;
};

inline SqBf16Work sq_bf16_work(int n_t, int n_s, int m, int splits,
                               bool square) {
  auto up = [](size_t b) { return (b + 15) / 16 * 16; };
  const SqBf16Plan p = sq_bf16_plan(m);
  SqBf16Work w;
  w.x_s = up(4ull * static_cast<size_t>(splits) * n_t * (2 * m + 1));
  size_t at = w.x_s + up(4ull * static_cast<size_t>(n_s) * p.wq);
  w.x_t = square ? w.x_s : at;
  if (!square) at += up(4ull * static_cast<size_t>(n_t) * p.wq);
  w.rec = at;
  w.bytes = at + up(2ull * static_cast<size_t>(n_s) * p.rw);
  return w;
}

// The sweep's operands: the targets' q and rounded coordinates (the
// sources' own in the square form), the sources' q, rounded coordinates
// and record.
struct SqBf16Operands {
  const float* q_t;
  const float* x_t;
  const float* q_s;
  const float* x_s;
  const __nv_bfloat16* rec;
};

// What the pack writes: the targets' and the sources' squares (n, m)
// float32 (sq_t unused in the square form), and into the workspace the
// rounded rows and the record at sq_bf16_work's offsets.
struct SqBf16Pack {
  float* sq_t;
  float* sq_s;
  float* x_t;
  float* x_s;
  __nv_bfloat16* rec;
};

// The pack's block: 32 columns (a warp) of kSqBf16PackRows rows.
constexpr int kSqBf16PackRows = 8;

// The pack: a thread a column of a row, the grid's x over the n_tp target
// rows (0 in the square form) and then the n_s source rows, its y over the
// record's columns in warps of 32. Column c of a row: its square
// (__fmul_rn, the plain version's c * c) and its coordinate rounded to
// bf16 to nearest even as float32 (zero past m, up to wq), and a source's
// record column (bf16_record_value); block (0, 0) zeroes the T counts that
// the sweep adds into.
__global__ void __launch_bounds__(32 * kSqBf16PackRows)
    square_bf16_pack_kernel(const float* __restrict__ targets,
                            const float* __restrict__ sources,
                            const float* __restrict__ scores, int n_tp,
                            int n_s, int m, SqBf16Pack out,
                            unsigned long long* __restrict__ counts, int T) {
  const int c = static_cast<int>(blockIdx.y * 32 + threadIdx.x);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.y == 0 &&
      c < T) {
    counts[c] = 0ull;
  }
  int i = static_cast<int>(blockIdx.x) * kSqBf16PackRows +
          static_cast<int>(threadIdx.y);
  if (i >= n_tp + n_s) return;
  const bool src = i >= n_tp;
  if (src) i -= n_tp;
  const float* x = (src ? sources : targets) + static_cast<size_t>(i) * m;
  const int wq = sq_bf16_row_width(m);
  if (c < wq) {
    const float v = c < m ? x[c] : 0.0f;
    if (c < m) {
      (src ? out.sq_s : out.sq_t)[static_cast<size_t>(i) * m + c] =
          __fmul_rn(v, v);
    }
    (src ? out.x_s : out.x_t)[static_cast<size_t>(i) * wq + c] =
        __bfloat162float(__float2bfloat16_rn(v));
  }
  const int rw = bf16_record_width(m);
  if (src && c < rw) {
    out.rec[static_cast<size_t>(i) * rw + c] =
        bf16_record_value(x, scores + static_cast<size_t>(i) * m, m, c);
  }
}

// The swizzle of row r of a record slot whose rows hold 2^lg 16-byte
// segments, as bf16_slot_seg up to 8 segments, and the low 3 bits of r past
// them: the 8 rows of an 8 x 8 matrix at one logical segment take 8
// distinct bank groups. It depends on r's place within 16 rows only.
__device__ __forceinline__ int sq_bf16_swz(int r, int lg) {
  return lg >= 3 ? (r & 7) : ((r >> (3 - lg)) & ((1 << lg) - 1));
}

__device__ __forceinline__ int sq_bf16_seg(int r, int seg, int lg) {
  return (r << lg) + (seg ^ sq_bf16_swz(r, lg));
}

// c + a.x b.x + a.y b.y + a.z b.z + a.w b.w, one FMA a term in that order.
__device__ __forceinline__ float fma4(const float4& a, const float4& b,
                                      float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

// The body (see the top of the file) for NT accumulator tiles (the plan's
// nt) and kT thresholds (3, or kMaxT for a runtime T padded with the
// first); ng2 = -gamma log2(e). part: this split's (n_t, 2m + 1) slice of
// the partials; the block writes its chunk's (blockIdx.z) columns and, in
// chunk 0, adds its counts. Warps 0-7 compute; the rest, the producers,
// issue every copy.
template <int kT, int NT>
__device__ __forceinline__ void square_bf16_body(
    const SqBf16Operands& ops, float ng2, const float* __restrict__ thr,
    int n_t, int n_s, int m, int T, int chunk, float* __restrict__ part,
    unsigned long long* __restrict__ counts) {
  constexpr int S = kSqBf16Stages;
  constexpr int kLgR = NT == 2 ? 1 : (NT == 4 ? 2 : (NT == 8 ? 3 : 4));
  constexpr int kProducers = SqBf16<NT>::kProducers;
  const SqBf16Plan p = sq_bf16_plan(m);
  extern __shared__ __align__(128) unsigned char sqb_sh[];
  const uint32_t ring =
      static_cast<uint32_t>(__cvta_generic_to_shared(sqb_sh));
  const int xres = S * p.stage;  // the resident target slices' offset

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rb = static_cast<int>(blockIdx.x) * kSqBf16Rows;
  const int j_begin = static_cast<int>(blockIdx.y) * chunk;
  const int j_end = min(n_s, j_begin + chunk);
  const int tiles = (j_end - j_begin + kSqBf16Tile - 1) / kSqBf16Tile;
  const int c0 = static_cast<int>(blockIdx.z) * 8 * NT;  // chunk's column
  const bool counting = blockIdx.z == 0;
  const int total = tiles * p.kg;

  if (warp >= kSqBf16Warps) {
    // The producers. copy_x: `rows` slot rows (p.ld floats apart) of
    // slice s of the coordinates from global rows row0 + r (those past
    // `valid` zero-filled); copy_r: 64 record rows of NT swizzled segments
    // from column c0 (rows past `valid` and columns past rw zero-filled).
    const int pt = tid - kSqBf16Consumers;
    auto copy_x = [&](uint32_t dst, int rows, int row0, int valid,
                      const float* src, int s) {
      const int k0 = s * kSqBf16Slice;
      const int segs = min(kSqBf16Slice, p.wq - k0) / 4;
#pragma unroll 1
      for (int r = pt; r < rows; r += kProducers) {
        const bool in = r < valid;
        const float* from = src + static_cast<size_t>(row0 + r) * p.wq + k0;
        const uint32_t to = dst + 4u * static_cast<uint32_t>(r * p.ld);
        for (int seg = 0; seg < segs; ++seg) {
          cp_async16_shared(to + 16 * seg, in ? from + 4 * seg : src,
                            in ? 16 : 0);
        }
      }
    };
    auto copy_r = [&](uint32_t dst, int row0, int valid) {
#pragma unroll 2
      for (int e = pt; e < (kSqBf16Tile << kLgR); e += kProducers) {
        const int r = e >> kLgR;
        const int seg = e & (NT - 1);
        const int col = c0 + 8 * seg;
        const bool in = r < valid && col < p.rw;
        cp_async16_shared(
            dst + 16u * static_cast<uint32_t>(sq_bf16_seg(r, seg, kLgR)),
            in ? static_cast<const void*>(
                     ops.rec + static_cast<size_t>(row0 + r) * p.rw + col)
               : static_cast<const void*>(ops.rec),
            in ? 16 : 0);
      }
    };
    if (p.resident) {
      for (int s = 0; s < p.kg; ++s) {
        copy_x(ring + xres + s * p.slot_i, kSqBf16Rows, rb, n_t - rb,
               ops.x_t, s);
      }
    }
    int ic = 0, is = 0;  // the tile and slice of the next stage to issue
    auto issue = [&](int st) {
      const uint32_t stage = ring + (st & (S - 1)) * p.stage;
      const int j0 = j_begin + ic * kSqBf16Tile;
      const int jv = j_end - j0;  // the tile's real sources
      copy_x(stage + p.xj, kSqBf16Tile, j0, jv, ops.x_s, is);
      if (!p.resident) {
        copy_x(stage + p.xi, kSqBf16Rows, rb, n_t - rb, ops.x_t, is);
      }
      if (is == p.kg - 1) {
        copy_r(stage + p.rj, j0, jv);
        if (pt < kSqBf16Tile / 4) {  // the norms of the tile's sources
          const int at = j0 + 4 * pt;
          const int v = min(max(j_end - at, 0), 4);
          cp_async16_shared(stage + p.qj + 16 * pt,
                            v > 0 ? ops.q_s + at : ops.q_s, 4 * v);
        }
      }
      if (++is == p.kg) {
        is = 0;
        ++ic;
      }
    };
#pragma unroll
    for (int st = 0; st < S - 1; ++st) {
      if (st < total) issue(st);
      cp_async_commit();
    }
#pragma unroll 1
    for (int st = 0; st < total; ++st) {
      cp_async_wait<S - 2>();
      __syncthreads();  // stage st landed; stage st - 1's slot is free
      if (st + S - 1 < total) issue(st + S - 1);
      cp_async_commit();
    }
    cp_async_wait<0>();
    return;
  }

  // The thresholds: in registers at T = 3; the runtime-T instances read
  // them from shared memory (written before the first barrier), which
  // keeps their registers within the 168 of ten warps.
  __shared__ float th_sh[kMaxT];
  float th_r[3];
  const float* th = th_r;
  if constexpr (kT == 3) {
#pragma unroll
    for (int k = 0; k < 3; ++k) th_r[k] = thr[k < T ? k : 0];
  } else {
    if (tid < kMaxT) th_sh[tid] = thr[tid < T ? tid : 0];
    th = th_sh;
  }
  unsigned int cnt[kMaxT];
#pragma unroll
  for (int k = 0; k < kMaxT; ++k) cnt[k] = 0u;

  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = 16 * warp + g;  // the block's rows row0, row0 + 8
  const bool rok0 = rb + row0 < n_t;
  const bool rok1 = rb + row0 + 8 < n_t;
  const float qi0 = rok0 ? ops.q_t[rb + row0] : 0.0f;
  const float qi1 = rok1 ? ops.q_t[rb + row0 + 8] : 0.0f;
  const bool edge_rows = rb + kSqBf16Rows > n_t;

  // Records (ldmatrix.trans B): the lane's row ra of each k-step's 16
  // (matrices 1 and 3 in the second 8), n8 pair pr's segment
  // 2 pr + (lane >> 4), swizzled: (2 pr + hi) ^ sw = 2 pr ^ (hi ^ sw).
  const int ra = (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t r_row = 16u * static_cast<uint32_t>(ra << kLgR);
  const int r_x = (lane >> 4) ^ sq_bf16_swz(ra, kLgR);
  constexpr uint32_t r16 = 256u << kLgR;  // 16 rows of a record slot

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  }

  int ring_at = 0;
  // The next stage's byte offset in the ring, after the barrier that shows
  // it landed and that every warp is done with the stage before.
  auto next_stage = [&]() {
    __syncthreads();
    const int off = ring_at * p.stage;
    ring_at = (ring_at + 1) & (S - 1);
    return off;
  };

#pragma unroll 1
  for (int c = 0; c < tiles; ++c) {
    const int j0 = j_begin + c * kSqBf16Tile;
    // The warp's Gram tile (16 rows x 64 sources) in the mma accumulator
    // layout: ag[nt][e] pairs row row0 + 8 (e >> 1) with source
    // 8 nt + 2 t + (e & 1).
    float ag[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ag[nt][e] = 0.0f;
    }
    int off = 0;  // the tile's last stage: its records and norms
#pragma unroll 1
    for (int s = 0; s < p.kg; ++s) {
      off = next_stage();
      const float* xi = reinterpret_cast<const float*>(
          sqb_sh + (p.resident ? xres + s * p.slot_i : off + p.xi));
      const float* a0p = xi + row0 * p.ld;
      const float* a1p = a0p + 8 * p.ld;
      const float* bp = reinterpret_cast<const float*>(sqb_sh + off + p.xj) +
                        2 * t * p.ld;
      const int kw = min(kSqBf16Slice, p.wq - s * kSqBf16Slice);
#pragma unroll 1
      for (int k = 0; k < kw; k += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(a0p + k);
        const float4 a1 = *reinterpret_cast<const float4*>(a1p + k);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* b = bp + 8 * nt * p.ld + k;
          const float4 b0 = *reinterpret_cast<const float4*>(b);
          const float4 b1 = *reinterpret_cast<const float4*>(b + p.ld);
          ag[nt][0] = fma4(a0, b0, ag[nt][0]);
          ag[nt][1] = fma4(a0, b1, ag[nt][1]);
          ag[nt][2] = fma4(a1, b0, ag[nt][2]);
          ag[nt][3] = fma4(a1, b1, ag[nt][3]);
        }
      }
    }
    const float* nrm =
        reinterpret_cast<const float*>(sqb_sh + off + p.qj);
    const uint32_t rj = ring + off + p.rj;
    // sq, the counts and k once a pair, a k16 step of sources (two n8
    // tiles) at a time, into the A fragment of K . R_J.
    auto sweep = [&](auto guard_c) {
      constexpr bool kGuard = decltype(guard_c)::value;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t kf[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nt = 2 * kk + h;
          const float2 qj =
              *reinterpret_cast<const float2*>(nrm + 8 * nt + 2 * t);
          float kv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float sq = fmaf(-2.0f, ag[nt][e],
                            __fadd_rn(e < 2 ? qi0 : qi1,
                                      (e & 1) ? qj.y : qj.x));
            sq = fmaxf(sq, 0.0f);
            if constexpr (kGuard) {
              const bool col_ok = j0 + 8 * nt + 2 * t + (e & 1) < j_end;
              const bool ok = counting && (e < 2 ? rok0 : rok1) && col_ok;
              count_pair_fixed<kT, true>(sq, th, ok, cnt);
              kv[e] = col_ok ? ex2_ftz(ng2 * sq) : 0.0f;
            } else {
              count_pair_fixed<kT, false>(sq, th, true, cnt);
              kv[e] = ex2_ftz(ng2 * sq);
            }
          }
          kf[2 * h] = pack_bf16x2(kv[0], kv[1]);      // row g
          kf[2 * h + 1] = pack_bf16x2(kv[2], kv[3]);  // row g + 8
        }
#pragma unroll
        for (int pr = 0; pr < NT / 2; ++pr) {
          uint32_t b[4];
          ldsm_x4_trans(rj + r16 * kk + r_row +
                            16u * static_cast<uint32_t>((2 * pr) ^ r_x),
                        b);
          mma_bf16(acc[2 * pr], kf, b[0], b[1]);
          mma_bf16(acc[2 * pr + 1], kf, b[2], b[3]);
        }
      }
    };
    if (edge_rows || !counting || j0 + kSqBf16Tile > j_end) {
      sweep(std::true_type{});
    } else {
      sweep(std::false_type{});
    }
  }

  // The split's partial [KS | KX | rowsum] of the warp's rows: record
  // column c0 + col is the partial's column; the zero columns go nowhere.
  const int wd = 2 * m + 1;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rb + row0 + 8 * (e >> 1);
      const int col = c0 + 8 * nt + 2 * t + (e & 1);
      if (row < n_t && col < wd) {
        part[static_cast<size_t>(row) * wd + col] = acc[nt][e];
      }
    }
  }
  if (counting) flush_counts(cnt, T, counts);
}

}  // namespace svgd
