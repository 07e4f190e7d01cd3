"""Which form of the fused sweep runs: square, full-width triangle or panel.

The JAX package picks between three forms of its fused sweep over one
particle set (``svgdcpp_tpu/ops/pallas_phi.py``): the square sweep, the
full-width upper-triangle sweep while its accumulator fits a VMEM budget,
and past that budget the panel-rotated triangle sweep, whose output window
rotates per pair of super-blocks. This module repeats its rules so that the
port, which imports nothing of the JAX package, makes the same decision:

  * ``jax_resolve_sym`` -- ``_resolve_sym`` (pallas_phi.py:515) as the
    two entry points call it (``sym`` None, their default 512 x 2048 tiles,
    tile_j narrowed to 1024 at n <= 12288: :731-738 for one RBF past
    m = 4, :3569-3575 for a composed kernel), with ``_sym_eligible``
    (:510);
  * ``sym_panel_eligible`` / ``sym_panel_terms_eligible`` -- the panel
    forms' eligibility (:815, :831), with ``sym_panel_plan`` (:795) and
    ``sym_panel_terms_direct_plan`` (:2663);
  * ``tpu_terms_panel_kernel`` -- which of the two composed panel kernels
    the JAX package runs for a shape: K12 (the direct plan) where
    ``_sym_panel_terms_direct_plan`` has one, else K13 (:3580-3594).

``_terms_direct_fits`` (:2381-2392) is not repeated: it picks between K8
and K9 inside the full-width form, and one CUDA kernel stands for both.

The sharded engine's decisions are repeated too (``sym_pairs_plan``
:1051, ``sym_sharded_plan`` :1493, ``sym_panel_sharded_plan`` :1508). The
port uses them only to decide the form, "full", "panel" or False, as it
uses ``jax_resolve_sym``: the card splits the work its own way, a
contiguous balanced range of the full-width kernel's tile list per rank
(``sym_tile_chunk``) or of the panel kernel's panel list (``panel_chunk``),
every unordered pair in exactly one rank's range. The TPU's super-tiles
and its sentinel pairs are not copied: an empty range is an empty launch.

Every constant here is a TPU number (a VMEM budget, a compile envelope
bisected on the chip), taken as the starting point in the same way as
SYM_MIN_N; none is measured on the card. The card's own panel plan, the
super-block width its CUDA panel kernels use, is ``card_panel_plan``.
"""

from __future__ import annotations

#: The triangle forms from this many particles up (``_SYM_MIN_N``).
SYM_MIN_N = 2048

#: Up to this dimension the sweeps, the JAX package's and the port's, build
#: squared distances and quadratic forms from explicit differences (exact
#: in float32, no Gram cancellation; ``_DIFF_FORM_MAX_M``); above it, the
#: Gram identity.
DIFF_FORM_MAX_M = 4

#: VMEM budget of the full-width accumulator pair (``_SYM_ACC_VMEM_BYTES``).
SYM_ACC_VMEM_BYTES = 8 * 2**20

#: The panel forms' ceilings (pallas_phi.py:766-787, :2660).
SYM_PANEL_MIN_BLOCKS = 8
SYM_PANEL_MAX_W = 65536
SYM_PANEL_MAX_W_DUAL_GRAM = 4096
SYM_PANEL_MAX_BLOCKS = 32
SYM_PANEL_MAX_HBM_BYTES = 2 * 2**30
SYM_PANEL_DIRECT_MAX_HBM = 4 * 2**30

#: The JAX entry points' default tile_j, and the n up to which they narrow
#: it to NARROW_TILE_J.
TILE_J = 2048
NARROW_TILE_J = 1024
NARROW_MAX_N = 12288


def ceil_mult(x: int, mult: int) -> int:
    """Round x up to a multiple of mult."""
    return -(-x // mult) * mult


def sym_eligible(n: int, m: int, tile_j: int) -> bool:
    """The full-width triangle's accumulator fits the budget."""
    n_pad = ceil_mult(n, tile_j)
    return n >= SYM_MIN_N and 2 * (2 * m + 1) * n_pad * 4 <= SYM_ACC_VMEM_BYTES


def sym_panel_plan(n: int, m: int, tile_j: int, dual: bool = False):
    """(nb, W, n_pad) of the JAX panel sweep: W a tile_j multiple whose
    (2m+1, 2W) window fits the budget (``_sym_panel_plan``)."""
    bw = 2 * m + 1
    w_cap = (SYM_PANEL_MAX_W_DUAL_GRAM
             if dual and m > DIFF_FORM_MAX_M else SYM_PANEL_MAX_W)
    w_max = min(SYM_ACC_VMEM_BYTES // (bw * 4 * 2), w_cap)
    w_max = max(tile_j, (w_max // tile_j) * tile_j)
    nb = max(SYM_PANEL_MIN_BLOCKS, -(-n // w_max))
    w = ceil_mult(-(-n // nb), tile_j)
    return nb, w, nb * w


def sym_panel_eligible(n: int, m: int, tile_j: int) -> bool:
    """The single-term panel form runs the shape (``_sym_panel_eligible``):
    its window fits the budget and its panel buffer stays under
    SYM_PANEL_MAX_HBM_BYTES."""
    bw = 2 * m + 1
    if SYM_ACC_VMEM_BYTES // (bw * 4 * 2) < tile_j:
        return False
    nb, w, _ = sym_panel_plan(n, m, tile_j)
    num_p = nb * (nb + 1) // 2
    return num_p * bw * 2 * w * 4 <= SYM_PANEL_MAX_HBM_BYTES


def sym_panel_terms_direct_plan(n: int, m: int, num_terms: int,
                                tile_j: int = TILE_J):
    """(nb, W) of the direct composed panel kernel (K12), or None outside
    its chip-bisected envelope (``_sym_panel_terms_direct_plan`` at
    tile_i = 512: the plan exists at the default tiles only)."""
    if tile_j != TILE_J:
        return None
    band = ceil_mult(2 * m + 1, 8)
    if m <= DIFF_FORM_MAX_M:
        if num_terms == 2 and band == 8:
            w_cap, nb_cap = 16384, 64
        elif num_terms == 3 and band == 8:
            w_cap, nb_cap = 16384, 32
        elif num_terms == 2 and band == 16:
            w_cap, nb_cap = 8192, 32
        else:
            return None
    else:
        if num_terms == 2 and band == 24:
            w_cap, nb_cap = 4096, 32
        else:
            return None
    rows = num_terms * band
    w_cap = min(w_cap, SYM_ACC_VMEM_BYTES // (rows * 4 * 2))
    w_cap = (w_cap // tile_j) * tile_j
    if w_cap < tile_j:
        return None
    nb = max(SYM_PANEL_MIN_BLOCKS, -(-n // w_cap))
    if nb > nb_cap:
        return None
    w = ceil_mult(-(-n // nb), tile_j)
    num_p = nb * (nb + 1) // 2
    if num_p * rows * 2 * w * 4 > SYM_PANEL_DIRECT_MAX_HBM:
        return None
    return nb, w


def sym_panel_terms_eligible(n: int, m: int, tile_j: int,
                             num_terms: int) -> bool:
    """The composed panel forms run the shape (``_sym_panel_terms_eligible``
    for a known term count): the direct plan (K12) where it exists, else
    the legacy dual-window region (K13): m from 5 to 24 and at most
    SYM_PANEL_MAX_BLOCKS super-blocks."""
    if sym_panel_terms_direct_plan(n, m, num_terms, tile_j) is not None:
        return True
    if m <= DIFF_FORM_MAX_M or m > 24:
        return False
    nb, _, _ = sym_panel_plan(n, m, tile_j, dual=True)
    return nb <= SYM_PANEL_MAX_BLOCKS


def default_tile_j(n: int, m: int, num_terms: int | None) -> int:
    """tile_j of the JAX entry point for the shape: the single-term one
    (``num_terms`` None) narrows it to 1024 at n <= 12288 past m = 4, the
    composed one at n <= 12288 for every m."""
    narrow = n <= NARROW_MAX_N and (num_terms is not None or m > DIFF_FORM_MAX_M)
    return NARROW_TILE_J if narrow else TILE_J


def jax_resolve_sym(n: int, m: int, num_terms: int | None = None):
    """The JAX package's automatic form (``_resolve_sym`` with ``sym``
    None) for one RBF (``num_terms`` None, ``phi_rbf_fused_pallas``) or a
    composed kernel of ``num_terms`` terms (``phi_rbf_terms_fused_pallas``)
    at its default tiles: False | True | 'panel'."""
    tile_j = default_tile_j(n, m, num_terms)
    if n < SYM_MIN_N:
        return False
    if sym_eligible(n, m, tile_j):
        return True
    if num_terms is None:
        panel_ok = sym_panel_eligible(n, m, tile_j)
    else:
        panel_ok = sym_panel_terms_eligible(n, m, tile_j, num_terms)
    return "panel" if panel_ok else False


def tpu_terms_panel_kernel(n: int, m: int, num_terms: int) -> str:
    """'K12' or 'K13': the composed panel kernel the JAX package runs for
    the shape (its direct plan where one exists, else the legacy one)."""
    plan = sym_panel_terms_direct_plan(
        n, m, num_terms, default_tile_j(n, m, num_terms)
    )
    return "K13" if plan is None else "K12"


# ----------------------------------------------------------------------
# The card's panel plan
# ----------------------------------------------------------------------

#: The CUDA panel kernels' tile: super-block widths are multiples of it.
CARD_PANEL_ALIGN = 64

#: The card's plan: at least this many super-blocks, and super-blocks of
#: at most CARD_PANEL_MAX_W particles (see card_panel_plan).
CARD_PANEL_MIN_BLOCKS = 8
CARD_PANEL_MAX_W = 65536


def card_panel_plan(n: int, panel_blocks: int | None = None):
    """(nb, W, n_pad) of the CUDA panel kernels and their plain versions.

    On the card the window lives in device memory, so no budget bounds W.
    One thread block sweeps one 64-row strip of super-block I against all W
    columns of super-block J, so W is the longest work item: at least
    CARD_PANEL_MIN_BLOCKS super-blocks keep the last blocks' tail short
    against the whole sweep, and W <= CARD_PANEL_MAX_W past that. The panel
    buffer is (nb + 1) * n_pad * 2m float32 values, so fewer super-blocks
    also mean less memory. ``panel_blocks`` forces nb."""
    if panel_blocks is None:
        nb = max(CARD_PANEL_MIN_BLOCKS, -(-n // CARD_PANEL_MAX_W))
    else:
        nb = int(panel_blocks)
        if nb < 1:
            raise ValueError(f"panel_blocks must be >= 1, got {nb}")
    w = ceil_mult(-(-n // nb), CARD_PANEL_ALIGN)
    return nb, w, nb * w


def panel_pairs(nb: int):
    """The super-block pairs (I, J), I <= J, in the panel kernels' launch
    order: the off-diagonal pairs first, row by row, then the diagonal ones
    (whose strips are shorter), so the longest work items start first."""
    off = [(i, j) for i in range(nb) for j in range(i + 1, nb)]
    return off + [(i, i) for i in range(nb)]


# ----------------------------------------------------------------------
# The sharded engine: the JAX decisions and the card's chunks
# ----------------------------------------------------------------------


def sym_pairs_plan(n: int, num_chunks: int, tile_i: int = 512,
                   tile_j: int = 2048):
    """The JAX package's distribution of the global upper-triangle
    super-tile list over ``num_chunks`` devices (``sym_pairs_plan``):
    (pair_i, pair_j, n_pad, per_chunk), the pair arrays padded to
    num_chunks * per_chunk with a sentinel pair, a strictly lower tile."""
    import numpy as np

    if tile_j % tile_i:
        raise ValueError("sym sweep needs tile_j % tile_i == 0")
    r = tile_j // tile_i

    def build(npad):
        nbi, nbj = npad // tile_i, npad // tile_j
        return [(i, j) for i in range(nbi) for j in range(i // r, nbj)]

    n_pad = ceil_mult(n, tile_j)
    pairs = build(n_pad)
    per = -(-len(pairs) // num_chunks)
    short = num_chunks * per - len(pairs)
    if short:
        if (n_pad // tile_i - 1) * tile_i < tile_j:
            n_pad += tile_j
            pairs = build(n_pad)
            per = -(-len(pairs) // num_chunks)
            short = num_chunks * per - len(pairs)
        pairs = pairs + [(n_pad // tile_i - 1, 0)] * short
    return (
        np.asarray([p[0] for p in pairs], np.int32),
        np.asarray([p[1] for p in pairs], np.int32),
        n_pad,
        per,
    )


def sym_sharded_plan(n: int, m: int, num_chunks: int, tile_i: int = 512,
                     tile_j: int = 2048):
    """The JAX gate of the full-width sharded triangle
    (``sym_sharded_plan``): None outside the triangle regime or when the
    (2m+1, n_pad) accumulator pair of the sentinel-extended plan exceeds
    the VMEM budget, else ``sym_pairs_plan``'s plan."""
    if not sym_eligible(n, m, tile_j):
        return None
    plan = sym_pairs_plan(n, num_chunks, tile_i, tile_j)
    if 2 * (2 * m + 1) * plan[2] * 4 > SYM_ACC_VMEM_BYTES:
        return None
    return plan


def sym_panel_sharded_plan(n: int, m: int, num_chunks: int,
                           tile_i: int = 512, tile_j: int = 2048):
    """The JAX gate and plan of the chunked panel triangle
    (``sym_panel_sharded_plan``): None outside the panel regime, else
    (pair_i, pair_j, nb, w, n_pad, per_chunk) with sentinel panels
    (bi > bj) padding the chunks to equal length."""
    import numpy as np

    if tile_j % tile_i:
        return None
    if n < SYM_MIN_N or not sym_panel_eligible(n, m, tile_j):
        return None
    nb, w, n_pad = sym_panel_plan(n, m, tile_j)
    pairs = [(bi, bj) for bi in range(nb) for bj in range(bi, nb)]
    per = -(-len(pairs) // num_chunks)
    short = num_chunks * per - len(pairs)
    pairs = pairs + [(nb - 1, 0)] * short
    return (
        np.asarray([p[0] for p in pairs], np.int32),
        np.asarray([p[1] for p in pairs], np.int32),
        nb,
        w,
        n_pad,
        per,
    )


def dispatch_m(m: int) -> int:
    """The kernels' instance for dimension m (``SVGD_DISPATCH_M`` of
    csrc/sweep_common.cuh): m itself for m = 1..8, 11 and 50, else the
    next of 16, 32 and 64."""
    if m <= 8 or m in (11, 50):
        return m
    return 16 if m <= 16 else 32 if m <= 32 else 64


#: The triangle kernels' tile side where the micro-tile body serves the
#: instance (``MicroWidth`` of csrc/sweep_common.cuh: m = 1-8 and 11), for
#: one RBF (``SymTile``) and a composed kernel (``TermsTriTile``) alike.
MICRO_TILE = 128


def sym_tile(m: int, terms: bool = False) -> int:
    """The side of the full-width triangle kernels' tiles for dimension m,
    from the instance that serves m (:func:`dispatch_m`): MICRO_TILE where
    the micro-tile body serves the instance (m = 1-8 and 11), else the
    one-row-a-thread body's. One RBF (``SymRowTile``): 64 up to an instance
    of 16, 32 above. A composed kernel (``SymTermsTile``): 32 (its 64 up to
    an instance of 12 serves no dimension outside the micro ones). The
    chunk wrappers on the card take the library's own answer
    (``svgd_sym_tile``); this copy serves the plain chunk sweeps, and the
    card's smoke test holds it to the library's."""
    inst = dispatch_m(m)
    if inst <= 8 or inst == 11:
        return MICRO_TILE
    if terms:
        return 32
    return 64 if inst <= 16 else 32


#: The square/cross sweeps' launch (K1's port and the terms kernel, K6/K7's,
#: one rule in csrc/square_mma.cuh): the blocks it aims at (two an SM of 132), the multiple of sources a split
#: holds (the tensor-core body's tile), the target rows a block of each body
#: takes, and the least m the tensor-core body serves (``kSquareBlocks``,
#: ``kSquareGrain``, ``kSqThreads``, ``kSqMmaRows``, ``kSquareTensorMinM``).
SQUARE_BLOCKS = 264
SQUARE_GRAIN = 32
SQUARE_ROWS_CUDA_CORES = 128
SQUARE_ROWS_TENSOR = 64
SQUARE_TENSOR_MIN_M = 5


def square_tensor(m: int) -> bool:
    """Whether the square sweep at width m runs the tensor-core body (from
    SQUARE_TENSOR_MIN_M up) rather than the CUDA-core one."""
    return m >= SQUARE_TENSOR_MIN_M


def square_chunk(n_t: int, n_s: int, m: int) -> int:
    """The sources of one split of a square launch: whole tiles of
    SQUARE_GRAIN, as few as keep about SQUARE_BLOCKS blocks on the card
    (``square_chunk`` of csrc/square_mma.cuh)."""
    rows = SQUARE_ROWS_TENSOR if square_tensor(m) else SQUARE_ROWS_CUDA_CORES
    row_blocks = -(-n_t // rows)
    grains = -(-n_s // SQUARE_GRAIN)
    parts = min(grains, -(-SQUARE_BLOCKS // row_blocks))
    return SQUARE_GRAIN * -(-grains // parts)


def square_splits(n_t: int, n_s: int, m: int) -> int:
    """The number of source splits (the grid's y, the workspace's first
    dimension) of a square launch, K1's or the terms kernel's, or -1 for
    arguments the sweeps do not take: the Python copy of the library's
    ``svgd_square_splits``, which the wrapper reads on the card and the
    card's smoke test holds this copy to."""
    if n_t <= 0 or n_s <= 0 or not 1 <= m <= 64:
        return -1
    return -(-n_s // square_chunk(n_t, n_s, m))


def balanced_range(total: int, world: int, rank: int):
    """(start, count) of rank's contiguous share of ``total`` items: the
    counts of any two ranks differ by at most one."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    start = rank * total // world
    return start, (rank + 1) * total // world - start


def sym_tile_chunk(n: int, world: int, rank: int, tile: int = 64):
    """(t0, count): rank's range of the full-width triangle kernel's tile
    list over n particles in tiles of ``tile`` (the nb (nb + 1) / 2 pairs
    bi <= bj, row by row), balanced by tile count."""
    nb = -(-n // tile)
    return balanced_range(nb * (nb + 1) // 2, world, rank)


def panel_chunk(nb: int, world: int, rank: int):
    """(p0, count): rank's range of ``panel_pairs(nb)``, the panel kernel's
    list of super-block pairs, balanced by panel count."""
    return balanced_range(nb * (nb + 1) // 2, world, rank)


def upper_tile_rows(nb: int, t0: int, count: int):
    """The tiles [t0, t0 + count) of the nb-wide upper-triangle tile list
    as runs of one tile row: (bi, bj_first, bj_last) for each row they
    touch, in order."""
    out = []
    t, end = t0, t0 + count
    bi, row_start = 0, 0
    while t < end:
        row_end = row_start + nb - bi  # tiles (bi, bi..nb-1)
        if t < row_end:
            last = min(end, row_end) - 1
            out.append((bi, bi + t - row_start, bi + last - row_start))
            t = last + 1
        bi, row_start = bi + 1, row_end
    return out
