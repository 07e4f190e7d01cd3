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

import math
from typing import NamedTuple

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


# ----------------------------------------------------------------------
# The card's form past the register-sized instances
# ----------------------------------------------------------------------

#: The largest m of the kernels' register-sized instances (``kMaxM`` of
#: csrc/sweep_common.cuh); past it every sweep, the panels included, takes
#: its wide instance (the float32 triangles take theirs from m = 9 already,
#: :func:`tri_wide`).
KERNEL_MAX_M = 64


def card_resolve_sym(n: int, m: int, num_terms: int | None = None,
                     bf16: bool = False):
    """The card's automatic form for n particles of dimension m, one RBF
    (``num_terms`` None) or a composed kernel, keyed on the body the
    triangle runs: where it runs the wide body (float32: :func:`tri_wide`,
    every m but 1-8 and 11; ``bf16``, K2's and K3's bfloat16 instances:
    past KERNEL_MAX_M only, the rule those instances had before the
    float32 mid widths moved, since nothing of theirs was timed there) the
    square sweep below SYM_MIN_N and the full-width triangle from there
    up, never "panel" (which a caller may still force); elsewhere the JAX
    package's decision (``jax_resolve_sym``).

    Past KERNEL_MAX_M the triangle is what chip_smoke.py's phase 43b
    measured faster on an H100 80GB HBM3 at 700 W: 3.91-4.00 ms against the
    square sweep's 11.92-12.40 ms at (10000, 123) with one RBF, 5.05-5.35
    against 12.32-12.81 ms at (10000, 124) with two terms (PERF.md). At
    m = 17-64 chip_profile.py --mid-width measured it at 0.51-0.93 ms at
    n = 10,000 against the square form's 0.66-1.81 ms and the panel's
    16.4-16.8 ms (m = 54, 64, where the JAX rule takes the panel for one
    RBF), and at 5.2-9.7 ms at n = 32,768 against the square's 5.2-13.3
    (within 2.4% of it at m = 17, one RBF) and the panel's 28.9-158. At
    m = 9, 12 and 16, past the JAX budget, it took 18.1-19.1 ms at
    n = 65,536 and 71.9-74.6 ms at 131,072 against the JAX rule's panel's
    43.2-46.4 and 165-179 ms; the square form was faster than either
    there (13.8-17.5 and 53.9-68.8 ms), which this rule does not take
    (PERF.md). chip_smoke.py's phase 48e holds the rule to the JAX rule's
    form at (10000, 54), (10000, 55) and (32768, 33). The TPU's
    panel form, and its square form past the budget, exist for its 8 MiB
    VMEM accumulator budget, which the card does not have, so the JAX rule
    is not repeated where the wide body runs."""
    if not (m > KERNEL_MAX_M if bf16 else tri_wide(m)):
        return jax_resolve_sym(n, m, num_terms)
    return n >= SYM_MIN_N


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

#: The CUDA panel kernels' strips at the micro widths (``kPanelAlign`` of
#: csrc/fused_phi_panel.cu): their super-block widths are multiples of it.
CARD_PANEL_ALIGN = 64

#: The panel instances on tiles of 128 (K3's bf16 instance on the bf16
#: triangle body, BF16_TILE; the float32 panels where :func:`tri_wide`
#: holds on the float32 wide triangle body, WIDE_TILE): their plan's
#: super-blocks are multiples of it, so that the panels' tile pairs are
#: the triangle's.
TILE128_PANEL_ALIGN = 128

#: The card's plan: at least this many super-blocks, and super-blocks of
#: at most CARD_PANEL_MAX_W particles (see card_panel_plan).
CARD_PANEL_MIN_BLOCKS = 8
CARD_PANEL_MAX_W = 65536


def card_panel_plan(n: int, panel_blocks: int | None = None,
                    tile128: bool = False):
    """(nb, W, n_pad) of the CUDA panel kernels and their plain versions
    (``tile128``: the instances on the 128-tile bodies, whose W is a
    multiple of TILE128_PANEL_ALIGN, ``panel_tile128``; CARD_PANEL_ALIGN
    otherwise).

    On the card the window lives in device memory, so no budget bounds W.
    At the micro widths one thread block sweeps one strip of super-block
    I (a multiple of 64 rows) against all W columns of super-block J, so
    W is the longest work item: at least CARD_PANEL_MIN_BLOCKS
    super-blocks keep the last blocks' tail short against the whole
    sweep, and W <=
    CARD_PANEL_MAX_W past that. The panel buffer is (nb + 1) * n_pad * 2m
    float32 values, so fewer super-blocks also mean less memory. The
    128-tile bodies walk the panels' tile pairs into one accumulator and
    keep no windows. ``panel_blocks`` forces nb."""
    if panel_blocks is None:
        nb = max(CARD_PANEL_MIN_BLOCKS, -(-n // CARD_PANEL_MAX_W))
    else:
        nb = int(panel_blocks)
        if nb < 1:
            raise ValueError(f"panel_blocks must be >= 1, got {nb}")
    w = ceil_mult(-(-n // nb),
                  TILE128_PANEL_ALIGN if tile128 else CARD_PANEL_ALIGN)
    return nb, w, nb * w


def panel_tile128(m: int, bf16: bool = False) -> bool:
    """Whether the panel sweep at width m runs on a body of 128-particle
    tiles, and so takes ``card_panel_plan(..., tile128=True)``: K3's bf16
    instance at every m, the float32 panels (K3/K5, K12/K13) wherever the
    float32 triangles run the wide body (:func:`tri_wide`: m = 9, 10 and
    12 up; ``panel_wide`` of csrc/sweep_common.cuh, exported by the
    library as ``svgd_panel_tile128``); at m = 1-8 and 11 the float32
    panels run the micro-tile body into per-panel windows."""
    return bf16 or tri_wide(m)


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


#: The wide instance's MM (``kWideMM``): no dimension fixed at compile
#: time, any m past KERNEL_MAX_M.
WIDE_MM = 0


def tri_wide(m: int) -> bool:
    """Whether the float32 triangles (K2/K4, K8-K11) run the wide body
    (csrc/wide_tri_sm90.cuh) at dimension m: every m but the micro-tile
    body's widths, 1-8 and 11 (``tri_wide`` of csrc/sweep_common.cuh)."""
    return m > 8 and m != 11


def dispatch_m(m: int) -> int:
    """The float32 triangles' instance for dimension m
    (``SVGD_DISPATCH_TRI_M`` of csrc/sweep_common.cuh): m itself at the
    micro widths, WIDE_MM where :func:`tri_wide` holds."""
    return WIDE_MM if tri_wide(m) else m


def k15_wide(m: int, bf16: bool = False) -> bool:
    """Whether K15 (the sweep of one RBF with a full, fixed P) takes its
    wide sweep on P itself (``svgd_phi_rbf_wide``, csrc/wide_tri_sm90.cuh's
    body, ``k15_wide`` of csrc/sweep_common.cuh) at dimension m: in float32
    wherever the float32 triangles run the wide body (:func:`tri_wide`),
    elsewhere (m = 1-8 and 11) the micro-tile triangle on the rows of P's
    decomposition; the bfloat16 instance at every m."""
    return bf16 or tri_wide(m)


def aniso_groups_wide(m: int) -> bool:
    """Whether K14's term groups take their wide kernels on
    csrc/wide_tri_sm90.cuh's body (``aniso_groups_wide`` of
    csrc/sweep_common.cuh) at dimension m, the rows padded to
    :func:`wide_row_width`: where :func:`tri_wide` holds; at m = 1-8 and
    11 the groups on csrc/micro_tile.cuh's triangle body
    (``fused_phi_aniso_terms_micro_groups_kernel``), at width m. At every
    m the groups leave the same slabs (``ops/phi.aniso_groups_plain``)."""
    return tri_wide(m)


#: K14's one-pass kernel takes one anisotropic term up to this m
#: (``kOnePassMaxM`` of csrc/sweep_common.cuh; :func:`aniso_one_pass`).
#: chip_profile.py --mid-p timed it against the wide groups for a median
#: RBF + one RBF(P) on an H100 80GB HBM3 at 700 W: at m = 9-16 its MM = 16
#: instance took 6-33% less time at n = 2048, 10,240 and 32,768; at
#: m = 17-32 its MM = 32 instance (spilling 156-216 B) took 2.4-4.5x more
#: at all three, so that instance is gone (PERF.md, section 6).
ONE_PASS_MAX_M = 16


def aniso_one_pass(m: int, n_aniso: int) -> bool:
    """Whether K14 runs its one-pass kernel (``svgd_fused_phi_aniso_terms_
    sym``; ``aniso_one_pass`` of csrc/sweep_common.cuh) for ``n_aniso``
    anisotropic terms at dimension m: one term at the micro widths (m = 1-8
    and 11) and up to ONE_PASS_MAX_M; otherwise the term groups
    (:func:`aniso_groups_wide`)."""
    return n_aniso == 1 and m >= 1 and (not tri_wide(m)
                                        or m <= ONE_PASS_MAX_M)


#: The triangle kernels' tile side where the micro-tile body serves the
#: instance (``MicroWidth`` of csrc/sweep_common.cuh: m = 1-8 and 11), and
#: where the float32 wide body does (``kWideSymTile``, csrc/
#: wide_tri_sm90.cuh: every other m, and the panels' float32 instances
#: past KERNEL_MAX_M), for one RBF (``SymTile``) and a composed kernel
#: (``TermsTriTile``) alike. K2's and K3's bf16 instances take BF16_TILE
#: (csrc/bf16_tri_sm90.cuh, below).
MICRO_TILE = 128
WIDE_TILE = 128

#: The float32 wide triangle body's launch and the bf16 triangle body's:
#: one persistent block an SM (the H100's 132), never more blocks than
#: tile pairs.
WIDE_SYM_SMS = 132

#: The float32 wide triangle body copies 16 bytes at a time: its wrappers
#: hand it rows of a multiple of this many floats.
WIDE_ROW_ALIGN = 4


def wide_row_width(m: int) -> int:
    """The row width the float32 wide bodies take for dimension m: m
    rounded up to WIDE_ROW_ALIGN (the coordinates and scores padded with
    zero columns, which add nothing to sq, KS or D, so that every row
    starts on a 16-byte boundary). Each wrapper pads only where its own
    instance is the wide body: the triangles where :func:`tri_wide` holds,
    K14's groups (:func:`aniso_groups_wide`), K15's float32 sweep
    (:func:`k15_wide`), the panels (:func:`panel_tile128`) and the square
    sweeps past KERNEL_MAX_M."""
    return -(-m // WIDE_ROW_ALIGN) * WIDE_ROW_ALIGN


def upper_pair(t: int, nb: int):
    """(bi, bj), bi <= bj, of tile t of the nb-wide upper triangle's
    row-major tile list: the kernels' ``decode_upper_pair`` (a float
    estimate of the row, corrected by integer steps)."""
    b = 2.0 * nb + 1.0
    i = int(math.floor((b - math.sqrt(b * b - 8.0 * t)) * 0.5))
    i = min(max(i, 0), nb - 1)

    def off(r):
        return r * nb - r * (r - 1) // 2

    while i > 0 and off(i) > t:
        i -= 1
    while i + 1 < nb and off(i + 1) <= t:
        i += 1
    return i, i + (t - off(i))


def wide_sym_blocks(count: int, sms: int = WIDE_SYM_SMS) -> int:
    """The grid of the float32 wide triangle body over ``count`` tile
    pairs (``wide_sym_prepare``): one block an SM, at most one a pair."""
    return min(count, sms)


def wide_sym_walk(n: int, t0: int, count: int, block: int,
                  sms: int = WIDE_SYM_SMS):
    """The tile pairs (bi, bj) that block ``block`` of the float32 wide
    triangle body visits, in order, over tiles [t0, t0 + count) of the
    WIDE_TILE-sided tile list of n particles: t0 + block, then every
    ``wide_sym_blocks(count)``-th tile after it (``wide_tri_sm90_body``
    with ``WideTriWork``)."""
    nb = -(-n // WIDE_TILE)
    step = wide_sym_blocks(count, sms)
    return [upper_pair(t0 + p, nb) for p in range(block, count, step)]


# ----------------------------------------------------------------------
# The panel list's tile pairs on the 128-tile bodies: the float32 panels
# past KERNEL_MAX_M (csrc/wide_tri_sm90.cuh, ``WidePanelWork``) and K3's
# bf16 instance (csrc/bf16_tri_sm90.cuh, ``Bf16PanelWork``)
# ----------------------------------------------------------------------


def panel_first_item(p: int, nb: int, tw: int) -> int:
    """The first item of panel p of the panel list's tile pairs over nb
    super-blocks of tw tiles (``panel_first_item`` of
    csrc/sweep_common.cuh): tw^2 items an off-diagonal panel, tw (tw + 1)
    / 2 a diagonal one; p = nb (nb + 1) / 2 gives the list's length."""
    n_off = nb * (nb - 1) // 2
    if p <= n_off:
        return p * tw * tw
    return n_off * tw * tw + (p - n_off) * tw * (tw + 1) // 2


def panel_tile_pair(u: int, nb: int, tw: int):
    """(panel, bi, bj, a, b) of item u of that list (``decode_panel_item``):
    the panels in panel_pairs(nb) order, an off-diagonal panel's tile pairs
    (a, b) row-major, a diagonal one's a <= b in the triangle's order;
    (bi, bj) the panel's super-blocks."""
    off_items = panel_first_item(nb * (nb - 1) // 2, nb, tw)
    if u < off_items:
        p, x = divmod(u, tw * tw)
        a, b = divmod(x, tw)
        bi, bj = upper_pair(p, nb - 1)
        return p, bi, bj + 1, a, b
    d, x = divmod(u - off_items, tw * (tw + 1) // 2)
    a, b = upper_pair(x, tw)
    return nb * (nb - 1) // 2 + d, d, d, a, b


def wide_panel_item(u: int, nb: int, w: int):
    """(i0, j0, diag) of the float32 wide panels' item u over nb
    super-blocks of w particles (``WidePanelWork::at``): the first
    particles of its tiles, (bi tw + a) and (bj tw + b) tiles of WIDE_TILE
    in, and whether it is a diagonal tile pair (a diagonal panel's
    a == b)."""
    tw = w // WIDE_TILE
    _, bi, bj, a, b = panel_tile_pair(u, nb, tw)
    return ((bi * tw + a) * WIDE_TILE, (bj * tw + b) * WIDE_TILE,
            bi == bj and a == b)


def wide_panel_range(nb: int, w: int, p0: int, count: int):
    """(u0, items): the items of panels [p0, p0 + count) of the list, the
    work of the float32 wide panel entries (``wide_panel_work`` of
    csrc/fused_phi_panel.cu; the whole list, or K5's chunk of a rank)."""
    tw = w // WIDE_TILE
    u0 = panel_first_item(p0, nb, tw)
    return u0, panel_first_item(p0 + count, nb, tw) - u0


def wide_panel_walk(n: int, block: int, panel_blocks=None, p0: int = 0,
                    count: int | None = None, sms: int = WIDE_SYM_SMS):
    """The tile pairs (i0, j0, diag) that block ``block`` of the float32
    wide body visits, in order, over the panels [p0, p0 + count) (all of
    them by default) of ``card_panel_plan(n, panel_blocks, tile128=True)``:
    items u0 + block, then every ``wide_sym_blocks(items)``-th after it
    (``wide_tri_sm90_body`` with ``WidePanelWork``), leaving out the items
    with a tile wholly past n, which the body skips."""
    nb, w, _ = card_panel_plan(n, panel_blocks, tile128=True)
    if count is None:
        count = nb * (nb + 1) // 2 - p0
    u0, items = wide_panel_range(nb, w, p0, count)
    out = []
    for u in range(block, items, wide_sym_blocks(items, sms)):
        i0, j0, diag = wide_panel_item(u0 + u, nb, w)
        if i0 < n and j0 < n:
            out.append((i0, j0, diag))
    return out


# ----------------------------------------------------------------------
# The bfloat16 triangle body (csrc/bf16_tri_sm90.cuh): K2's and K3's
# bf16 instances
# ----------------------------------------------------------------------

#: Its tile pairs' side (``kBf16Tile``).
BF16_TILE = 128


def bf16_gram_width(m: int) -> int:
    """The packed Gram operand's row: m bf16 padded to a k16 step."""
    return 16 * -(-m // 16)


def bf16_record_width(m: int) -> int:
    """The packed record's row [S | X | 1 | 0...]: 2m + 1 bf16 padded
    to an n8 tile."""
    return 8 * -(-(2 * m + 1) // 8)


def bf16_work_bytes(n: int, m: int, gram_y: bool = False) -> int:
    """The bytes of the workspace the bf16 entries' pack kernel fills
    (``Bf16Operands``): q (n float32, to a 16-byte boundary), then X (n x
    bf16_gram_width(m)) and R (n x bf16_record_width(m)) in bf16, and with
    ``gram_y`` (K15's instance) Y (n x bf16_gram_width(m)) after R."""
    return sum(size for _, size in bf16_work_layout(n, m, gram_y))


def bf16_work_layout(n: int, m: int, gram_y: bool = False):
    """The workspace's blocks in order, each (name, bytes): "q", "x",
    "rec" and, with ``gram_y``, "y" (bf16_work_bytes)."""
    blocks = [("q", -(-4 * n // 16) * 16), ("x", 2 * n * bf16_gram_width(m)),
              ("rec", 2 * n * bf16_record_width(m))]
    if gram_y:
        blocks.append(("y", 2 * n * bf16_gram_width(m)))
    return blocks


def bf16_tri_items(n: int) -> int:
    """K2's bf16 work items: the tile pairs of the upper triangle of
    ceil(n / BF16_TILE) tiles."""
    nb = -(-n // BF16_TILE)
    return nb * (nb + 1) // 2


def bf16_panel_items(nb: int, w: int) -> int:
    """K3's bf16 work items over nb super-blocks of w: tw^2 tile pairs a
    panel off the diagonal, tw (tw + 1) / 2 on it (tw = w / BF16_TILE)."""
    return panel_first_item(nb * (nb + 1) // 2, nb, w // BF16_TILE)


def bf16_panel_item(u: int, nb: int, w: int):
    """(panel, i0, j0) of K3's bf16 work item u (``Bf16PanelWork``, on
    ``panel_tile_pair``); i0 and j0 the first particles of the pair's
    tiles."""
    p, bi, bj, a, b = panel_tile_pair(u, nb, w // BF16_TILE)
    return p, bi * w + a * BF16_TILE, bj * w + b * BF16_TILE


def bf16_range(items: int, block: int, sms: int = WIDE_SYM_SMS):
    """(first, count) of block ``block``'s contiguous share of ``items``
    work items on the bf16 triangle body's grid, ``wide_sym_blocks(items,
    sms)`` blocks: [b items / grid, (b + 1) items / grid)."""
    grid = wide_sym_blocks(items, sms)
    lo = items * block // grid
    return lo, items * (block + 1) // grid - lo


def bf16_walk(n: int, block: int, panel_blocks=None, panel: bool = False,
              sms: int = WIDE_SYM_SMS):
    """The tile pairs (i0, j0), i0 <= j0 their first particles, that
    block ``block`` of the bf16 triangle body visits, in order: its
    contiguous range (``bf16_range``) of K2's list (the upper triangle's
    tile pairs, ``upper_pair``) or, with ``panel``, of K3's over
    ``card_panel_plan(n, panel_blocks, tile128=True)`` (``bf16_panel_item``),
    leaving out the items with a tile wholly past n, which the body
    skips."""
    if panel:
        nb, w, _ = card_panel_plan(n, panel_blocks, tile128=True)
        items = bf16_panel_items(nb, w)

        def spot(u):
            return bf16_panel_item(u, nb, w)[1:]
    else:
        nb = -(-n // BF16_TILE)
        items = bf16_tri_items(n)

        def spot(u):
            bi, bj = upper_pair(u, nb)
            return bi * BF16_TILE, bj * BF16_TILE
    lo, count = bf16_range(items, block, sms)
    out = []
    for u in range(lo, lo + count):
        i0, j0 = spot(u)
        if i0 < n and j0 < n:
            out.append((i0, j0))
    return out


def sym_tile(m: int, terms: bool = False) -> int:
    """The side of the full-width triangle kernels' tiles for dimension m,
    one RBF (``SymTile``) or a composed kernel (``terms``,
    ``TermsTriTile``), from the instance that serves m (:func:`dispatch_m`):
    MICRO_TILE where the micro-tile body serves it (m = 1-8 and 11), the
    float32 wide body's WIDE_TILE at every other m. The chunk wrappers on
    the card take the library's own answer (``svgd_sym_tile``); this copy
    serves the plain chunk sweeps, and the card's smoke test holds it to
    the library's at m = 1-64."""
    return WIDE_TILE if tri_wide(m) else MICRO_TILE


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
#: The SMs whose waves the wide and bf16 square bodies' split rule fills
#: (``kSquareWaveSms``).
SQUARE_WAVE_SMS = 132


def square_tensor(m: int, bf16: bool = False) -> bool:
    """Whether the square sweep at width m runs a tensor-core body (from
    SQUARE_TENSOR_MIN_M up, and K1's bf16 instance at every m) rather than
    the CUDA-core one."""
    return bf16 or m >= SQUARE_TENSOR_MIN_M


def square_chunk(n_t: int, n_s: int, m: int, bf16: bool = False) -> int:
    """The sources of one split of a square launch: whole tiles of
    SQUARE_GRAIN, as few as keep about SQUARE_BLOCKS blocks on the card
    (``square_chunk`` of csrc/square_mma.cuh); past KERNEL_MAX_M the
    float32 wide body's rule (:func:`square_wide_chunk`); K1's bf16
    instance its own body's at every m (:func:`square_bf16_chunk`)."""
    if bf16:
        return square_bf16_chunk(n_t, n_s, m)
    if m > KERNEL_MAX_M:
        return square_wide_chunk(n_t, n_s, m)
    rows = (SQUARE_ROWS_TENSOR if square_tensor(m, bf16)
            else SQUARE_ROWS_CUDA_CORES)
    row_blocks = -(-n_t // rows)
    grains = -(-n_s // SQUARE_GRAIN)
    parts = min(grains, -(-SQUARE_BLOCKS // row_blocks))
    return SQUARE_GRAIN * -(-grains // parts)


def square_splits(n_t: int, n_s: int, m: int, bf16: bool = False) -> int:
    """The number of source splits (the grid's y, the workspace's first
    dimension) of a square launch, K1's or the terms kernel's, or -1 for
    arguments the sweeps do not take: the Python copy of the library's
    ``svgd_square_splits`` (``bf16``: ``svgd_square_bf16_splits``, K1's
    bf16 instance), which the wrapper reads on the card and the card's
    smoke test holds this copy to. Past KERNEL_MAX_M the float32 wide
    body's plan (:func:`square_wide_chunk`, at the padded row width); the
    bf16 instance its own body's at every m (:func:`square_bf16_chunk`)."""
    if n_t <= 0 or n_s <= 0 or m < 1:
        return -1
    return -(-n_s // square_chunk(n_t, n_s, m, bf16))


# ----------------------------------------------------------------------
# The float32 wide square body (csrc/square_wide_sm90.cuh): K1 and the
# terms square kernel (K6/K7's port) past KERNEL_MAX_M
# ----------------------------------------------------------------------

#: Its sources a tile (the split grain, ``kSqWideTile``), its ring's stages
#: (``kSqWideStages``), its Gram slices' and weight tiles' strides
#: (``kSqWideSliceLd``, ``kSqWideWLd``), its accumulator blocks a warp
#: (``kSqWideAcc``) and its warps (``kSqWideWarps``).
SQUARE_WIDE_TILE = 64
SQUARE_WIDE_STAGES = 4
SQUARE_WIDE_SLICE_LD = 68
SQUARE_WIDE_W_LD = 68
SQUARE_WIDE_ACC = 8
SQUARE_WIDE_WARPS = 16


class SquareWidePlan(NamedTuple):
    """The float32 wide square body's layout at row width ``width``
    (``sq_wide_plan``): the coordinates' first record column ``xo`` (the
    record [S | 0.. | X | 0..]), its 8-column blocks ``blocks``, the target
    rows a block ``rows``, the blocks a pass ``cap`` and the passes along
    the grid's z, whether the target rows stream with the Gram slices
    (``streamed``: past one pass) and the dynamic shared memory in bytes
    with one weight tile (``smem``) or two (``smem_terms``)."""
    width: int
    xo: int
    blocks: int
    rows: int
    cap: int
    passes: int
    streamed: bool
    smem: int
    smem_terms: int


def square_wide_plan(m: int) -> SquareWidePlan:
    """The float32 wide square body's layout for dimension m (its row
    width ``wide_row_width(m)``): 64 target rows a block up to 32 column
    blocks of the record, 32 up to 64, 16 above, every column's
    accumulator in registers over the block's source range, in one pass up
    to 128 blocks (m <= 512)."""
    w = -(-m // WIDE_ROW_ALIGN) * WIDE_ROW_ALIGN
    xo = 8 * -(-w // 8)
    blocks = -(-(xo + w) // 8)
    rows = 64 if blocks <= 32 else 32 if blocks <= 64 else 16
    cap = SQUARE_WIDE_WARPS * SQUARE_WIDE_ACC * 16 // rows
    passes = -(-blocks // cap)
    streamed = passes > 1
    cols = 8 * min(cap, blocks)
    slab = 16 if cols <= 256 else 8
    ldr = 16 * -(-cols // 16) + 8
    lt = xo + (4 - xo) % 32
    stage = max((SQUARE_WIDE_TILE + (rows if streamed else 0))
                * SQUARE_WIDE_SLICE_LD, slab * ldr)
    # Floats: the ring, the resident targets, the row sums' 256 partials
    # and the kMaxT = 8 thresholds; then a weight tile each; bytes: each
    # warp's 8 64-bit counts.
    base = (SQUARE_WIDE_STAGES * stage + (0 if streamed else rows * lt)
            + 256 + 8)
    tile = rows * SQUARE_WIDE_W_LD
    counts = 8 * SQUARE_WIDE_WARPS * 8
    return SquareWidePlan(w, xo, blocks, rows, cap, passes, streamed,
                          4 * (base + tile) + counts,
                          4 * (base + 2 * tile) + counts)


def square_wave_tiles(blocks: int, tiles: int, bps: int) -> int:
    """The tiles one split of a wide or bf16 square launch sweeps
    (``square_wave_tiles`` of csrc/square_mma.cuh): of ``tiles`` source
    tiles, the count that minimises the waves of bps x SQUARE_WAVE_SMS
    blocks (``blocks`` a split: target blocks x passes; ``bps`` blocks an
    SM) times the tiles an SM's blocks sweep plus one each, the fewest
    splits among equals."""
    slots = SQUARE_WAVE_SMS * bps
    best = None
    for s in range(1, min(tiles, SQUARE_WAVE_SMS) + 1):
        per = -(-tiles // s)
        splits = -(-tiles // per)
        if splits != s:
            continue
        est = -(-blocks * splits // slots) * bps * (per + 1)
        if best is None or est < best[0]:
            best = (est, per)
    return best[1]


def square_wide_chunk(n_t: int, n_s: int, m: int) -> int:
    """The sources of one split of the float32 wide square launch
    (``sq_wide_chunk``): whole tiles of SQUARE_WIDE_TILE, by
    :func:`square_wave_tiles` over target blocks x passes, one block an
    SM."""
    plan = square_wide_plan(m)
    row_blocks = -(-n_t // plan.rows)
    tiles = -(-n_s // SQUARE_WIDE_TILE)
    return SQUARE_WIDE_TILE * square_wave_tiles(row_blocks * plan.passes,
                                                tiles, 1)


# ----------------------------------------------------------------------
# K1's bfloat16 body (csrc/square_bf16_sm90.cuh): the square and cross
# forms of K1's bf16 instance at every m
# ----------------------------------------------------------------------

#: Its target rows a block (``kSqBf16Rows``), sources a tile (the split
#: grain, ``kSqBf16Tile``), coordinates a Gram slice (``kSqBf16Slice``) and
#: the stride of a slice's rows past 4 floats (``kSqBf16SliceLd``), most n8
#: tiles a record chunk (``kSqBf16ChunkTiles``), ring stages
#: (``kSqBf16Stages``) and most resident target slices
#: (``kSqBf16ResidentSlices``).
SQUARE_BF16_ROWS = 128
SQUARE_BF16_TILE = 64
SQUARE_BF16_SLICE = 32
SQUARE_BF16_SLICE_LD = 36
SQUARE_BF16_CHUNK_TILES = 16
SQUARE_BF16_STAGES = 4
SQUARE_BF16_RESIDENT_SLICES = 4


class SquareBf16Plan(NamedTuple):
    """K1's bf16 body's layout for dimension m (``sq_bf16_plan``): the Gram
    slices of 32 coordinates ``slices``, the accumulator n8 tiles of the
    instance that serves m ``tiles`` (2, 4, 8 or 16), the record chunks
    along the grid's z ``chunks`` (16 tiles each), the blocks an SM holds
    (``blocks_per_sm``: two at 2 tiles, else one), whether the block's
    target rows stay resident in shared memory (``resident``: up to
    SQUARE_BF16_RESIDENT_SLICES slices, else they stream with each slice),
    and the bytes of a ring stage (``stage``) and of the dynamic shared
    memory (``smem``)."""
    slices: int
    tiles: int
    chunks: int
    blocks_per_sm: int
    resident: bool
    stage: int
    smem: int


def square_bf16_row_width(m: int) -> int:
    """The rounded coordinates' rows K1's bf16 entry takes: m floats padded
    with zeros to a multiple of 4 (``sq_bf16_row_width``)."""
    return 4 * -(-m // 4)


def square_bf16_plan(m: int) -> SquareBf16Plan:
    """K1's bf16 body's layout for dimension m: a stage holds the 64
    sources' Gram slice (rows of SQUARE_BF16_SLICE_LD floats, or 4 when the
    rows are 4 floats wide), the last slice's stage also their record chunk
    (``tiles`` n8 tiles of bf16 a row) and norms, and past the resident
    slices the 128 target rows' slice; the resident target slices follow
    the ring."""
    wq = square_bf16_row_width(m)
    slices = -(-wq // SQUARE_BF16_SLICE)
    ld = 4 if wq == 4 else SQUARE_BF16_SLICE_LD
    n8 = bf16_record_width(m) // 8
    chunks = -(-n8 // SQUARE_BF16_CHUNK_TILES)
    tiles = 2
    while tiles < min(n8, SQUARE_BF16_CHUNK_TILES):
        tiles *= 2
    resident = slices <= SQUARE_BF16_RESIDENT_SLICES
    target_slot = SQUARE_BF16_ROWS * ld * 4
    stage = (SQUARE_BF16_TILE * (4 * ld + 16 * tiles) + 4 * SQUARE_BF16_TILE
             + (0 if resident else target_slot))
    smem = SQUARE_BF16_STAGES * stage + (slices * target_slot if resident
                                         else 0)
    return SquareBf16Plan(slices, tiles, chunks, 2 if tiles <= 2 else 1,
                          resident, stage, smem)


def square_bf16_chunk(n_t: int, n_s: int, m: int) -> int:
    """The sources of one split of K1's bf16 launch (``sq_bf16_chunk``):
    whole tiles of SQUARE_BF16_TILE, by :func:`square_wave_tiles` over
    target blocks of SQUARE_BF16_ROWS x record chunks, ``blocks_per_sm``
    blocks an SM."""
    plan = square_bf16_plan(m)
    row_blocks = -(-n_t // SQUARE_BF16_ROWS)
    tiles = -(-n_s // SQUARE_BF16_TILE)
    return SQUARE_BF16_TILE * square_wave_tiles(
        row_blocks * plan.chunks, tiles, plan.blocks_per_sm)


class SquareBf16Work(NamedTuple):
    """K1's bf16 workspace (``sq_bf16_work``), in 16-byte-aligned segments:
    the splits' float32 partials (splits, n_t, 2m + 1) from byte 0, the
    sources' rounded rows (n_s, ``square_bf16_row_width(m)``) float32 at
    ``x_s``, the targets' at ``x_t`` (``x_s`` in the square form), the
    sources' bf16 record (n_s, ``bf16_record_width(m)``) at ``rec``; the
    whole's ``bytes``."""
    x_s: int
    x_t: int
    rec: int
    bytes: int


def square_bf16_work(n_t: int, n_s: int, m: int, square: bool,
                     splits: int | None = None) -> SquareBf16Work:
    """K1's bf16 workspace for ``splits`` (by default the plan's,
    ``square_splits(n_t, n_s, m, bf16=True)``)."""
    if splits is None:
        splits = square_splits(n_t, n_s, m, bf16=True)

    def up(b):
        return -(-b // 16) * 16

    wq = square_bf16_row_width(m)
    x_s = up(4 * splits * n_t * (2 * m + 1))
    at = x_s + up(4 * n_s * wq)
    x_t = x_s if square else at
    if not square:
        at += up(4 * n_t * wq)
    return SquareBf16Work(x_s, x_t, at, at + up(2 * n_s * bf16_record_width(m)))


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
