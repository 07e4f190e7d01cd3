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
