"""The float32 wide triangle body's tile schedule (csrc/wide_tri_sm90.cuh),
on the CPU.

The body sweeps the upper triangle past m = 64 in tiles of
``sym_plan.WIDE_TILE`` = 128 particles a side: persistent blocks, one an SM
(``wide_sym_blocks``), block b taking items b, b + grid, ... of its work
list. The triangles' list is the row-major tile list from t0
(``wide_sym_walk``), each tile decoded to (bi, bj) as the kernel's
``decode_upper_pair`` does (``upper_pair``); the panels' (K3/K5 and
K12/K13 past 64) is the panel list's tile pairs over the plan of
128-particle tiles (``wide_panel_walk``: ``wide_panel_range`` of the
panels swept, ``wide_panel_item``, on the decode that K3's bf16 instance
shares, ``panel_tile_pair``). These tests hold the Python mirrors of both
walks to the triangle: every unordered pair of particles is visited
exactly once, for the whole triangle and for the chunks of worlds 1-8
(``sym_tile_chunk``, within one tile of each other in count; K5's panel
ranges, ``panel_chunk``, whose item ranges cover the list in order), and
the self pairs are pinned on the diagonal tile pairs of the diagonal
panels only.
"""

import pytest

from svgdcpp_tpu_torch.ops import sym_plan

NS = (1, 63, 64, 65, 127, 128, 129, 1000, 10007)


def _pairs_of(n, visited):
    """The particle pairs (i <= j) of the tile pairs ``visited``, counted:
    a diagonal tile's upper triangle with its diagonal, an off-diagonal
    tile whole."""
    side = sym_plan.WIDE_TILE
    total = 0
    for bi, bj in visited:
        rows = min(side, n - bi * side)
        cols = min(side, n - bj * side)
        assert rows > 0 and cols > 0 and bi <= bj
        total += rows * (rows + 1) // 2 if bi == bj else rows * cols
    return total


def _walk(n, t0, count, sms=sym_plan.WIDE_SYM_SMS):
    """Every block's walk over tiles [t0, t0 + count), block by block."""
    out = []
    for block in range(sym_plan.wide_sym_blocks(count, sms)):
        out.extend(sym_plan.wide_sym_walk(n, t0, count, block, sms))
    return out


def _triangle(n):
    nb = -(-n // sym_plan.WIDE_TILE)
    return [(i, j) for i in range(nb) for j in range(i, nb)]


@pytest.mark.parametrize("n", NS)
def test_whole_triangle_visits_each_pair_once(n):
    """One launch over the whole tile list: each tile pair once, so each
    unordered pair of particles (the diagonal included) once."""
    want = _triangle(n)
    seen = _walk(n, 0, len(want))
    assert sorted(seen) == want
    assert len(seen) == len(set(seen))
    assert _pairs_of(n, seen) == n * (n + 1) // 2


@pytest.mark.parametrize("world", range(1, 9))
@pytest.mark.parametrize("n", NS)
def test_chunks_visit_each_pair_once(n, world):
    """The ranks' chunks of the wide tile list (the chunk kernels K4 and
    K10/K11), each walked by its own persistent grid: together each tile
    pair once, and the chunks' tile counts within one of each other."""
    side = sym_plan.sym_tile(123)
    assert side == sym_plan.WIDE_TILE
    seen, counts = [], []
    for rank in range(world):
        t0, count = sym_plan.sym_tile_chunk(n, world, rank, side)
        counts.append(count)
        seen.extend(_walk(n, t0, count))
    assert sorted(seen) == _triangle(n)
    assert len(seen) == len(set(seen))
    assert _pairs_of(n, seen) == n * (n + 1) // 2
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("sms", [1, 3, 132])
def test_walk_order_is_the_kernels(sms):
    """Block b walks t0 + b, t0 + b + grid, ... in that order, the grid
    being min(count, sms): rows of the triangle in row-major order."""
    n, t0, count = 1000, 5, 20
    nb = -(-n // sym_plan.WIDE_TILE)
    grid = sym_plan.wide_sym_blocks(count, sms)
    assert grid == min(count, sms)
    for block in range(grid):
        walk = sym_plan.wide_sym_walk(n, t0, count, block, sms)
        want = [sym_plan.upper_pair(t, nb)
                for t in range(t0 + block, t0 + count, grid)]
        assert walk == want


@pytest.mark.parametrize("nb", [1, 2, 3, 79, 157, 2048, 8192])
def test_upper_pair_decodes_the_row_major_list(nb):
    """The kernels' decode of a linear tile index, at the tile counts of
    n = 128 to 10^6 particles: the row-major order, bi <= bj."""
    pairs = nb * (nb + 1) // 2
    if nb <= 157:
        want = [(i, j) for i in range(nb) for j in range(i, nb)]
        assert [sym_plan.upper_pair(t, nb) for t in range(pairs)] == want
    else:  # the first and last tile of every row
        for i in range(nb):
            first = i * nb - i * (i - 1) // 2
            assert sym_plan.upper_pair(first, nb) == (i, i)
            assert sym_plan.upper_pair(first + nb - 1 - i, nb) == (i, nb - 1)


@pytest.mark.parametrize("m", [65, 100, 123, 124, 256, 512])
def test_triangles_take_the_new_tile_and_the_panels_64(m):
    """Past 64 the float32 triangle families (K2/K4 one RBF, K8-K11 terms)
    take WIDE_TILE = 128, and the panels (K3/K5, K12/K13) run the same
    body: their super-blocks become multiples of 128
    (TILE128_PANEL_ALIGN), the plan the bf16 panels take; up to 64 the
    panels' super-blocks stay multiples of CARD_PANEL_ALIGN = 64."""
    assert sym_plan.WIDE_TILE == 128 == sym_plan.TILE128_PANEL_ALIGN
    assert sym_plan.sym_tile(m) == sym_plan.sym_tile(m, terms=True) == 128
    assert sym_plan.panel_tile128(m) and not sym_plan.panel_tile128(64)
    assert sym_plan.CARD_PANEL_ALIGN == 64
    for n in (4096, 10000, 262144):
        for blocks in (None, 3):
            nb, w, n_pad = sym_plan.card_panel_plan(
                n, blocks, sym_plan.panel_tile128(m))
            assert w % sym_plan.WIDE_TILE == 0 and n_pad == nb * w >= n
            # the bf16 panels' plan (K3's bf16 instance at every m)
            assert sym_plan.panel_tile128(11, bf16=True)
            assert (nb, w, n_pad) == sym_plan.card_panel_plan(
                n, blocks, sym_plan.panel_tile128(11, bf16=True))
            nb, w, n_pad = sym_plan.card_panel_plan(n, blocks)
            assert w % 64 == 0 and n_pad == nb * w >= n
    # (10000, 123)'s plan: 8 super-blocks of 1280.
    assert sym_plan.card_panel_plan(10000, None, True) == (8, 1280, 10240)
    # Up to 64 the narrower bodies keep their own tiles.
    assert sym_plan.sym_tile(11) == sym_plan.MICRO_TILE
    assert sym_plan.sym_tile(64) == 32 and sym_plan.sym_tile(16) == 64


# ----------------------------------------------------------------------
# The panels' walk past 64 (WidePanelWork)
# ----------------------------------------------------------------------


def _panel_pairs_of(n, visited):
    """As _pairs_of, for visited (i0, j0, diag) tile pairs: a diagonal tile
    pair's upper triangle with its diagonal, an off-diagonal one whole;
    diag only where both tiles are the same."""
    side = sym_plan.WIDE_TILE
    total = 0
    for i0, j0, diag in visited:
        assert i0 % side == 0 and j0 % side == 0 and i0 <= j0
        assert diag == (i0 == j0)
        rows, cols = min(side, n - i0), min(side, n - j0)
        assert rows > 0 and cols > 0
        total += rows * (rows + 1) // 2 if diag else rows * cols
    return total


@pytest.mark.parametrize("panel_blocks", [None, 1, 3, 8])
@pytest.mark.parametrize("n", NS)
def test_panel_walk_visits_each_pair_once(n, panel_blocks):
    """Every block's walk over the whole panel list (the K3 and K12/K13
    entries): each tile pair of the triangle once, so each unordered pair
    of particles (the diagonal included) once; the tiles past n are the
    only items left out."""
    for sms in (1, 7, sym_plan.WIDE_SYM_SMS):
        nb, w, _ = sym_plan.card_panel_plan(n, panel_blocks, tile128=True)
        items = sym_plan.wide_panel_range(nb, w, 0, nb * (nb + 1) // 2)[1]
        seen = []
        for block in range(sym_plan.wide_sym_blocks(items, sms)):
            seen.extend(sym_plan.wide_panel_walk(n, block, panel_blocks,
                                                 sms=sms))
        tiles = sorted((i0 // 128, j0 // 128) for i0, j0, _ in seen)
        assert tiles == _triangle(n)
        assert _panel_pairs_of(n, seen) == n * (n + 1) // 2


@pytest.mark.parametrize("world", range(1, 9))
def test_k5_item_ranges_cover_the_list_in_order(world):
    """The item ranges of the ranks' panel chunks (K5's wide entry, panels
    [p0, p0 + count) of panel_chunk) follow one another and together are
    the whole item list, in order; walked, they visit each pair once."""
    for n, panel_blocks in ((1000, None), (10007, 3), (129, 8), (300, 1)):
        nb, w, _ = sym_plan.card_panel_plan(n, panel_blocks, tile128=True)
        num_p = nb * (nb + 1) // 2
        total = sym_plan.wide_panel_range(nb, w, 0, num_p)
        assert total[0] == 0
        tw = w // sym_plan.WIDE_TILE
        assert total[1] == sym_plan.bf16_panel_items(nb, w) == (
            nb * (nb - 1) // 2 * tw * tw + nb * tw * (tw + 1) // 2)
        items, seen = [], []
        for rank in range(world):
            p0, count = sym_plan.panel_chunk(nb, world, rank)
            u0, k = sym_plan.wide_panel_range(nb, w, p0, count)
            items.extend(range(u0, u0 + k))
            for block in range(sym_plan.wide_sym_blocks(k)):
                seen.extend(sym_plan.wide_panel_walk(
                    n, block, panel_blocks, p0, count))
        assert items == list(range(total[1]))
        assert sorted((i0 // 128, j0 // 128) for i0, j0, _ in seen) == \
            _triangle(n)
        assert _panel_pairs_of(n, seen) == n * (n + 1) // 2


@pytest.mark.parametrize("nb,w", [(1, 128), (2, 256), (3, 384), (8, 1280),
                                  (5, 640)])
def test_panel_decode_agrees_with_the_bf16_body(nb, w):
    """The float32 panels' decode (wide_panel_item) and K3's bf16 one
    (bf16_panel_item) give each item the same tile pair: one decoder
    (decode_panel_item) serves both bodies; an item is a diagonal tile pair
    exactly where its panel is diagonal and a == b."""
    pairs = sym_plan.panel_pairs(nb)
    for u in range(sym_plan.bf16_panel_items(nb, w)):
        i0, j0, diag = sym_plan.wide_panel_item(u, nb, w)
        p, bi0, bj0 = sym_plan.bf16_panel_item(u, nb, w)
        assert (i0, j0) == (bi0, bj0)
        bi, bj = pairs[p]
        assert bi * w <= i0 < (bi + 1) * w and bj * w <= j0 < (bj + 1) * w
        assert diag == (bi == bj and i0 == j0)
