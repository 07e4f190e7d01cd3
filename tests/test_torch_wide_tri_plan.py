"""The float32 wide triangle body's tile schedule (csrc/wide_tri_sm90.cuh),
on the CPU.

The body sweeps the upper triangle past m = 64 in tiles of
``sym_plan.WIDE_TILE`` = 128 particles a side: persistent blocks, one an SM
(``wide_sym_blocks``), block b taking tiles t0 + b, t0 + b + grid, ... of
the row-major tile list (``wide_sym_walk``), each decoded to (bi, bj) as the
kernel's ``decode_upper_pair`` does (``upper_pair``). These tests hold the
Python mirror of that schedule to the triangle: every unordered pair of
particles is visited exactly once, for the whole triangle and for the
chunks of worlds 1-8 (``sym_tile_chunk``, within one tile of each other in
count), and the other wide users (the panels, K14, K15, K2's bf16 instance)
keep their 64-particle tile pairs.
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
    take WIDE_TILE = 128; the panels' super-blocks stay multiples of the
    other wide body's 64-particle tile pair, WIDE_PAIR_TILE."""
    assert sym_plan.WIDE_TILE == 128 and sym_plan.WIDE_PAIR_TILE == 64
    assert sym_plan.sym_tile(m) == sym_plan.sym_tile(m, terms=True) == 128
    assert sym_plan.CARD_PANEL_ALIGN == sym_plan.WIDE_PAIR_TILE
    for n in (4096, 10000, 262144):
        nb, w, n_pad = sym_plan.card_panel_plan(n)
        assert w % sym_plan.WIDE_PAIR_TILE == 0 and n_pad == nb * w >= n
    # Up to 64 the narrower bodies keep their own tiles.
    assert sym_plan.sym_tile(11) == sym_plan.MICRO_TILE
    assert sym_plan.sym_tile(64) == 32 and sym_plan.sym_tile(16) == 64
