"""The bfloat16 triangle body's schedule and wrappers (K2's and K3's bf16
instances on csrc/bf16_tri_sm90.cuh), on the CPU.

* ``sym_plan``'s mirror of the body's walk: persistent blocks, one an SM
  (``wide_sym_blocks``), block b taking the contiguous range ``bf16_range``
  of the work list, K2's the upper triangle's tile pairs of
  ``BF16_TILE`` = 128 (``upper_pair``), K3's the tile pairs of every panel
  of the bf16 plan (``card_panel_plan(..., tile128=True)``, super-blocks a
  multiple of 128; ``bf16_panel_item``), the items with a tile wholly past
  n left out as the body leaves them out: every unordered pair of
  particles (the diagonal included) exactly once at n = 1, 63, 64, 65,
  127, 128, 129, 1000 and 10007, over the default plan and forced
  super-block counts, and the ranges within one item of each other. The
  kernel's cursor steps from item to item; its rule, repeated here, gives
  each item's decode.
* The bf16 plain version of K3 follows the same plan.
* The wrappers on a stand-in library (meta tensors stand in for the card)
  at m = 2, 11, 16, 17, 123 and 256: the operands they hand the new
  entries (float32 rows of m, any alignment; the pack kernel's workspace
  of ``bf16_work_bytes`` bytes, whose rows are multiples of 16 bytes; the
  (2m + 1, n) accumulator [KS | KX | rowsum], K3's too) and K3's plan,
  one launch each.
* The wrappers' epilogue (``ops/phi.bf16_sym_finish``) on the accumulator
  [KS | KX | rowsum] that the body forms, built here in float64 from the
  same rounded operands, against the bf16 plain version.
"""

import numpy as np
import pytest
import torch

from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.ops import phi as pht
from svgdcpp_tpu_torch.ops import sym_plan

NS = (1, 63, 64, 65, 127, 128, 129, 1000, 10007)
BF16 = "bfloat16"


def _pairs_of(n, visited):
    """The particle pairs (i <= j) of the tile pairs ``visited`` (their
    first particles), counted: a diagonal tile's upper triangle with its
    diagonal, an off-diagonal tile whole."""
    side = sym_plan.BF16_TILE
    total = 0
    for i0, j0 in visited:
        rows, cols = min(side, n - i0), min(side, n - j0)
        assert rows > 0 and cols > 0 and i0 <= j0
        total += rows * (rows + 1) // 2 if i0 == j0 else rows * cols
    return total


def _walk(n, panel, panel_blocks=None, sms=sym_plan.WIDE_SYM_SMS):
    if panel:
        nb, w, _ = sym_plan.card_panel_plan(n, panel_blocks, tile128=True)
        items = sym_plan.bf16_panel_items(nb, w)
    else:
        items = sym_plan.bf16_tri_items(n)
    counts, seen = [], []
    for block in range(sym_plan.wide_sym_blocks(items, sms)):
        counts.append(sym_plan.bf16_range(items, block, sms)[1])
        seen.extend(sym_plan.bf16_walk(n, block, panel_blocks, panel, sms))
    return items, counts, seen


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("panel, panel_blocks",
                         [(False, None), (True, None), (True, 1), (True, 3)])
def test_walk_visits_each_pair_once(n, panel, panel_blocks):
    """Every block's contiguous range of K2's or K3's work list: together
    each unordered pair of particles once, the ranges within one item of
    each other and covering the list."""
    items, counts, seen = _walk(n, panel, panel_blocks)
    assert sum(counts) == items
    assert max(counts) - min(counts) <= 1
    assert len(seen) == len(set(seen))
    assert _pairs_of(n, seen) == n * (n + 1) // 2


@pytest.mark.parametrize("sms", [1, 3, 132])
def test_ranges_are_contiguous_and_in_order(sms):
    """Block b's items are [b items / grid, (b + 1) items / grid) in list
    order, the grid min(items, sms)."""
    items = sym_plan.bf16_tri_items(1000)
    grid = sym_plan.wide_sym_blocks(items, sms)
    assert grid == min(items, sms)
    nxt = 0
    for block in range(grid):
        lo, count = sym_plan.bf16_range(items, block, sms)
        assert lo == nxt == items * block // grid
        nxt = lo + count
        nb = -(-1000 // sym_plan.BF16_TILE)
        want = [tuple(sym_plan.BF16_TILE * v for v in sym_plan.upper_pair(u, nb))
                for u in range(lo, lo + count)]
        assert sym_plan.bf16_walk(1000, block, sms=sms) == want
    assert nxt == items


def _advance(c, nb, tw):
    """The kernel's cursor step (Bf16PanelWork::advance) on (bi, bj, a,
    b), with the panel's index in panel_pairs order carried beside it."""
    p, bi, bj, a, b = c
    if bi != bj:
        if b + 1 < tw:
            return p, bi, bj, a, b + 1
        if a + 1 < tw:
            return p, bi, bj, a + 1, 0
        bj += 1
        if bj == nb:
            bi += 1
            bj = bi + 1
            if bj >= nb:
                bi = bj = 0
        return p + 1, bi, bj, 0, 0
    if b + 1 < tw:
        return p, bi, bj, a, b + 1
    if a + 1 < tw:
        return p, bi, bj, a + 1, a + 1
    return p + 1, bi + 1, bi + 1, 0, 0


@pytest.mark.parametrize("nb", [1, 2, 3, 8, 9])
@pytest.mark.parametrize("tw", [1, 2, 3, 10])
def test_cursor_steps_through_the_panel_list(nb, tw):
    """Stepping the cursor from item 0 visits bf16_panel_item(u) for every
    u in order: the panels of panel_pairs(nb), each panel's tile pairs."""
    w = tw * sym_plan.BF16_TILE
    pairs = sym_plan.panel_pairs(nb)

    def decoded(u):
        p, i0, j0 = sym_plan.bf16_panel_item(u, nb, w)
        bi, bj = pairs[p]
        return (p, bi, bj, (i0 - bi * w) // sym_plan.BF16_TILE,
                (j0 - bj * w) // sym_plan.BF16_TILE)

    cur = decoded(0)
    for u in range(1, sym_plan.bf16_panel_items(nb, w)):
        cur = _advance(cur, nb, tw)
        assert cur == decoded(u)


@pytest.mark.parametrize("n", [1, 64, 128, 1000, 4096, 32768, 262144])
@pytest.mark.parametrize("panel_blocks", [None, 1, 5])
def test_bf16_panel_plan_takes_the_tile(n, panel_blocks):
    """The bf16 plan's super-blocks are multiples of BF16_TILE = 128 and
    cover n; the float32 plan up to m = 64 keeps CARD_PANEL_ALIGN = 64."""
    nb, w, n_pad = sym_plan.card_panel_plan(n, panel_blocks, tile128=True)
    assert sym_plan.TILE128_PANEL_ALIGN == sym_plan.BF16_TILE == 128
    assert w % 128 == 0 and n_pad == nb * w >= n
    assert sym_plan.card_panel_plan(n, panel_blocks)[1] % 64 == 0


def test_k3_bf16_plain_version_follows_the_plan(monkeypatch):
    """phi_rbf_sympanel_fused_counts under bf16 sweeps the bf16 plan's
    (nb, w); under float32 the card's float32 plan."""
    plans = []
    real = pht._sympanel_halves

    def spy(coords_c, scores, gammas, signs, thr, nb, w, *args, **kw):
        plans.append((nb, w))
        return real(coords_c, scores, gammas, signs, thr, nb, w, *args, **kw)

    monkeypatch.setattr(pht, "_sympanel_halves", spy)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(500, 3)).astype(np.float32))
    s = torch.from_numpy(rng.normal(size=(500, 3)).astype(np.float32))
    thr = torch.tensor([1.0, 2.0])
    for dd, bf16 in ((BF16, True), ("float32", False)):
        del plans[:]
        pht.phi_rbf_sympanel_fused_counts(x, s, 0.3, thr, panel_blocks=3,
                                          dot_dtype=dd)
        assert plans == [sym_plan.card_panel_plan(500, 3, tile128=bf16)[:2]]
    assert sym_plan.card_panel_plan(500, 3, tile128=True)[1] == 256
    assert sym_plan.card_panel_plan(500, 3)[1] == 192


# ----------------------------------------------------------------------
# The wrappers on a stand-in library
# ----------------------------------------------------------------------


def _stand_in(monkeypatch, calls):
    """A library that records each launch (tests/test_torch_bf16.py's
    stand-in), the card's context managers stood in."""
    from contextlib import nullcontext
    from types import SimpleNamespace

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 0
            return entry

    monkeypatch.setattr(cuda_phi, "_require_cuda", lambda tensor: None)
    monkeypatch.setattr(cuda_phi, "load_library", Library)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("m", [2, 11, 16, 17, 123, 256])
@pytest.mark.parametrize("panel", [False, True])
def test_wrappers_hand_the_entries_their_operands(monkeypatch, m, panel):
    """K2's and K3's bf16 wrappers: float32 rows of m (no padding: the
    pack kernel reads any row), the workspace of bf16_work_bytes(n, m)
    bytes whose three parts start on 16-byte boundaries, the (2m + 1, n)
    accumulator (K3's panels flush into it too) and one launch of their
    own entry with (n, m, T[, nb, w] of the bf16 plan)."""
    n = 3000
    x = torch.empty((n, m), device="meta")
    coords_c, sc32, work, out, plan = cuda_phi._bf16_operands(
        x, x, panel, None)
    for op in (coords_c, sc32):
        assert op.dtype == torch.float32 and op.shape == (n, m)
        assert op.is_contiguous()
    assert work.dtype == torch.uint8
    assert work.numel() == sym_plan.bf16_work_bytes(n, m)
    mk, rw = sym_plan.bf16_gram_width(m), sym_plan.bf16_record_width(m)
    assert mk % 16 == 0 and mk >= m and rw % 8 == 0 and rw >= 2 * m + 1
    q_bytes = -(-4 * n // 16) * 16
    assert work.numel() == q_bytes + 2 * n * (mk + rw)
    assert (2 * n * mk) % 16 == 0  # R starts on a 16-byte boundary too
    assert out.dtype == torch.float32 and out.shape == (2 * m + 1, n)
    if panel:
        nb, w, _ = cuda_phi._panel_plan(n, None, tile128=True)
        assert plan == (nb, w) and w % sym_plan.BF16_TILE == 0
    else:
        assert plan is None

    calls = []
    _stand_in(monkeypatch, calls)
    g, thr = (torch.empty(shape, device="meta") for shape in ((), (3,)))
    cuda_phi.reset_launch_counts()
    cuda_phi.phi_rbf_fused_cuda(x, x, g, thr, sym="panel" if panel else True,
                                dot_dtype=BF16)
    entry = ("svgd_fused_phi_counts_sympanel_bf16" if panel
             else "svgd_fused_phi_counts_sym_bf16")
    assert [c[0] for c in calls] == [entry]
    args = calls[0][1]
    assert args[4:7] == (n, m, 3)
    if panel:
        assert args[7:9] == sym_plan.card_panel_plan(n, tile128=True)[:2]
    kernel = (cuda_phi.SYMPANEL_BF16_KERNEL if panel
              else cuda_phi.SYM_BF16_KERNEL)
    assert cuda_phi.launch_counts[kernel] == 1
    assert sum(cuda_phi.launch_counts.values()) == 1
    cuda_phi.reset_launch_counts()


def _round(a):
    return pht.round_bf16(torch.from_numpy(np.asarray(a))).double()


@pytest.mark.parametrize("m", [2, 17])
def test_epilogue_from_the_bodys_accumulator(m):
    """bf16_sym_finish on [KS | KX | rowsum] as the body forms it (each
    unordered pair once in both directions, the self pair pinned, k and
    the record [S | X | 1] rounded to bf16, float64 sums here) against the
    bf16 plain version: within 1e-5 of max |phi|."""
    n = 300
    rng = np.random.default_rng(100 + m)
    x = (rng.normal(size=(n, m)) + 0.5).astype(np.float32)
    s = rng.normal(size=(n, m)).astype(np.float32)
    g = np.float32(0.5 / m)
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    xc = xt - xt.mean(dim=0)
    q = torch.sum(xc * xc, dim=1).double()
    xr = _round(xc.numpy())
    sq = torch.clamp_min(q[:, None] + q[None, :] - 2.0 * xr @ xr.T, 0.0)
    sq.fill_diagonal_(0.0)
    k = _round(torch.exp2(-(torch.tensor(g) * pht.LOG2E) * sq.float()))
    rec = torch.cat([_round(s), xr, torch.ones((n, 1), dtype=torch.float64)],
                    dim=1)
    upper = torch.triu(k)  # each unordered pair once, the diagonal too
    acc = (upper @ rec + upper.T @ rec).T
    got = pht.bf16_sym_finish(acc, xc.double(), st.double(), float(g), n)
    want = pht.phi_rbf_sym_fused_counts(xt, st, torch.tensor(g),
                                        torch.tensor([1.0]), BF16)[0]
    assert float((got - want.double()).abs().max()
                 / want.double().abs().max()) < 1e-5
