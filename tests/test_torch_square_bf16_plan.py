"""K1's bfloat16 body (csrc/square_bf16_sm90.cuh: the square and cross forms
of K1's bf16 instance) and its wrappers, on the CPU.

* ``sym_plan``'s mirror of the body's plan (``sq_bf16_plan``,
  ``sq_bf16_chunk``): the split counts pinned at (1000, 1000),
  (10000, 10000) and (5000, 10000) for m = 1, 2, 16, 17, 50, 64, 65, 123
  and 512 (SPLIT_PINS), the accumulator tiles of the instance that serves
  m, the record chunks along the grid's z and the blocks an SM
  (LAYOUT_PINS).
* The launch's grid at n = 1, 33, 64, 1000 and 10007 (square and cross):
  every source in exactly one split, every target row in one block, every
  record column in one chunk.
* Shared memory within the 227 KB a block may take (two blocks an SM
  within the SM's 228 KB where the instance runs two) at m = 1-2000.
* The plain version of the operands the pack kernel prepares
  (``cuda_phi.square_bf16_operands``): the plain version's norms bit for
  bit, the rows rounded to bf16 and padded, the bf16 record.
* The workspace's layout (``sym_plan.square_bf16_work``): the partials,
  the rounded rows and the record in disjoint 16-byte-aligned segments,
  read back by ``cuda_phi.square_bf16_views``.
* The wrappers on a stand-in library: the square and cross forms hand the
  pack and then the entry centred float32 operands (one set for targets
  and sources in the square form), one workspace of the mirrored bytes
  and the plan's split count, launch ``svgd_square_bf16_pack`` and
  ``svgd_fused_phi_counts_square_bf16`` once each, counted once, never
  the float32 entry.
* The plan's partials: the body's arithmetic on the bf16-rounded operands
  in float64, block by block and chunk by chunk, the splits summed in
  order by the finishing pass's formula, against the bf16 plain version.

A few seconds in one process.
"""

from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.ops import phi as pht
from svgdcpp_tpu_torch.ops import sym_plan

BF16 = "bfloat16"
MS = (1, 2, 16, 17, 50, 64, 65, 123, 512)
NS = (1, 33, 64, 1000, 10007)
#: The split counts at (1000, 1000), (10000, 10000) and (5000, 10000).
SPLIT_PINS = {
    1: (16, 10, 6), 2: (16, 10, 6), 16: (16, 5, 3), 17: (16, 5, 3),
    50: (16, 5, 3), 64: (8, 5, 8), 65: (8, 5, 8), 123: (8, 5, 8),
    512: (3, 2, 4),
}
#: (accumulator n8 tiles of the instance, record chunks, blocks an SM,
#: Gram slices of 32 coordinates, target rows resident).
LAYOUT_PINS = {
    1: (2, 1, 2, 1, True), 2: (2, 1, 2, 1, True), 16: (8, 1, 1, 1, True),
    17: (8, 1, 1, 1, True), 50: (16, 1, 1, 2, True),
    64: (16, 2, 1, 2, True), 65: (16, 2, 1, 3, True),
    123: (16, 2, 1, 4, True), 512: (16, 9, 1, 16, False),
}
#: The shared memory one block may take, and an SM's (a block also takes
#: 1 KB of the SM's for itself).
BLOCK_SMEM = 232448
SM_SMEM = 233472


@pytest.mark.parametrize("m", MS)
def test_plan_pinned(m):
    """The split rule and the layout, as csrc/square_bf16_sm90.cuh's
    sq_bf16_chunk and sq_bf16_plan compute them (chip_smoke.py phase 43d
    holds this copy to the library's)."""
    got = tuple(sym_plan.square_splits(n_t, n_s, m, bf16=True)
                for n_t, n_s in ((1000, 1000), (10000, 10000), (5000, 10000)))
    assert got == SPLIT_PINS[m]
    plan = sym_plan.square_bf16_plan(m)
    assert (plan.tiles, plan.chunks, plan.blocks_per_sm, plan.slices,
            plan.resident) == LAYOUT_PINS[m]
    # The instance's tiles hold one chunk of the record [S | X | 1 | 0..]:
    # all of it in one chunk up to 16 n8 tiles, else chunks of 16.
    n8 = sym_plan.bf16_record_width(m) // 8
    assert plan.chunks == -(-n8 // 16)
    assert plan.tiles >= min(n8, 16) and plan.tiles // 2 < max(n8, 2)


def _grid(n_t, n_s, m):
    """The launch's blocks (row0, rows, j0, j_end, c0, cols) as the entry
    and the body derive them."""
    plan = sym_plan.square_bf16_plan(m)
    chunk = sym_plan.square_bf16_chunk(n_t, n_s, m)
    splits = sym_plan.square_splits(n_t, n_s, m, bf16=True)
    assert chunk % sym_plan.SQUARE_BF16_TILE == 0
    assert splits == -(-n_s // chunk)
    width = 2 * m + 1
    out = []
    for bx in range(-(-n_t // sym_plan.SQUARE_BF16_ROWS)):
        r0 = bx * sym_plan.SQUARE_BF16_ROWS
        for by in range(splits):
            j0, j1 = by * chunk, min(n_s, (by + 1) * chunk)
            for bz in range(plan.chunks):
                c0 = 8 * plan.tiles * bz
                out.append((r0, min(sym_plan.SQUARE_BF16_ROWS, n_t - r0),
                            j0, j1, c0, min(8 * plan.tiles, width - c0)))
    return out


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("m", [2, 17, 65, 512])
@pytest.mark.parametrize("cross", [False, True])
def test_grid_covers_each_pair_and_column_once(n, m, cross):
    """Every (target, source, record column) once: the row blocks cover the
    targets, the splits the sources (each a non-empty run of whole tiles),
    the chunks the 2m + 1 columns."""
    n_t = max(1, n // 3) if cross else n
    blocks = _grid(n_t, n, m)
    seen = np.zeros((n_t, n, 2 * m + 1), dtype=np.int8) if n <= 64 else None
    rows, srcs, cols = set(), set(), set()
    for r0, nr, j0, j1, c0, nc in blocks:
        assert nr > 0 and j1 > j0 and nc > 0
        rows.add((r0, r0 + nr))
        srcs.add((j0, j1))
        cols.add((c0, c0 + nc))
        if seen is not None:
            seen[r0:r0 + nr, j0:j1, c0:c0 + nc] += 1
    for runs, total in ((rows, n_t), (srcs, n), (cols, 2 * m + 1)):
        spans = sorted(runs)  # (start, end): contiguous from 0 to the total
        assert [a for a, _ in spans] == [0] + [b for _, b in spans[:-1]]
        assert spans[-1][1] == total
    if seen is not None:
        assert (seen == 1).all()


def test_shared_memory_fits_at_every_width():
    """Each width's block within the 227 KB a block may take, and the two
    blocks of an SM within its 228 KB where the instance runs two."""
    for m in range(1, 2001):
        plan = sym_plan.square_bf16_plan(m)
        assert plan.smem <= BLOCK_SMEM, m
        assert plan.blocks_per_sm * (plan.smem + 1024) <= SM_SMEM, m
        assert plan.stage % 16 == 0 and plan.smem % 16 == 0


@pytest.mark.parametrize("n_t, n_s, m", [(130, 300, 50), (40, 70, 2),
                                         (33, 1, 123)])
@pytest.mark.parametrize("square", [False, True])
def test_entry_operands(n_t, n_s, m, square):
    """The operands the wrappers prepare (cuda_phi.square_bf16_operands): q
    the plain version's own torch.sum of the squared centred rows, bit for
    bit; the rows rounded to bf16 (to nearest, ties to even) as float32,
    padded with zeros to square_bf16_row_width(m), a multiple of 4 floats;
    the record [S | X | 1 | 0...] in bf16 of bf16_record_width(m); in the
    square form the targets' are the sources'."""
    rng = np.random.default_rng(80 + m)
    src = torch.from_numpy(rng.normal(size=(n_s, m)).astype(np.float32))
    tgt = src if square else torch.from_numpy(
        rng.normal(size=(n_t, m)).astype(np.float32))
    sc = torch.from_numpy(rng.normal(size=(n_s, m)).astype(np.float32))
    q_t, x_t, q_s, x_s, rec = cuda_phi.square_bf16_operands(tgt, src, sc,
                                                            square)
    width = sym_plan.square_bf16_row_width(m)
    assert width % 4 == 0 and m <= width < m + 4
    for q, x, c in ((q_t, x_t, tgt), (q_s, x_s, src)):
        assert torch.equal(q, torch.sum(c * c, dim=1))
        assert x.shape == (c.shape[0], width) and x.is_contiguous()
        assert x.dtype == torch.float32
        assert torch.equal(x[:, :m], pht.round_bf16(c))
        assert not x[:, m:].any()
    assert (q_t is q_s and x_t is x_s) is square
    rw = sym_plan.bf16_record_width(m)
    assert rec.dtype == torch.bfloat16 and rec.shape == (n_s, rw)
    want = torch.cat([sc, src, torch.ones(n_s, 1)], dim=1).to(torch.bfloat16)
    assert torch.equal(rec[:, :2 * m + 1], want)
    assert not rec[:, 2 * m + 1:].float().any()


def _stand_in(monkeypatch, calls, spied):
    """A library that records each launch and answers the split count and
    the workspace's bytes with sym_plan's copies; the card's context
    managers stood in; the bf16 launcher's operands and the workspace (the
    one uint8 allocation) recorded."""

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                if name == "svgd_square_bf16_splits":
                    return sym_plan.square_splits(*args, bf16=True)
                if name == "svgd_square_bf16_work_bytes":
                    return sym_plan.square_bf16_work(*args[:3],
                                                     bool(args[3])).bytes
                return 0
            return entry

    launch = cuda_phi._square_bf16_launch
    empty = torch.empty

    def spy(tgt_c, src_c, sc32, g, thr, square, dtype):
        spied.update(tgt=tgt_c, src=src_c, scores=sc32, square=square)
        return launch(tgt_c, src_c, sc32, g, thr, square, dtype)

    def recording_empty(*args, **kw):
        out = empty(*args, **kw)
        if out.dtype == torch.uint8:  # the workspace
            spied["work"] = out
        return out

    monkeypatch.setattr(cuda_phi, "_square_bf16_launch", spy)
    monkeypatch.setattr(cuda_phi.torch, "empty", recording_empty)
    monkeypatch.setattr(cuda_phi, "load_library", Library)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("m", [2, 17, 123])
@pytest.mark.parametrize("cross", [False, True])
def test_wrappers_hand_the_entry_its_operands(monkeypatch, m, cross):
    """The square form (one tensor for targets and sources) and the cross
    form: float32 operands centred on the source mean, contiguous (the
    square form's targets the sources'); one workspace of
    sym_plan.square_bf16_work's bytes for the library's split count; the
    pack launched on the centred rows, then the bf16 entry with (n_t, n_s,
    m, T, square), that split count and the same workspace and counts,
    counted once under its key; no float32 entry."""
    calls, spied = [], {}
    _stand_in(monkeypatch, calls, spied)
    rng = np.random.default_rng(70 + m)
    n_s, n_t = 300, 130 if cross else 300
    xs = torch.from_numpy(rng.normal(size=(n_s, m)) + 2.0)  # float64
    xt = torch.from_numpy(rng.normal(size=(n_t, m))) if cross else xs
    s = torch.from_numpy(rng.normal(size=(n_s, m)))
    g, thr = torch.tensor(0.5), torch.tensor([1.0, 2.0, 3.0])
    cuda_phi.reset_launch_counts()
    phi, counts = cuda_phi._square_launch(xt, xs, s, [g], None, thr,
                                          bf16=True)
    assert phi.shape == (n_t, m) and phi.dtype == xt.dtype
    assert counts.shape == (3,)
    assert spied["square"] is (not cross)
    assert (spied["tgt"] is spied["src"]) is (not cross)
    center = xs.float().mean(dim=0)
    for key, want in (("src", xs.float() - center),
                      ("tgt", xt.float() - center), ("scores", s.float())):
        got = spied[key]
        assert got.dtype == torch.float32 and got.is_contiguous()
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    launches = [c for c in calls
                if not c[0].endswith(("_splits", "_work_bytes"))]
    assert [c[0] for c in launches] == ["svgd_square_bf16_pack",
                                        "svgd_fused_phi_counts_square_bf16"]
    splits = sym_plan.square_splits(n_t, n_s, m, bf16=True)
    work = spied["work"]
    assert work.shape == (sym_plan.square_bf16_work(n_t, n_s, m,
                                                    not cross).bytes,)
    # (targets, sources, scores, sq_t, sq_s, work, counts, n_t, n_s, m, T,
    # square, splits, stream)
    pack = launches[0][1]
    assert pack[:3] == (spied["tgt"].data_ptr(), spied["src"].data_ptr(),
                        spied["scores"].data_ptr())
    assert (pack[3] == pack[4]) is (not cross)
    assert pack[5:7] == (work.data_ptr(), counts.data_ptr())
    assert pack[7:] == (n_t, n_s, m, 3, int(not cross), splits, 0)
    # (q_t, q_s, targets, gamma, thr, n_t, n_s, m, T, square, phi, counts,
    # work, splits, stream)
    args = launches[1][1]
    assert args[5:10] == (n_t, n_s, m, 3, int(not cross))
    assert (args[0] == args[1]) is (not cross)
    assert args[2] == spied["tgt"].data_ptr()
    assert args[11:14] == (counts.data_ptr(), work.data_ptr(), splits)
    assert cuda_phi.launch_counts[cuda_phi.SQUARE_BF16_KERNEL] == 1
    assert sum(cuda_phi.launch_counts.values()) == 1
    cuda_phi.reset_launch_counts()


@pytest.mark.parametrize("n_t, n_s, m", [(1000, 1000, 50), (130, 300, 2),
                                         (33, 10007, 65), (1, 1, 1)])
@pytest.mark.parametrize("square", [False, True])
def test_workspace_layout(n_t, n_s, m, square):
    """sym_plan.square_bf16_work (sq_bf16_work's copy): the partials
    (splits, n_t, 2m + 1) float32 from byte 0, then the sources' rounded
    rows, the targets' (the sources' own in the square form) and the bf16
    record, each segment on a 16-byte boundary, disjoint and in order, the
    whole no larger than its parts rounded up to 16 bytes;
    cuda_phi.square_bf16_views reads them back at those offsets."""
    if square:
        n_t = n_s
    splits = sym_plan.square_splits(n_t, n_s, m, bf16=True)
    lay = sym_plan.square_bf16_work(n_t, n_s, m, square)
    assert lay == sym_plan.square_bf16_work(n_t, n_s, m, square, splits)
    wq = sym_plan.square_bf16_row_width(m)
    rw = sym_plan.bf16_record_width(m)
    sizes = [4 * splits * n_t * (2 * m + 1), 4 * n_s * wq,
             0 if square else 4 * n_t * wq, 2 * n_s * rw]
    starts = [0, lay.x_s, lay.x_t if not square else lay.x_s + sizes[1],
              lay.rec]
    assert all(a % 16 == 0 for a in starts + [lay.bytes])
    for k in range(3):
        assert starts[k] + sizes[k] <= starts[k + 1]
    assert (lay.x_t == lay.x_s) is square
    assert lay.rec + sizes[3] <= lay.bytes
    assert lay.bytes <= sum(-(-b // 16) * 16 for b in sizes)
    work = torch.arange(lay.bytes, dtype=torch.int64).to(torch.uint8)
    x_t, x_s, rec = cuda_phi.square_bf16_views(work, n_t, n_s, m, square,
                                               splits)
    assert x_t.shape == (n_t, wq) and x_s.shape == (n_s, wq)
    assert rec.shape == (n_s, rw) and rec.dtype == torch.bfloat16
    for view, at in ((x_t, lay.x_t), (x_s, lay.x_s), (rec, lay.rec)):
        assert view.view(torch.uint8).flatten()[0] == at % 256


def _rnd(a):
    return a.to(torch.bfloat16).to(torch.float64)


@pytest.mark.parametrize("n_t, n_s, m", [(300, 300, 2), (130, 200, 17),
                                         (129, 70, 65)])
def test_plan_partials_finish_to_the_plain_version(n_t, n_s, m):
    """The body's function on the plan's blocks: per (row block, split,
    chunk) the Gram tile of the rounded operands, sq from the float32
    norms, k rounded to bf16, K . R over the chunk's columns; the splits'
    partials summed in order and finished as square_finish does (D = rowsum
    x_i - KX, phi = (KS + 2 gamma D) / n_s), against the bf16 plain version
    (float64 here against its float32: within 1e-5 of max |phi|), the
    counts over chunk 0's blocks against its counts."""
    rng = np.random.default_rng(90 + m)
    xs = torch.from_numpy(rng.normal(size=(n_s, m)).astype(np.float32))
    xt = torch.from_numpy(rng.normal(size=(n_t, m)).astype(np.float32))
    s = torch.from_numpy(rng.normal(size=(n_s, m)).astype(np.float32))
    g = torch.tensor(0.5 / m)
    thr = torch.tensor([0.5 * m, 1.0 * m, 2.0 * m])
    center = xs.mean(dim=0)
    tc, sc = (xt - center).double(), (xs - center).double()
    q_t, q_s = (tc * tc).sum(dim=1), (sc * sc).sum(dim=1)
    ones = torch.ones((n_s, 1), dtype=torch.float64)
    rec = _rnd(torch.cat([s.double(), sc, ones], dim=1))
    splits = sym_plan.square_splits(n_t, n_s, m, bf16=True)
    part = torch.zeros((splits, n_t, 2 * m + 1), dtype=torch.float64)
    counts = torch.zeros(3, dtype=torch.int64)
    chunk = sym_plan.square_bf16_chunk(n_t, n_s, m)
    for r0, nr, j0, j1, c0, nc in _grid(n_t, n_s, m):
        rows, src = slice(r0, r0 + nr), slice(j0, j1)
        gram = _rnd(tc[rows]) @ _rnd(sc[src]).T
        sq = torch.clamp_min(q_t[rows, None] + q_s[None, src] - 2.0 * gram,
                             0.0)
        k = _rnd(torch.exp2(-(float(g) * np.log2(np.e)) * sq))
        part[j0 // chunk, rows, c0:c0 + nc] = k @ rec[src, c0:c0 + nc]
        if c0 == 0:
            counts += (sq[None] <= thr.double()[:, None, None]).sum(
                dim=(1, 2))
    total = part[0]
    for sp in range(1, splits):
        total = total + part[sp]
    d = total[:, 2 * m, None] * tc - total[:, m:2 * m]
    phi = (total[:, :m] + 2.0 * float(g) * d) / n_s
    want, want_counts = pht.phi_rbf_cross_fused_counts(
        xt, xs, s, g, thr, dot_dtype=BF16)
    scale = float(want.abs().max())
    assert float((phi - want.double()).abs().max()) <= 1e-5 * scale
    assert int((counts - want_counts).abs().max()) <= 4
