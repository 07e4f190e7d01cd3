"""K1's port, the square/cross sweep, on the CPU.

* The launch plan: ``ops/sym_plan.square_splits``, the Python copy of the
  library's ``svgd_square_splits`` (csrc/fused_phi.cu), pinned at the main
  paths' shapes (the flat BLR's (1000, 50) and the (1500, 2) of phase 4),
  the sharded engine's cross shapes and the cross form of the card's smoke
  test; its splits cover every source once in whole tiles of 32, and the
  body (tensor cores from m = 5) follows ``square_tensor``.
* The wrapper on a stand-in library (meta tensors stand in for the card):
  it asks the library for the splits, allocates the (splits, n_t, 2m + 1)
  workspace, passes both to the kernel and counts one launch; a scores
  view that starts off a 16-byte boundary (the tensor-core body's
  cp.async copies) reaches the kernel as an aligned copy.
* The wrapper on CPU tensors (its plain version) against the JAX
  package's ``_fused_kernel`` through ``phi_rbf_fused_pallas_cross`` in
  interpret mode, float32, at the tensor-core body's widths: the flat
  BLR's m = 50, the runtime-m instances' m = 13 and 37 and m = 11, square
  and cross, off origin: phi rtol 2e-4, atol 2e-5 (the JAX package's
  interpret tolerance). The Pallas kernel builds sq by a bf16x3-split Gram
  identity and the plain version by a float32 one, so a pair near a
  threshold may fall on either side: the counts are held to the float64
  plain version exactly and to the Pallas kernel within COUNT_SLACK.
"""

import ctypes
from contextlib import nullcontext
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgdcpp_tpu.ops import pallas_phi as pj
from svgdcpp_tpu_torch.ops import cuda_phi, sym_plan
from svgdcpp_tpu_torch.ops.phi import phi_rbf_cross_fused_counts

torch.set_num_threads(1)


@pytest.mark.parametrize("n_t,n_s,m,splits", [
    (1000, 1000, 50, 16),   # flat BLR: 16 target blocks of 64, 2 tiles each
    (1500, 1500, 2, 16),    # phase 4: 12 blocks of 128, 96 sources each
    (700, 1500, 2, 24),     # the smoke test's cross form
    (600, 600, 4, 19),      # the CUDA cores: 5 blocks of 128
    (600, 600, 5, 19),      # the tensor cores: 10 blocks of 64
    (5000, 10000, 2, 7),    # a rank of two, gather mode
    (100000, 100000, 50, 1),
    (1, 1, 1, 1),
])
def test_square_splits_pinned(n_t, n_s, m, splits):
    assert sym_plan.square_splits(n_t, n_s, m) == splits


@pytest.mark.parametrize("n_t,n_s", [
    (1, 1), (33, 31), (1000, 1000), (1500, 1500), (700, 1500), (64, 20000),
    (20000, 64), (10007, 10007),
])
@pytest.mark.parametrize("m", [1, 2, 4, 5, 8, 11, 50, 64])
def test_square_splits_cover_the_sources(n_t, n_s, m):
    """Each split is whole tiles of SQUARE_GRAIN sources, every source in
    exactly one split, and no split empty; the launch aims at
    SQUARE_BLOCKS blocks without cutting a tile."""
    splits = sym_plan.square_splits(n_t, n_s, m)
    chunk = sym_plan.square_chunk(n_t, n_s, m)
    assert chunk % sym_plan.SQUARE_GRAIN == 0
    assert (splits - 1) * chunk < n_s <= splits * chunk
    rows = (sym_plan.SQUARE_ROWS_TENSOR if sym_plan.square_tensor(m)
            else sym_plan.SQUARE_ROWS_CUDA_CORES)
    blocks = -(-n_t // rows) * splits
    tiles = -(-n_s // sym_plan.SQUARE_GRAIN)
    assert blocks >= min(sym_plan.SQUARE_BLOCKS // 2, -(-n_t // rows) * tiles)


def test_square_body_follows_the_width():
    assert [sym_plan.square_tensor(m) for m in (1, 4, 5, 8, 11, 50, 64)] == \
        [False, False, True, True, True, True, True]
    # Past m = 64 the float32 wide body has a plan of its own (whole tiles
    # of 64 sources, the splits that fill whole waves of 132 blocks).
    assert sym_plan.square_splits(10, 10, 65) == 1
    assert sym_plan.square_splits(1000, 1000, 50) == 16
    assert sym_plan.square_splits(1000, 1000, 123) == 8
    assert sym_plan.square_splits(10, 10, 0) == -1
    assert sym_plan.square_splits(0, 10, 2) == -1


def stand_in_library(monkeypatch, launched):
    """A library that answers the split count with the Python copy and
    records each call, with the card's context managers stood in."""

    class Library:
        def svgd_square_splits(self, *args):
            launched.append(("splits", args))
            return sym_plan.square_splits(*args)

        def svgd_fused_phi_counts_square(self, *args):
            launched.append(("square", args))
            return 0

    monkeypatch.setattr(cuda_phi, "_require_cuda", lambda tensor: None)
    monkeypatch.setattr(cuda_phi, "load_library", Library)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("n_t,n_s,m", [
    (1000, 1000, 50), (1500, 1500, 2), (300, 700, 11), (600, 600, 4),
    (600, 600, 13),
])
def test_square_wrapper_takes_its_splits_from_the_library(monkeypatch, n_t,
                                                          n_s, m):
    """On a CUDA tensor the wrapper launches the square entry with the
    library's split count and a workspace of that many (n_t, 2m + 1)
    slices (a stand-in library that answers with the Python copy; meta
    tensors stand in for the card)."""
    launched = []
    stand_in_library(monkeypatch, launched)
    empty = torch.empty
    shapes = []

    def spy(*size, **kw):
        shapes.append(tuple(size[0]) if len(size) == 1 else size)
        return empty(*size, **kw)

    monkeypatch.setattr(torch, "empty", spy)
    xt = torch.empty((n_t, m), device="meta")
    xs = torch.empty((n_s, m), device="meta")
    thr = torch.empty((3,), device="meta")
    cuda_phi.reset_launch_counts()
    phi, counts = cuda_phi._square_launch(
        xt, xs, xs, [torch.empty((), device="meta")], None, thr)
    splits = sym_plan.square_splits(n_t, n_s, m)
    assert [(k, a[5:9] if k == "square" else a) for k, a in launched] == \
        [("splits", (n_t, n_s, m)), ("square", (n_t, n_s, m, 3))]
    assert launched[1][1][12] == splits
    assert (splits, n_t, 2 * m + 1) in shapes
    assert tuple(phi.shape) == (n_t, m) and tuple(counts.shape) == (3,)
    assert cuda_phi.launch_counts[cuda_phi.SQUARE_KERNEL] == 1
    cuda_phi.reset_launch_counts()


@pytest.mark.parametrize("first_row", [0, 1, 2])
def test_square_wrapper_aligns_the_scores(monkeypatch, first_row):
    """A float32 scores view from row ``first_row`` of a larger array (at
    m = 50 row 1 starts 8 bytes past a 16-byte boundary, rows 0 and 2 on
    one) reaches the kernel through a pointer on a 16-byte boundary that
    holds the view's values: a misaligned view is copied, an aligned one
    passed as it is."""
    n, m = 50, 50
    launched = []
    stand_in_library(monkeypatch, launched)
    base = torch.arange((n + 2) * m, dtype=torch.float32).reshape(n + 2, m)
    scores = base[first_row:first_row + n]
    assert (scores.data_ptr() % 16 == 0) == (first_row != 1)
    real_square = cuda_phi.load_library.svgd_fused_phi_counts_square
    passed = []

    def square(self, *args):
        values = (ctypes.c_float * (n * m)).from_address(args[2])
        passed.append((args[2], np.array(values)))
        return real_square(self, *args)

    monkeypatch.setattr(cuda_phi.load_library, "svgd_fused_phi_counts_square",
                        square)
    x = torch.zeros((n, m))
    cuda_phi._square_launch(x, x, scores, [torch.tensor(0.5)], None,
                            torch.ones(3))
    ptr, values = passed[0]
    assert ptr % 16 == 0
    assert (ptr == scores.data_ptr()) == (first_row != 1)
    np.testing.assert_array_equal(values, scores.numpy().ravel())


#: The most the Pallas kernel's counts may differ from the plain version's
#: here: twice the largest difference read over four seeds of each case
#: (2: one pair, both orders, on the other side of a threshold), far below
#: the n_s self pairs of a square case.
COUNT_SLACK = 4


def _inputs(n, m, offset, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, m)) + offset).astype(np.float32)
    s = rng.normal(size=(n, m)).astype(np.float32)
    return x, s


@pytest.mark.parametrize("n_t,n_s,m", [
    (None, 300, 50), (130, 300, 50), (None, 260, 13), (None, 200, 37),
    (97, 230, 11),
])
def test_square_wrapper_on_cpu_vs_pallas_interpret(n_t, n_s, m):
    xs, s = _inputs(n_s, m, 2.0, 100 + m)
    xt = xs if n_t is None else _inputs(n_t, m, 2.2, 200 + m)[0]
    gamma = np.float32(0.6 / m)
    thr = np.linspace(0.5, 4.0 * m, 4).astype(np.float32)
    want = pj.phi_rbf_fused_pallas_cross(
        jnp.asarray(xt), jnp.asarray(xs), jnp.asarray(s), gamma,
        jnp.asarray(thr), tile_i=64, tile_j=128, interpret=True,
    )
    cuda_phi.reset_launch_counts()
    got = cuda_phi.phi_rbf_fused_cuda_cross(
        torch.from_numpy(xt), torch.from_numpy(xs), torch.from_numpy(s),
        torch.tensor(gamma), torch.from_numpy(thr),
    )
    assert not any(cuda_phi.launch_counts.values())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-4, atol=2e-5)
    exact = phi_rbf_cross_fused_counts(
        *(torch.from_numpy(a).double() for a in (xt, xs, s)),
        torch.tensor(float(gamma), dtype=torch.float64),
        torch.from_numpy(thr).double())[1]
    np.testing.assert_array_equal(got[1].numpy(), exact.numpy())
    cnt = np.asarray(want[1]).astype(np.int64)
    assert np.abs(got[1].numpy() - cnt).max() <= COUNT_SLACK
