"""K6/K7's port, the composed-kernel square/cross sweep, on the CPU.

* The launch plan: the terms kernel takes K1's split rule (one library
  export, ``svgd_square_splits``, mirrored by ``ops/sym_plan.square_splits``):
  pinned at the terms paths' shapes (the hierarchical BLR's (1500, 11) of
  phase 10, its cross forms, the CUDA-core widths), every source in exactly
  one split of whole 32-source tiles.
* The wrapper on a stand-in library (meta tensors stand in for the card):
  it asks the library for the splits, passes them and a (splits, n_t,
  2m + 1) workspace to ``svgd_fused_phi_terms_square`` with the terms'
  signs and count, counts one launch under ``fused_phi_terms_square``, and
  hands the kernel a scores view off a 16-byte boundary as an aligned copy;
  the ctypes signature it is bound with takes every argument it passes.
* The wrapper on CPU tensors (its plain version) against the JAX package's
  K7 (``_phi_rbf_terms_fused_pallas_cross_impl``) and K6
  (``_phi_rbf_terms_fused_pallas_cross_direct_impl``) in interpret mode,
  float32, at m = 2 and 5 (the bodies' crossing), 11, 13 and 50, with signs
  (1, 1), (1, -1) and three terms, square and cross (n_t != n_s, targets
  off the sources' origin): phi rtol 2e-4, atol 2e-5 (the JAX package's
  interpret tolerance); counts equal to the float64 plain version's, and to
  the Pallas kernels' at m <= 4 (both by differences) and within
  COUNT_SLACK above (the Pallas kernels build sq by a bf16x3-split Gram
  identity there, the plain version by a float32 one, so a pair near a
  threshold may fall on either side).
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
from svgdcpp_tpu_torch.ops.phi import phi_rbf_terms_cross_fused_counts

torch.set_num_threads(1)


@pytest.mark.parametrize("n_t,n_s,m,splits", [
    (1500, 1500, 11, 10),   # phase 10: 24 target blocks of 64, 160 sources
    (700, 1500, 11, 24),    # the smoke test's cross form
    (1500, 1500, 2, 16),    # the CUDA cores: 12 blocks of 128, 96 sources
    (700, 1500, 2, 24),
    (1000, 1000, 50, 16),
    (1337, 1337, 13, 11),
    (10000, 10000, 11, 2),
    (1, 1, 5, 1),
])
def test_terms_square_splits_pinned(n_t, n_s, m, splits):
    assert sym_plan.square_splits(n_t, n_s, m) == splits


@pytest.mark.parametrize("n_t,n_s", [
    (1500, 1500), (700, 1500), (130, 300), (1337, 1337), (33, 65),
])
@pytest.mark.parametrize("m", [2, 4, 5, 11, 13, 50, 64])
def test_terms_square_splits_cover_the_sources(n_t, n_s, m):
    """Whole tiles of SQUARE_GRAIN sources a split, each source in one
    split, no split empty, and the launch near SQUARE_BLOCKS blocks without
    cutting a tile."""
    splits = sym_plan.square_splits(n_t, n_s, m)
    chunk = sym_plan.square_chunk(n_t, n_s, m)
    assert chunk % sym_plan.SQUARE_GRAIN == 0
    assert (splits - 1) * chunk < n_s <= splits * chunk
    rows = (sym_plan.SQUARE_ROWS_TENSOR if sym_plan.square_tensor(m)
            else sym_plan.SQUARE_ROWS_CUDA_CORES)
    blocks = -(-n_t // rows) * splits
    tiles = -(-n_s // sym_plan.SQUARE_GRAIN)
    assert blocks >= min(sym_plan.SQUARE_BLOCKS // 2, -(-n_t // rows) * tiles)


#: The terms entry's arguments as the wrapper passes them: (targets,
#: sources, scores, gammas, signs, nterms, thr, n_t, n_s, m, T, phi, counts,
#: work, splits, stream).
TERMS_ARGS = 16


def stand_in_library(monkeypatch, launched):
    """A library that answers the split count with the Python copy and
    records each call, with the card's context managers stood in."""

    class Library:
        def svgd_square_splits(self, *args):
            launched.append(("splits", args))
            return sym_plan.square_splits(*args)

        def svgd_fused_phi_terms_square(self, *args):
            launched.append(("terms", args))
            return 0

    monkeypatch.setattr(cuda_phi, "_require_cuda", lambda tensor: None)
    monkeypatch.setattr(cuda_phi, "load_library", Library)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("n_t,n_s,m,signs", [
    (1500, 1500, 11, (1.0, 1.0)), (700, 1500, 11, (1.0, -1.0)),
    (1500, 1500, 2, (1.0, 1.0)), (300, 700, 50, (1.0, -0.5, 0.3)),
    (600, 600, 4, (1.0, 1.0)),
])
def test_terms_wrapper_takes_its_splits_from_the_library(monkeypatch, n_t,
                                                         n_s, m, signs):
    """On a CUDA tensor the wrapper launches the terms entry with the
    library's split count and a workspace of that many (n_t, 2m + 1)
    slices, the terms' count and signs (meta tensors stand in for the
    card)."""
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
    gammas = [torch.empty((), device="meta") for _ in signs]
    cuda_phi.reset_launch_counts()
    phi, counts = cuda_phi._square_launch(xt, xs, xs, gammas, signs, thr)
    splits = sym_plan.square_splits(n_t, n_s, m)
    assert [k for k, _ in launched] == ["splits", "terms"]
    assert launched[0][1] == (n_t, n_s, m)
    args = launched[1][1]
    assert len(args) == TERMS_ARGS
    assert args[5] == len(signs)
    assert list(args[4]) == [float(np.float32(v)) for v in signs]
    assert args[7:11] == (n_t, n_s, m, 3)
    assert args[14] == splits
    assert (splits, n_t, 2 * m + 1) in shapes
    assert tuple(phi.shape) == (n_t, m) and tuple(counts.shape) == (3,)
    assert cuda_phi.launch_counts[cuda_phi.TERMS_SQUARE_KERNEL] == 1
    assert cuda_phi.launch_counts[cuda_phi.SQUARE_KERNEL] == 0
    cuda_phi.reset_launch_counts()


@pytest.mark.parametrize("first_row", [0, 1, 2])
def test_terms_wrapper_aligns_the_scores(monkeypatch, first_row):
    """A float32 scores view from row ``first_row`` of a larger array (at
    m = 11 rows 1 and 2 start 12 and 8 bytes past a 16-byte boundary, row
    0 on one) reaches the kernel through a pointer on a 16-byte boundary
    that holds the view's values: a misaligned view is copied, an aligned
    one passed as it is."""
    n, m = 40, 11
    launched = []
    stand_in_library(monkeypatch, launched)
    base = torch.arange((n + 2) * m, dtype=torch.float32).reshape(n + 2, m)
    scores = base[first_row:first_row + n]
    assert (scores.data_ptr() % 16 == 0) == (first_row == 0)
    passed = []

    def terms(self, *args):
        values = (ctypes.c_float * (n * m)).from_address(args[2])
        passed.append((args[2], np.array(values)))
        return 0

    monkeypatch.setattr(cuda_phi.load_library, "svgd_fused_phi_terms_square",
                        terms)
    x = torch.zeros((n, m))
    cuda_phi._square_launch(x, x, scores, [torch.tensor(0.5),
                                           torch.tensor(0.1)], (1.0, 1.0),
                            torch.ones(3))
    ptr, values = passed[0]
    assert ptr % 16 == 0
    assert (ptr == scores.data_ptr()) == (first_row == 0)
    np.testing.assert_array_equal(values, scores.numpy().ravel())


def test_terms_entry_is_bound_with_every_argument(monkeypatch):
    """The library's ctypes signature of ``svgd_fused_phi_terms_square``
    (set by load_library) takes the TERMS_ARGS arguments the wrapper passes,
    pointers as c_void_p (a pointer as a 32-bit int would be cut) and the
    counts and split count as c_int, like K1's entry with the terms' signs
    and count."""

    class Fn:
        argtypes = None
        restype = None

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            object.__setattr__(self, name, fn)
            return fn

    monkeypatch.setattr(cuda_phi, "_lib", None)
    monkeypatch.setattr(cuda_phi, "build_library", lambda *a: "stand-in")
    monkeypatch.setattr(cuda_phi.ctypes, "CDLL", lambda path: Lib())
    lib = cuda_phi.load_library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    terms = lib.svgd_fused_phi_terms_square.argtypes
    assert len(terms) == TERMS_ARGS
    assert terms == [ptr] * 5 + [i32, ptr] + [i32] * 4 + [ptr] * 3 + [i32,
                                                                      ptr]
    k1 = lib.svgd_fused_phi_counts_square.argtypes
    assert terms[:4] + terms[6:] == k1
    assert lib.svgd_square_splits.argtypes == [i32] * 3


#: The most the Pallas kernels' counts may differ from the plain version's
#: above m = 4 (one pair, both orders, on the other side of a threshold,
#: twice over), far below the n_s self pairs of a square case.
COUNT_SLACK = 4

#: The JAX package's two cross kernels: K7 (k_c/w, the Gram branch's) and
#: K6 (the direct kernel, one band a term, the difference branch's).
JAX_KERNELS = {
    "K7": pj._phi_rbf_terms_fused_pallas_cross_impl,
    "K6": pj._phi_rbf_terms_fused_pallas_cross_direct_impl,
}


def _inputs(n, m, offset, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, m)) + offset).astype(np.float32)
    s = rng.normal(size=(n, m)).astype(np.float32)
    return x, s


@pytest.mark.parametrize("kernel", ["K7", "K6"])
@pytest.mark.parametrize("n_t,n_s,m,signs", [
    (None, 300, 2, (1.0, 1.0)),
    (130, 300, 2, (1.0, -1.0)),
    (None, 260, 5, (1.0, -0.5, 0.3)),
    (97, 230, 11, (1.0, 1.0)),
    (None, 230, 11, (1.0, -1.0)),
    (120, 260, 13, (1.0, -1.0)),
    (130, 300, 50, (1.0, 1.0)),
])
def test_terms_wrapper_on_cpu_vs_pallas_interpret(kernel, n_t, n_s, m, signs):
    xs, s = _inputs(n_s, m, 2.0, 300 + m)
    xt = xs if n_t is None else _inputs(n_t, m, 2.2, 400 + m)[0]
    g = 0.6 / m
    gammas = [np.float32(g), np.float32(0.1), np.float32(2.0 * g)][
        :len(signs)]
    thr = np.linspace(0.5, 4.0 * m, 4).astype(np.float32)
    want = JAX_KERNELS[kernel](
        jnp.asarray(xt), jnp.asarray(xs), jnp.asarray(s),
        tuple(jnp.float32(gm) for gm in gammas), signs, jnp.asarray(thr),
        thr.shape[0], 64, 128, True,
    )
    cuda_phi.reset_launch_counts()
    got = cuda_phi.phi_rbf_terms_fused_cuda_cross(
        torch.from_numpy(xt), torch.from_numpy(xs), torch.from_numpy(s),
        [torch.tensor(gm) for gm in gammas], signs, torch.from_numpy(thr),
    )
    assert not any(cuda_phi.launch_counts.values())
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-4, atol=2e-5)
    exact = phi_rbf_terms_cross_fused_counts(
        *(torch.from_numpy(a).double() for a in (xt, xs, s)),
        [torch.tensor(float(gm), dtype=torch.float64) for gm in gammas],
        signs, torch.from_numpy(thr).double())[1]
    np.testing.assert_array_equal(got[1].numpy(), exact.numpy())
    cnt = np.asarray(want[1]).astype(np.int64)
    slack = 0 if m <= 4 else COUNT_SLACK
    assert np.abs(got[1].numpy() - cnt).max() <= slack
