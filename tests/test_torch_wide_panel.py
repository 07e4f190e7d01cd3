"""The panel sweeps past m = 64 (K3, K5 and K12/K13's wide instances), on
the CPU.

* The plain panel schedules, through the CUDA wrappers on CPU tensors
  with sym="panel", against the JAX package's Pallas panel kernels in
  interpret mode at m = 65 and 100 (small tiles, as
  tests/test_torch_panel.py runs them), float32, ragged n, off origin:
  K3 (``_phi_rbf_fused_pallas_sympanel_impl``), K12
  (``_phi_rbf_terms_fused_pallas_sympanel_direct_impl``) and K13
  (``_phi_rbf_terms_fused_pallas_sympanel_impl``) with one to three terms
  and a negative sign. phi within 1e-4 of max |phi| (test_torch_panel's
  bound); counts equal to the float64 plain version's and within
  COUNT_SLACK of the Pallas kernel's (its Gram sq is bf16x3-split).
* The plain schedules in float64 against the JAX package's plain sweeps
  at m = 65 for several super-block counts (rtol 1e-10, counts equal), and
  K5's plain chunks summed over worlds 1-5 against the whole panel sweep
  (rtol 1e-12, counts equal).
* K5's ranges (``sym_plan.panel_chunk``) over worlds 1-8 put every panel
  in exactly one rank, in order.
* The wrappers on a stand-in library (meta tensors stand in for the card)
  at m = 65, 123 and 512: K3, K12/K13 and K5 (every rank of worlds 1-4)
  call their wide entries (``..._wide``, on csrc/wide_tri_sm90.cuh's body)
  with the rows' padded width ``wide_row_width(m)`` and the plan of
  128-particle tiles (nb, w), allocate the (2 width, n) accumulator and no
  windows, and count one launch each; up to m = 64, where the windows
  remain, a window buffer larger than the card's memory raises before
  anything is launched.
* The drivers with fused_sym="panel" at m = 65 for 3 AdaGrad steps in
  float32: one RBF ('fused_cuda') against the JAX driver's
  'fused_pallas', and a composed kernel ('fused_terms_cuda') against
  'fused_terms_pallas', both with fused_sym="panel" in interpret mode,
  rtol 2e-3, atol 2e-4 (test_torch_panel's bound for that pair: AdaGrad
  divides phi by its own running norm). The engine's forced "panel"
  (K5's chunk) at m = 65 on a one-rank gloo group against its "full"
  form in float64, rtol 1e-9.

About 40 s in one process.
"""

import socket
from contextlib import nullcontext
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.ops import pallas_phi as pj
from svgdcpp_tpu.ops import phi as phj
from svgdcpp_tpu_torch.ops import cuda_phi, sym_plan
from svgdcpp_tpu_torch.ops import phi as pht
from svgdcpp_tpu_torch.parallel import (
    ShardedSVGD,
    ShardedSVGDConfig,
    initialize_distributed,
)

torch.set_num_threads(1)

#: The widths past 64 the Pallas comparisons take.
WIDE = (65, 100)

#: As tests/test_torch_wide.py: one pair on the other side of a threshold
#: in both orders, twice over.
COUNT_SLACK = 4


def _inputs(n, m, offset, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, m)) + offset).astype(dtype)
    s = rng.normal(size=(n, m)).astype(dtype)
    return x, s


def _thresholds(m, dtype=np.float32):
    return np.linspace(0.5, 4.0 * m, 4).astype(dtype)


def _check(got, want, exact):
    """phi within 1e-4 of max |phi| of the Pallas kernel's; counts equal
    to the float64 plain version's and within COUNT_SLACK of the Pallas
    kernel's."""
    phi_t, cnt_t = got
    phi_j = np.asarray(want[0])
    rel = np.abs(phi_t.numpy() - phi_j).max() / np.abs(phi_j).max()
    assert rel <= 1e-4, rel
    np.testing.assert_array_equal(cnt_t.numpy(), exact.numpy())
    cnt_j = np.asarray(want[1]).astype(np.int64)
    assert np.abs(cnt_t.numpy() - cnt_j).max() <= COUNT_SLACK


def _f64(*arrays):
    return [torch.from_numpy(a).double() for a in arrays]


# ----------------------------------------------------------------------
# The plain panel schedules against the Pallas panel kernels
# ----------------------------------------------------------------------


@pytest.mark.parametrize("m", WIDE)
def test_k3_wide_vs_sympanel_interpret(m):
    n = 301
    x, s = _inputs(n, m, 2.0, 800 + m)
    gamma = np.float32(0.6 / m)
    thr = _thresholds(m)
    want = pj._phi_rbf_fused_pallas_sympanel_impl(
        jnp.asarray(x), jnp.asarray(s), jnp.float32(gamma), jnp.asarray(thr),
        4, 32, 64, True, panel_blocks=4,
    )
    cuda_phi.reset_launch_counts()
    got = cuda_phi.phi_rbf_fused_cuda(
        *map(torch.from_numpy, (x, s)), torch.tensor(gamma),
        torch.from_numpy(thr), sym="panel", panel_blocks=3,
    )
    assert not any(cuda_phi.launch_counts.values())  # the plain version
    exact = pht.phi_rbf_fused_counts(
        *_f64(x, s), torch.tensor(float(gamma), dtype=torch.float64),
        *_f64(thr))[1]
    _check(got, want, exact)


@pytest.mark.parametrize("impl,m,signs", [
    ("direct", 65, (1.0, 1.0)),
    ("direct", 100, (1.0, -0.5)),
    ("legacy", 65, (1.0, -0.5, 0.3)),
    ("legacy", 100, (1.0,)),
])
def test_k12_k13_wide_vs_interpret(impl, m, signs):
    n = 283
    x, s = _inputs(n, m, -1.5, 810 + m + len(signs))
    gs = [np.float32(g) for g in (0.6 / m, 0.2 / m, 1.5 / m)[:len(signs)]]
    thr = _thresholds(m)
    args = (jnp.asarray(x), jnp.asarray(s), tuple(jnp.float32(g) for g in gs),
            signs, jnp.asarray(thr), 4)
    if impl == "direct":
        want = pj._phi_rbf_terms_fused_pallas_sympanel_direct_impl(
            *args, 32, 64, True, panel_blocks=4)
    else:
        want = pj._phi_rbf_terms_fused_pallas_sympanel_impl(
            *args, 32, 64, True, panel_blocks=5)
    got = cuda_phi.phi_rbf_terms_fused_cuda(
        *map(torch.from_numpy, (x, s)), [torch.tensor(g) for g in gs], signs,
        torch.from_numpy(thr), sym="panel", panel_blocks=3,
    )
    exact = pht.phi_rbf_terms_fused_counts(
        *_f64(x, s), [float(g) for g in gs], signs, *_f64(thr))[1]
    _check(got, want, exact)


@pytest.mark.parametrize("blocks", [1, 3, 8, None])
def test_plain_wide_panel_schedules_f64(blocks):
    m, n = 65, 301 if blocks != 8 else 100  # 8 blocks of 64: empty ones
    x, s = _inputs(n, m, 3.0, 820, np.float64)
    thr = _thresholds(m, np.float64)
    want_phi, want_cnt = phj.phi_rbf_fused_counts(
        jnp.asarray(x), jnp.asarray(s), 0.5 / m, jnp.asarray(thr))
    got_phi, got_cnt = pht.phi_rbf_sympanel_fused_counts(
        *_f64(x, s), 0.5 / m, *_f64(thr), panel_blocks=blocks, row_tile=40)
    np.testing.assert_allclose(got_phi.numpy(), np.asarray(want_phi),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(got_cnt.numpy(),
                                  np.asarray(want_cnt).astype(np.int64))
    gammas, signs = [0.5 / m, 0.1 / m], [1.0, -0.4]
    want_phi, want_cnt = phj.phi_rbf_terms_fused_counts(
        jnp.asarray(x), jnp.asarray(s), gammas, signs, jnp.asarray(thr))
    got_phi, got_cnt = pht.phi_rbf_terms_sympanel_fused_counts(
        *_f64(x, s), gammas, signs, *_f64(thr), panel_blocks=blocks,
        row_tile=40)
    np.testing.assert_allclose(got_phi.numpy(), np.asarray(want_phi),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(got_cnt.numpy(),
                                  np.asarray(want_cnt).astype(np.int64))


@pytest.mark.parametrize("world", [1, 2, 3, 5])
def test_k5_wide_chunks_sum_to_the_panel_sweep(world):
    m, n, gamma = 65, 257, 0.5 / 65
    x, s = _f64(*_inputs(n, m, 1.0, 830 + world, np.float64))
    thr = torch.from_numpy(_thresholds(m, np.float64))
    acc = upper = 0
    for rank in range(world):
        a, u = cuda_phi.phi_rbf_sympanel_chunk_cuda(x, s, gamma, thr, world,
                                                    rank, panel_blocks=4)
        acc, upper = acc + a, upper + u
    phi = pht.phi_rbf_fused_sym_finish(acc, s, gamma, n)
    want_phi, want_cnt = pht.phi_rbf_sympanel_fused_counts(
        x, s, gamma, thr, panel_blocks=4)
    np.testing.assert_allclose(phi.numpy(), want_phi.numpy(), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_array_equal((2 * upper - n).numpy(), want_cnt.numpy())


@pytest.mark.parametrize("world", range(1, 9))
def test_k5_ranges_put_every_panel_in_one_rank(world):
    for nb in (1, 2, 3, 8, 13, 16):
        num_p = nb * (nb + 1) // 2
        seen = []
        for rank in range(world):
            p0, count = sym_plan.panel_chunk(nb, world, rank)
            seen.extend(range(p0, p0 + count))
        assert seen == list(range(num_p)), (world, nb)


# ----------------------------------------------------------------------
# The wrappers on a stand-in library
# ----------------------------------------------------------------------


def _stand_in(monkeypatch, calls, shapes):
    """A library that records each launch (tests/test_torch_wide.py's
    stand-in), the card's context managers stood in, and the shapes of the
    buffers the wrappers allocate."""

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
    real = torch.zeros

    def spy(*size, **kw):
        one = size[0] if len(size) == 1 else size
        shapes.append(tuple(one) if isinstance(one, (tuple, list))
                      else (one,))
        return real(*size, **kw)
    monkeypatch.setattr(torch, "zeros", spy)


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _panel_buffers(shapes, num_p, m, w):
    """The window buffers (num_p, 2, 2m, w) among the allocations."""
    return [sh for sh in shapes if len(sh) == 4 and sh[1:] == (2, 2 * m, w)
            and sh[0] == num_p]


@pytest.mark.parametrize("m", [65, 123, 512])
def test_wide_panel_wrappers_launch_once_on_the_plan(monkeypatch, m):
    """K3 and K12/K13 (sym="panel", forced and default super-block counts)
    and K5 (every rank of worlds 1-4) past 64: one launch each of their
    wide entries, with the rows' padded width wide_row_width(m) and the
    plan of 128-particle tiles (nb, w; K5 its rank's panels of that plan),
    into a zeroed (2 width, n) accumulator, no window buffer."""
    calls, shapes = [], []
    _stand_in(monkeypatch, calls, shapes)
    n, g, thr = 1000, _meta(), _meta(3)
    x = _meta(n, m)
    width = sym_plan.wide_row_width(m)
    assert width % 4 == 0 and width - 4 < m <= width
    for blocks in (None, 3):
        nb, w, _ = sym_plan.card_panel_plan(n, blocks, tile128=True)
        assert w % 128 == 0 and w % sym_plan.WIDE_TILE == 0
        num_p = nb * (nb + 1) // 2
        for kernel, entry, call in (
            (cuda_phi.SYMPANEL_KERNEL, "svgd_fused_phi_counts_sympanel_wide",
             lambda: cuda_phi.phi_rbf_fused_cuda(
                 x, x, g, thr, sym="panel", panel_blocks=blocks)),
            (cuda_phi.TERMS_SYMPANEL_KERNEL,
             "svgd_fused_phi_terms_sympanel_wide",
             lambda: cuda_phi.phi_rbf_terms_fused_cuda(
                 x, x, [g, g], (1.0, -0.5), thr, sym="panel",
                 panel_blocks=blocks)),
        ):
            del calls[:], shapes[:]
            cuda_phi.reset_launch_counts()
            phi, counts = call()
            assert [c[0] for c in calls] == [entry]
            args = calls[0][1]
            # (n, width, T, nb, w) right after the pointers (and the signs)
            at = 4 if "counts" in entry else 6
            assert args[at:at + 5] == (n, width, 3, nb, w)
            assert (2 * width, n) in shapes
            assert not _panel_buffers(shapes, num_p, m, w)
            assert not _panel_buffers(shapes, num_p, width, w)
            assert tuple(phi.shape) == (n, m) and tuple(counts.shape) == (3,)
            assert cuda_phi.launch_counts[kernel] == 1
            assert sum(cuda_phi.launch_counts.values()) == 1
    nb, w, _ = sym_plan.card_panel_plan(n, tile128=True)
    for world in (1, 2, 3, 4):
        for rank in range(world):
            p0, count = sym_plan.panel_chunk(nb, world, rank)
            del calls[:], shapes[:]
            cuda_phi.reset_launch_counts()
            acc, upper = cuda_phi.phi_rbf_sympanel_chunk_cuda(
                x, x, g, thr, world, rank)
            assert [c[0] for c in calls] == [
                "svgd_fused_phi_counts_sympanel_chunk_wide"]
            assert calls[0][1][4:11] == (n, width, 3, nb, w, p0, count)
            assert (2 * width, n) in shapes
            assert not _panel_buffers(shapes, count, m, w)
            assert not _panel_buffers(shapes, count, width, w)
            assert tuple(acc.shape) == (2 * m, n)
            assert cuda_phi.launch_counts[
                cuda_phi.SYMPANEL_CHUNK_KERNEL] == (1 if count else 0)
    cuda_phi.reset_launch_counts()


def test_panel_windows_past_the_cards_memory_raise(monkeypatch):
    """The window buffer, which the panels keep up to m = 64, is checked
    against the card's memory before it is allocated: (nb (nb + 1) / 2, 2,
    2m, w) float32 at N = 262,144, m = 64 and the plan's 8 super-blocks of
    32,768 is 1.21 GB, which a card of 1 GB stood in refuses, naming the
    size."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(total_memory=2**30))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "a stand-in card")
    nb, w, _ = sym_plan.card_panel_plan(262144)
    assert (nb, w) == (8, 32768)
    num_p = nb * (nb + 1) // 2
    nbytes = 4 * num_p * 2 * 2 * 64 * w
    assert 1.2e9 < nbytes < 1.22e9
    with pytest.raises(ValueError, match=str(nbytes)):
        cuda_phi._panel_windows(num_p, 64, w, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="at most 65535 panels"):
        cuda_phi._panel_plan(10**6, 362)


# ----------------------------------------------------------------------
# The drivers and the engine
# ----------------------------------------------------------------------


def _mvn_driver(pkg, x0, impl, iters, composed=False, **kw):
    n, dim = x0.shape
    model = pkg.MultivariateNormal(np.zeros(dim, x0.dtype),
                                   np.eye(dim, dtype=x0.dtype))
    kernel = pkg.GaussianRBFKernel(x0.copy(), pkg.ScaleMethod.MEDIAN, model)
    if composed:
        kernel = kernel + pkg.GaussianRBFKernel(
            x0.copy(), pkg.ScaleMethod.CONSTANT,
            constant_scale=(0.2 / dim) * np.eye(dim, dtype=x0.dtype))
    extra = {"device": "cpu"} if pkg is st else {}
    return pkg.SVGD(pkg.SVGDOptions(
        dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model, optimizer=pkg.AdaGrad(dim, n, 0.1),
        phi_impl=impl, fused_sym="panel", **kw, **extra,
    )).initialize()


@pytest.mark.parametrize("composed", [False, True])
def test_panel_drivers_past_64_vs_jax_interpret(composed):
    m, n, steps = 65, 300, 3
    x0 = (np.random.default_rng(840).normal(size=(n, m)) * 0.5).astype(
        np.float32)
    port_impl = "fused_terms_cuda" if composed else "fused_cuda"
    jax_impl = "fused_terms_pallas" if composed else "fused_pallas"
    s_t = _mvn_driver(st, x0, port_impl, steps, composed)
    assert s_t._phi_impl == port_impl and s_t.fused_sym_form == "panel"
    got = s_t.run().numpy()
    want = np.asarray(_mvn_driver(sv, x0, jax_impl, steps, composed).run())
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    assert s_t.median_fallbacks == 0


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo world in this process."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    g = initialize_distributed(f"tcp://localhost:{port}", 1, 0,
                               device="cpu")
    yield g
    dist.destroy_process_group()


def test_engine_panel_past_64_matches_its_full_form(group):
    m, n, steps = 65, 256, 3
    x0 = np.random.default_rng(850).normal(size=(n, m)) * 0.5
    model = st.MultivariateNormal(np.zeros(m), np.eye(m))
    out = {}
    for form in ("panel", "full"):
        eng = ShardedSVGD(model, st.AdaGrad(m, n, 0.1), n, m, mesh=group,
                          config=ShardedSVGDConfig(fused_phi=True,
                                                   fused_cuda=True,
                                                   fused_sym=form))
        assert eng._fused_sym == form
        out[form] = eng.run(torch.from_numpy(x0), steps).numpy()
    np.testing.assert_allclose(out["panel"], out["full"], rtol=1e-9,
                               atol=1e-12)
