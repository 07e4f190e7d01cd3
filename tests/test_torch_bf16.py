"""The bfloat16 operand opt-in (``dot_dtype='bfloat16'``,
``SVGDOptions.fused_dot_dtype``) of svgdcpp_tpu_torch against svgdcpp_tpu,
on the CPU.

* The plain versions of the bf16 instances, through the CUDA wrappers on
  CPU tensors, against the JAX package's bf16 Pallas kernels in interpret
  mode on the same float32 inputs (n = 300, off origin): K1 square and
  cross (``phi_rbf_fused_pallas`` with sym=False,
  ``phi_rbf_fused_pallas_cross``) at m = 2, 11, 16, 17 (the edges of a
  k16 step of its bf16 body's Gram tile), 50 and 65, K2 (sym=True) and
  K3 (sym="panel") at m = 2, 11, 16, 17 (the edges of a k16 step of their
  bf16 body's Gram tile) and 65, K15
  (``phi_rbf_pallas``) at m = 2 and 11 with a positive definite and an
  indefinite P. phi within PHI_TOL = 1e-3 of max |phi| of JAX's bf16
  result (measured up to 4.2e-4, the cross form at m = 65: the two
  packages' float32 exponentials differ in their last bits, and where one
  sits at a bf16 rounding boundary k moves by one bf16 ulp, 2^-8 k, a
  change of 2^-8 k s_j / n in phi, about 5e-4 of max |phi| at these
  sizes; float64 operations on the same rounded operands stand 3e-4 and
  4e-4 from the port's and JAX's results there); counts within
  COUNT_SLACK of JAX's bf16 counts (measured equal). Each case also shows
  the port's bf16 result at least CLOSER = 4 times nearer JAX's bf16
  result than JAX's float32 one (measured 5.5 to 200 times), so the
  rounding is copied, not skipped.
* The driver: 'fused_cuda' with fused_dot_dtype='bfloat16' against the JAX
  driver's 'fused_pallas' with it (tests/test_pallas.py's setup: MVN,
  n = 600, d = 2, AdaGrad 0.1, 3 steps, interpret mode), and nearer it
  than the float32 JAX run; under SVGDOptions.mesh on a one-rank gloo
  group the cross sweep (the triangle forms have no bf16 form), equal to
  the meshless square route and within DRIVER_TOL of the meshless JAX
  driver (the JAX driver takes 'fused_pallas' under a mesh on a TPU
  only); a forced triangle raises; the sharded engine takes
  the cross sweep too and differs from its float32 run; the 'cuda' route
  ignores the option, as JAX's 'pallas' route does; a dtype other than
  'float32' or 'bfloat16' raises ValueError everywhere.
* The wrappers on a stand-in library (meta tensors stand in for the card)
  at m = 2, 11 and 123: each form launches its own bf16 entry once, never
  the float32 one, counted under its own key; K1's with its own body's
  split count at every m (``sym_plan.square_splits(bf16=True)``).

About 45 s in one process.
"""

import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.ops import pallas_phi as pj
from svgdcpp_tpu.parallel import make_particle_mesh
from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.ops import phi as pht
from svgdcpp_tpu_torch.parallel import (
    ShardedSVGD,
    ShardedSVGDConfig,
    initialize_distributed,
)

torch.set_num_threads(1)

BF16 = "bfloat16"
#: phi of the port's bf16 plain versions against JAX's bf16 kernels, as a
#: share of max |phi|.
PHI_TOL = 1e-3
#: Counts against JAX's bf16 counts: one pair on the other side of a
#: threshold in both orders, twice over (tests/test_torch_wide.py).
COUNT_SLACK = 4
#: The port's bf16 result lies at least this many times nearer JAX's bf16
#: result than JAX's float32 one.
CLOSER = 4.0
#: Drivers in float32 over 3 AdaGrad steps (test_torch_panel.py's bound
#: for a float32 driver pair: AdaGrad divides phi by its running norm).
DRIVER_TOL = dict(rtol=2e-3, atol=2e-4)


def _inputs(n, m, offset, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, m)) * 1.5 + offset).astype(np.float32)
    s = rng.normal(size=(n, m)).astype(np.float32)
    return x, s


def _thresholds(m):
    return np.linspace(0.5, 4.0 * m, 4).astype(np.float32)


def _dist(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _held(got, want_bf16, want_f32):
    """phi (and counts, where given) of the port's bf16 plain version
    against JAX's bf16 and float32 results."""
    if isinstance(got, tuple):
        cnt = got[1].numpy()
        assert np.abs(cnt - np.asarray(want_bf16[1]).astype(np.int64)).max() \
            <= COUNT_SLACK
        got, want_bf16, want_f32 = got[0], want_bf16[0], want_f32[0]
    near, far = _dist(got.numpy(), want_bf16), _dist(got.numpy(), want_f32)
    assert near <= PHI_TOL, near
    assert CLOSER * near < far, (near, far)


def _jax_fused(x, s, g, thr, sym, dot_dtype):
    return pj.phi_rbf_fused_pallas(
        jnp.asarray(x), jnp.asarray(s), g, jnp.asarray(thr), tile_i=32,
        tile_j=64, interpret=True, dot_dtype=dot_dtype, sym=sym)


# ----------------------------------------------------------------------
# The plain versions against the JAX bf16 kernels
# ----------------------------------------------------------------------


@pytest.mark.parametrize("m", [2, 11, 16, 17, 50, 65])
@pytest.mark.parametrize("cross", [False, True])
def test_k1_bf16_vs_jax(m, cross):
    x, s = _inputs(300, m, 1.0, 900 + m)
    g, thr = np.float32(0.5 / m), _thresholds(m)
    cuda_phi.reset_launch_counts()
    if cross:
        xt = _inputs(130, m, 1.2, 910 + m)[0]

        def jax_run(dd):
            return pj.phi_rbf_fused_pallas_cross(
                jnp.asarray(xt), jnp.asarray(x), jnp.asarray(s), g,
                jnp.asarray(thr), tile_i=32, tile_j=64, interpret=True,
                dot_dtype=dd)
        got = cuda_phi.phi_rbf_fused_cuda_cross(
            *map(torch.from_numpy, (xt, x, s)), torch.tensor(g),
            torch.from_numpy(thr), dot_dtype=BF16)
    else:
        def jax_run(dd):
            return _jax_fused(x, s, g, thr, False, dd)
        got = cuda_phi.phi_rbf_fused_cuda(
            *map(torch.from_numpy, (x, s)), torch.tensor(g),
            torch.from_numpy(thr), sym=False, dot_dtype=BF16)
    assert not any(cuda_phi.launch_counts.values())  # the plain version
    _held(got, jax_run(BF16), jax_run("float32"))


@pytest.mark.parametrize("m", [2, 11, 16, 17, 65])
def test_k2_bf16_vs_jax(m):
    x, s = _inputs(300, m, -1.0, 920 + m)
    g, thr = np.float32(0.5 / m), _thresholds(m)
    got = cuda_phi.phi_rbf_fused_cuda(
        *map(torch.from_numpy, (x, s)), torch.tensor(g),
        torch.from_numpy(thr), sym=True, dot_dtype=BF16)
    _held(got, _jax_fused(x, s, g, thr, True, BF16),
          _jax_fused(x, s, g, thr, True, "float32"))
    # The triangle's plain version is the single-rank chunk finished.
    want = pht.phi_rbf_sym_fused_counts(
        *map(torch.from_numpy, (x, s)), torch.tensor(g),
        torch.from_numpy(thr), BF16)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())


@pytest.mark.parametrize("m", [2, 11, 16, 17, 65])
def test_k3_bf16_vs_jax(m):
    x, s = _inputs(300, m, 0.5, 930 + m)
    g, thr = np.float32(0.5 / m), _thresholds(m)
    got = cuda_phi.phi_rbf_fused_cuda(
        *map(torch.from_numpy, (x, s)), torch.tensor(g),
        torch.from_numpy(thr), sym="panel", dot_dtype=BF16)
    _held(got, _jax_fused(x, s, g, thr, "panel", BF16),
          _jax_fused(x, s, g, thr, "panel", "float32"))


@pytest.mark.parametrize("m", [2, 11])
@pytest.mark.parametrize("psd", [True, False])
def test_k15_bf16_vs_jax(m, psd):
    x, s = _inputs(300, m, 1.0, 940 + m)
    rng = np.random.default_rng(941 + m)
    a = rng.normal(size=(m, m))
    if psd:
        p = (0.5 * np.eye(m) + a @ a.T / m) / m
    else:
        p = (np.diag(np.linspace(1.0, -0.3, m)) + 0.05 * a) / m
    p = p.astype(np.float32)

    def jax_run(dd):
        return pj.phi_rbf_pallas(jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(p), tile_i=32, tile_j=32,
                                 interpret=True, psd=psd, dot_dtype=dd)
    got = cuda_phi.phi_rbf_cuda(*map(torch.from_numpy, (x, s, p)), psd=psd,
                                dot_dtype=BF16)
    _held(got, jax_run(BF16), jax_run("float32"))


def test_bf16_takes_one_rbf_and_known_dtypes():
    x, s = (torch.from_numpy(a) for a in _inputs(40, 3, 0.0, 950))
    thr = torch.tensor([1.0, 2.0])
    with pytest.raises(ValueError, match="one positive RBF"):
        pht.phi_rbf_terms_cross_fused_counts(x, x, s, [0.5, 0.1],
                                             [1.0, -1.0], thr,
                                             dot_dtype=BF16)
    for call in (
        lambda: cuda_phi.phi_rbf_fused_cuda(x, s, 0.5, thr,
                                            dot_dtype="float16"),
        lambda: cuda_phi.phi_rbf_fused_cuda_cross(x, x, s, 0.5, thr,
                                                  dot_dtype="bf16"),
        lambda: cuda_phi.phi_rbf_cuda(x, s, torch.eye(3), dot_dtype=None),
        lambda: pht.phi_rbf_fused_counts(x, s, 0.5, thr,
                                         dot_dtype=torch.bfloat16),
    ):
        with pytest.raises(ValueError, match="float32.*bfloat16"):
            call()


# ----------------------------------------------------------------------
# The drivers
# ----------------------------------------------------------------------


def _mvn(pkg, x0, impl, dot_dtype, iters=3, mesh=None, **kw):
    n, dim = x0.shape
    model = pkg.MultivariateNormal(np.zeros(dim, np.float32),
                                   np.eye(dim, dtype=np.float32))
    kernel = pkg.GaussianRBFKernel(x0, pkg.ScaleMethod.MEDIAN, model)
    extra = {"device": "cpu"} if pkg is st else {}
    if mesh is not None:
        extra["mesh"] = mesh
    return pkg.SVGD(pkg.SVGDOptions(
        dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model, optimizer=pkg.AdaGrad(dim, n, 0.1),
        phi_impl=impl, fused_dot_dtype=dot_dtype, **kw, **extra,
    )).initialize()


def _x0(n, seed):
    return (np.random.default_rng(seed).normal(size=(n, 2)) * 2).astype(
        np.float32)


def test_driver_fused_cuda_bf16_vs_jax_fused_pallas():
    x0 = _x0(600, 960)
    s_t = _mvn(st, x0, "fused_cuda", BF16)
    assert s_t._phi_impl == "fused_cuda"
    got = s_t.run().numpy()
    assert np.isfinite(got).all()
    want = np.asarray(_mvn(sv, x0, "fused_pallas", BF16).run())
    np.testing.assert_allclose(got, want, **DRIVER_TOL)
    f32 = np.asarray(_mvn(sv, x0, "fused_pallas", "float32").run())
    assert CLOSER * _dist(got, want) < _dist(got, f32)


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


def test_mesh_driver_bf16_takes_the_cross_sweep(group):
    x0 = _x0(96, 961)
    meshed = _mvn(st, x0, "fused_cuda", BF16, mesh=group)
    assert meshed.fused_sym_form is False
    got = meshed.run().numpy()
    plain = _mvn(st, x0, "fused_cuda", BF16, fused_sym=False).run().numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-7)
    # JAX's driver refuses 'fused_pallas' under a mesh off a TPU; its
    # meshless bf16 square sweep computes the same function.
    with pytest.raises(ValueError, match="TPU backend"):
        _mvn(sv, x0, "fused_pallas", BF16, mesh=make_particle_mesh())
    want = np.asarray(_mvn(sv, x0, "fused_pallas", BF16).run())
    np.testing.assert_allclose(got, want, **DRIVER_TOL)
    for sym in (True, "full", "panel"):
        with pytest.raises(ValueError, match="fused_dot_dtype='float32'"):
            _mvn(st, x0, "fused_cuda", BF16, mesh=group, fused_sym=sym)


def test_engine_bf16_takes_the_cross_sweep(group):
    n, m = 96, 2
    x0 = torch.from_numpy(_x0(n, 962)).double()
    model = st.MultivariateNormal(np.zeros(m), np.eye(m))
    out = {}
    for dd in ("float32", BF16):
        eng = ShardedSVGD(model, st.AdaGrad(m, n, 0.1), n, m, mesh=group,
                          config=ShardedSVGDConfig(
                              fused_phi=True, fused_cuda=True,
                              fused_dot_dtype=dd))
        assert eng._fused_sym is False  # the cross sweep at this n
        out[dd] = eng.run(x0, 3).numpy()
    assert np.isfinite(out[BF16]).all()
    assert not np.array_equal(out[BF16], out["float32"])
    assert _dist(out[BF16], out["float32"]) < 5e-2


def test_cuda_route_ignores_bf16():
    """As JAX's 'pallas' route, the port's 'cuda' route runs its float32
    K15 whatever fused_dot_dtype says."""
    x0 = _x0(64, 963)
    runs = [_mvn(st, x0, "cuda", dd, iters=3).run().numpy()
            for dd in ("float32", BF16)]
    np.testing.assert_array_equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        _mvn(st, x0, "fused_cuda", "float16")
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        ShardedSVGDConfig(fused_dot_dtype="float16")


# ----------------------------------------------------------------------
# The bf16 wrappers on a stand-in library
# ----------------------------------------------------------------------


def _stand_in(monkeypatch, calls):
    """A library that records each launch and answers the square launch's
    split count with sym_plan's copy (tests/test_torch_wide.py's
    stand-in), the card's context managers stood in."""
    from contextlib import nullcontext
    from types import SimpleNamespace

    from svgdcpp_tpu_torch.ops import sym_plan

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

    monkeypatch.setattr(cuda_phi, "_require_cuda", lambda tensor: None)
    monkeypatch.setattr(cuda_phi, "load_library", Library)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("m", [2, 11, 123])
def test_bf16_wrappers_launch_their_own_entries(monkeypatch, m):
    """On a CUDA tensor (meta tensors and a stand-in library here) each
    form launches its bf16 entry once at any m, counted under its own key,
    and never the float32 one: K1 square and cross (its pack, then its
    entry, with its own body's split count at every m), K2, K3 and K15 (no
    decomposition; the unpadded rows, n, m and psd)."""
    from svgdcpp_tpu_torch.ops import sym_plan

    calls = []
    _stand_in(monkeypatch, calls)
    n = 3000
    x, g, thr = (torch.empty(shape, device="meta")
                 for shape in ((n, m), (), (3,)))
    runs = [
        ("svgd_fused_phi_counts_square_bf16", cuda_phi.SQUARE_BF16_KERNEL,
         lambda: cuda_phi.phi_rbf_fused_cuda(x, x, g, thr, sym=False,
                                             dot_dtype=BF16)),
        ("svgd_fused_phi_counts_square_bf16", cuda_phi.SQUARE_BF16_KERNEL,
         lambda: cuda_phi.phi_rbf_fused_cuda_cross(x[:700], x, x, g, thr,
                                                   dot_dtype=BF16)),
        ("svgd_fused_phi_counts_sym_bf16", cuda_phi.SYM_BF16_KERNEL,
         lambda: cuda_phi.phi_rbf_fused_cuda(x, x, g, thr, sym=True,
                                             dot_dtype=BF16)),
        ("svgd_fused_phi_counts_sympanel_bf16", cuda_phi.SYMPANEL_BF16_KERNEL,
         lambda: cuda_phi.phi_rbf_fused_cuda(x, x, g, thr, sym="panel",
                                             dot_dtype=BF16)),
        ("svgd_phi_rbf_wide_bf16", cuda_phi.PHI_RBF_WIDE_BF16_KERNEL,
         lambda: cuda_phi.phi_rbf_cuda(x, x, torch.empty((m, m), device="meta"),
                                       dot_dtype=BF16)),
    ]
    for entry, kernel, call in runs:
        del calls[:]
        cuda_phi.reset_launch_counts()
        call()
        launches = [c for c in calls
                    if not c[0].endswith(("_splits", "_work_bytes"))]
        square = "square" in entry
        assert [c[0] for c in launches] == (
            ["svgd_square_bf16_pack", entry] if square else [entry])
        assert m in launches[-1][1]
        assert cuda_phi.launch_counts[kernel] == 1
        assert sum(cuda_phi.launch_counts.values()) == 1
        if square:  # (q_t, q_s, targets, gamma, thr, n_t, n_s, m, T,
            # square, phi, counts, work, splits, stream)
            args = launches[-1][1]
            assert args[-2] == sym_plan.square_splits(args[5], args[6], m,
                                                      bf16=True)
        if kernel == cuda_phi.PHI_RBF_WIDE_BF16_KERNEL:  # (coords, y, q,
            # scores, n, m, psd, work, out, stream): the unpadded rows
            assert launches[-1][1][4:7] == (n, m, 1)
    cuda_phi.reset_launch_counts()
