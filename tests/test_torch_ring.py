"""The ring schedule of svgdcpp_tpu_torch against svgdcpp_tpu's.

* Primitives (``parallel/ring.py``) on a one-rank in-process gloo group
  against the JAX package's ring functions under ``shard_map`` on the
  8-device CPU mesh, float64: ``ring_phi_rbf`` (PSD and indefinite P) and
  the dense phi, ``ring_phi_rbf_terms`` and ``ring_phi_generic`` of a
  composed kernel (rtol 1e-9); ``ring_pairwise_median`` against the exact
  median and JAX's; ``ring_count_le`` equal to the gather counts
  (``centered_count_env`` with the sources) and to JAX's float32 counts;
  the off-centre float32 cluster of ``tests/test_sharded.py``. The
  rotation itself runs only in the spawned worlds of 2, 3 and 4 ranks
  (``tests/torch_sharded_worker.py``), which hold the same functions to
  JAX there.
* Runs: ``ShardedSVGD(phi_mode='ring')`` against gather mode and against
  the JAX engine's ring run (the built-in RBF cold and warm, HESSIAN and
  CONSTANT scales, a composed kernel as RBF terms and through the generic
  sweep; rtol 1e-7 / atol 1e-10 as ``tests/test_algebra.py`` holds the
  JAX pair, 1e-8 against JAX); ring mode makes no ``all_gather_rows``
  call; the options that need gather mode still raise.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.parallel import ShardedSVGD as JaxSharded
from svgdcpp_tpu.parallel import ShardedSVGDConfig as JaxConfig
from svgdcpp_tpu.parallel import make_particle_mesh
from svgdcpp_tpu.parallel import ring as ring_j
from svgdcpp_tpu_torch.kernels.algebra import flatten_rbf_terms
from svgdcpp_tpu_torch.ops.median import (
    centered_count_env,
    pairwise_distance_median_exact,
)
from svgdcpp_tpu_torch.ops.phi import phi_rbf
from svgdcpp_tpu_torch.parallel import (
    ParticleGroup,
    ShardedSVGD,
    ShardedSVGDConfig,
    initialize_distributed,
)
from svgdcpp_tpu_torch.parallel import ring as ring_t

torch.set_num_threads(1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo world in this process."""
    g = initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0,
                               device="cpu")
    yield g
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8
    return make_particle_mesh()


def jax_sharded(mesh, fn, *arrays, out_rows=True):
    """``fn(*local arrays, axis)`` under shard_map over the mesh's axis."""
    axis = mesh.axis_names[0]
    spec = P(axis, None)
    return np.asarray(jax.jit(jax.shard_map(
        lambda *a: fn(*a, axis), mesh=mesh,
        in_specs=tuple(spec for _ in arrays),
        out_specs=spec if out_rows else P(),
    ))(*[jnp.asarray(a) for a in arrays]))


def inputs(n=40, m=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, m)) * 1.5 + 2.0, rng.normal(size=(n, m))


def test_rotate_on_one_rank_is_the_tensor(group):
    t = torch.arange(6.0).reshape(3, 2)
    assert group.rotate(t) is t


@pytest.mark.parametrize("psd", [True, False])
def test_ring_phi_matches_jax_and_dense(group, mesh, psd):
    x, s = inputs()
    m = x.shape[1]
    p = np.eye(m) * 0.7 + 0.1
    if not psd:  # an indefinite P, the quadratic form left unclamped
        p = p - np.diag([0.0, 0.0, 0.9])
    got = ring_t.ring_phi_rbf(torch.from_numpy(x), torch.from_numpy(s),
                              torch.from_numpy(p), group, 40, psd=psd,
                              row_tile=16).numpy()
    want = jax_sharded(mesh, lambda c, sc, ax: ring_j.ring_phi_rbf(
        c, sc, jnp.asarray(p), ax, 40, psd=psd, row_tile=16), x, s)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    dense = phi_rbf(torch.from_numpy(x), torch.from_numpy(s),
                    torch.from_numpy(p), psd=psd).numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-9, atol=1e-12)


def composed_kernel(pkg, x):
    m = x.shape[1]
    return pkg.GaussianRBFKernel(
        x, pkg.ScaleMethod.CONSTANT, constant_scale=0.5 * np.eye(m)
    ) - pkg.GaussianRBFKernel(
        x, pkg.ScaleMethod.CONSTANT,
        constant_scale=np.diag(np.linspace(0.1, 0.3, m)),
    ) * pkg.GaussianRBFKernel(
        x, pkg.ScaleMethod.CONSTANT, constant_scale=0.2 * np.eye(m)
    )


def test_ring_terms_and_generic_match_jax(group, mesh):
    from svgdcpp_tpu.kernels.algebra import flatten_rbf_terms as flatten_j

    x, s = inputs(seed=1)
    kt, kj = composed_kernel(st, x), composed_kernel(sv, x)
    terms_t, terms_j = flatten_rbf_terms(kt), flatten_j(kj)
    assert len(terms_t) == 2
    pt = tuple(torch.as_tensor(np.asarray(p)) for p in kt.parameters)
    pj_ = tuple(jnp.asarray(np.asarray(p)) for p in kj.parameters)
    xt, stt = torch.from_numpy(x), torch.from_numpy(s)
    got = ring_t.ring_phi_rbf_terms(xt, stt, pt, terms_t, group, 40,
                                    row_tile=16).numpy()
    want = jax_sharded(mesh, lambda c, sc, ax: ring_j.ring_phi_rbf_terms(
        c, sc, pj_, terms_j, ax, 40, row_tile=16), x, s)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    gen = ring_t.ring_phi_generic(xt, stt, kt.kernel_pure, pt, group, 40,
                                  row_tile=8).numpy()
    gen_j = jax_sharded(mesh, lambda c, sc, ax: ring_j.ring_phi_generic(
        c, sc, kj.kernel_pure, pj_, ax, 40, 8), x, s)
    np.testing.assert_allclose(gen, gen_j, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(gen, got, rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError, match="psd_flags has 1 entries"):
        ring_t.ring_phi_rbf_terms(xt, stt, pt, terms_t, group, 40,
                                  psd_flags=[True])


def test_ring_median_matches_exact_and_jax(group, mesh):
    x = np.random.default_rng(42).normal(size=(64, 3))
    got = float(ring_t.ring_pairwise_median(torch.from_numpy(x), group, 64,
                                            bins=16, passes=8))
    exact = float(pairwise_distance_median_exact(torch.from_numpy(x)))
    assert abs(got - exact) <= 1e-5 * exact
    want = float(jax_sharded(mesh, lambda c, ax: ring_j.ring_pairwise_median(
        c, ax, 64, bins=16, passes=8), x, out_rows=False))
    assert got == pytest.approx(want, rel=1e-9)
    scale = ring_t.ring_median_scale(torch.from_numpy(x), group, 64,
                                     bins=16, passes=8)
    np.testing.assert_allclose(scale.numpy(),
                               np.log(64) / got ** 2 * np.eye(3), rtol=1e-12)


def test_ring_counts_equal_gather_counts_and_jax(group, mesh):
    x = np.random.default_rng(3).normal(size=(64, 3)) + 5.0
    # Not at 0: there a self pair counts by the sign of the Gram identity's
    # rounding, which each package's centering decides on its own.
    thr = np.linspace(0.05, 12.0, 17)
    xt = torch.from_numpy(x)
    got = ring_t.ring_count_le(xt, torch.from_numpy(thr), group, 64,
                               row_tile=16)
    assert got.dtype == torch.int64
    count_fn, _ = centered_count_env(xt, xt, group=group, n_global=64)
    assert torch.equal(got, count_fn(torch.from_numpy(thr)))
    want = jax_sharded(mesh, lambda c, ax: ring_j.ring_count_le(
        c, jnp.asarray(thr), ax, 64, row_tile=16), x, out_rows=False)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_ring_phi_off_center_f32(group):
    """Global-mean centering keeps float32 clusters far from the origin
    accurate (the JAX package's test_ring_phi_off_center_f32)."""
    rng = np.random.default_rng(42)
    n, m = 64, 2
    coords64 = np.array([50.0, -30.0]) + 1e-3 * rng.normal(size=(n, m))
    scores64 = rng.normal(size=(n, m))
    gamma = np.log(n) / (2e-3) ** 2
    p64 = gamma * np.eye(m)
    d = coords64[:, None, :] - coords64[None, :, :]
    k = np.exp(-gamma * (d ** 2).sum(-1))
    phi64 = (k @ scores64 + np.einsum("ij,ijk->ik", k, d @ (2 * p64))) / n
    out = ring_t.ring_phi_rbf(
        torch.tensor(coords64, dtype=torch.float32),
        torch.tensor(scores64, dtype=torch.float32),
        torch.tensor(p64, dtype=torch.float32), group, n,
    ).double().numpy()
    rel = np.abs(out - phi64).max() / np.abs(phi64).max()
    assert rel < 2e-2, rel


# ----------------------------------------------------------------------
# Ring runs of the engine
# ----------------------------------------------------------------------

RUN_CASES = {
    # name -> (kernel builder or None, config kwargs, steps)
    "rbf_cold": (None, dict(median_bins=16, median_passes=10, row_tile=4,
                            warm_start=False), 8),
    "rbf_warm": (None, dict(median_bins=16, median_passes=4, row_tile=4), 15),
    "hessian": (None, dict(scale_method="HESSIAN", row_tile=4), 6),
    "constant": (None, dict(scale_method="CONSTANT",
                            constant_scale=0.8 * np.eye(2), row_tile=4), 6),
    "rbf_terms": ("product", dict(median_bins=16, median_passes=10,
                                  row_tile=4, warm_start=False,
                                  kernel_phi="rbf_terms"), 5),
    "generic": ("sum", dict(median_bins=16, median_passes=10, row_tile=4,
                            warm_start=False, kernel_phi="generic"), 5),
}


def run_kernel(pkg, kind, x0, model):
    m = x0.shape[1]
    med = pkg.GaussianRBFKernel(x0, pkg.ScaleMethod.MEDIAN, model,
                                median_method="exact")
    other = pkg.GaussianRBFKernel(x0, pkg.ScaleMethod.CONSTANT,
                                  constant_scale=(0.05 if kind == "product"
                                                  else 0.25) * np.eye(m))
    return med * other if kind == "product" else med + other


def run_engine(pkg, where, x0, name, mode):
    kind, cfg, steps = RUN_CASES[name]
    cfg = dict(cfg, phi_mode=mode)
    if "scale_method" in cfg:
        cfg["scale_method"] = pkg.ScaleMethod[cfg["scale_method"]]
    n, m = x0.shape
    model = pkg.MultivariateNormal(np.zeros(m), np.eye(m))
    engine, config = ((ShardedSVGD, ShardedSVGDConfig) if pkg is st
                      else (JaxSharded, JaxConfig))
    eng = engine(model, pkg.AdaGrad(m, n, 0.1), num_particles=n, dimension=m,
                 mesh=where, config=config(**cfg),
                 kernel=None if kind is None else run_kernel(pkg, kind, x0,
                                                             model))
    return np.asarray(eng.run(x0.copy(), steps))


@pytest.mark.parametrize("name", list(RUN_CASES))
def test_ring_run_matches_gather_and_jax(group, mesh, name):
    x0 = np.random.default_rng(11).normal(size=(32, 2)) * 2
    ring = run_engine(st, group, x0, name, "ring")
    want = run_engine(sv, mesh, x0, name, "ring")
    np.testing.assert_allclose(ring, want, rtol=1e-8, atol=1e-10)
    gather = run_engine(st, group, x0, name, "gather")
    if name == "rbf_warm":
        # Gather mode's warm median starts from a pair-sample bracket, which
        # ring mode has no global set for: bandwidth-level differences only
        # (the JAX test's bound).
        assert np.abs(ring - gather).max() < 5e-2
    else:
        np.testing.assert_allclose(ring, gather, rtol=1e-7, atol=1e-10)


def test_ring_mode_makes_no_gather(group, monkeypatch):
    """No all_gather_rows runs in a ring step (run_state; run() gathers the
    result once at the end, as in gather mode)."""
    calls = []
    real = ParticleGroup.all_gather_rows

    def counting(self, t):
        calls.append(tuple(t.shape))
        return real(self, t)

    monkeypatch.setattr(ParticleGroup, "all_gather_rows", counting)
    x0 = np.random.default_rng(4).normal(size=(16, 2))
    for kind, cfg in ((None, {}), ("product", {"kernel_phi": "rbf_terms"}),
                      ("sum", {"kernel_phi": "generic"}),
                      (None, {"warm_start": False})):
        model = st.MultivariateNormal(np.zeros(2), np.eye(2))
        eng = ShardedSVGD(
            model, st.AdaGrad(2, 16, 0.1), 16, 2, mesh=group,
            kernel=None if kind is None else run_kernel(st, kind, x0, model),
            config=ShardedSVGDConfig(phi_mode="ring", row_tile=4,
                                     median_passes=3, track_stats=True,
                                     **cfg))
        state = eng.run_state(eng.init_state(x0), 3)
        assert calls == [] and state["iteration"] == 3
    gather = ShardedSVGD(st.MultivariateNormal(np.zeros(2), np.eye(2)),
                         st.AdaGrad(2, 16, 0.1), 16, 2, mesh=group,
                         config=ShardedSVGDConfig(row_tile=4))
    gather.run_state(gather.init_state(x0), 1)
    assert calls == [(16, 2), (16, 2)]  # the check sees the gather mode's


def test_ring_keeps_the_gather_only_options():
    with pytest.raises(ValueError, match="phi_mode='gather'"):
        ShardedSVGDConfig(phi_mode="ring", fused_phi=True)
    with pytest.raises(ValueError, match="phi_mode='gather'"):
        ShardedSVGDConfig(phi_mode="ring", log_intermediate_matrices=True)
