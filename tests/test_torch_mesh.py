"""The driver under SVGDOptions.mesh: svgdcpp_tpu_torch against svgdcpp_tpu.

* Parity: the port's driver with ``mesh=<one-rank in-process gloo group>``
  against the port's driver without a mesh and against the JAX driver with
  ``mesh=make_particle_mesh()`` (8 CPU devices, GSPMD), float64, rtol 1e-8
  / atol 1e-10 (``tests/test_fused.py:495-525`` holds the JAX pair to
  1e-6): the routes dense (exact median), dense at n = 600 (the warm
  median), blocked, fused, rbf_terms, fused_terms, generic on a custom
  kernel, and fused_cuda / fused_terms_cuda, whose plain chunk forms
  ("full", "panel") and cross form run on CPU tensors, against the JAX
  package's 'fused' / 'fused_terms' under its mesh.
* auto's choice under a mesh equals the JAX package's; under a mesh the
  anisotropic kernel route is never taken.
* Raises: 'fused_aniso_terms_cuda' and 'cuda', a mesh that is not a
  ParticleGroup, a particle count that does not split evenly (naming
  ROADMAP item 11e), a forced fused_sym=True in the cross regime.
* Under a mesh as without one (one rank, equal to 1e-12): track_stats,
  bounds, annealing, a hooked model, hot-swaps, the debug dump; a
  checkpoint saved under a mesh resumes exactly.
* The dry run (``parallel/dryrun.py``) on 2 and 4 spawned gloo ranks.

The rotation of rows between ranks runs in the spawned worlds of 2, 3 and
4 ranks of ``tests/test_torch_sharded.py`` (``torch_sharded_worker.py``),
which hold the driver under a mesh to the JAX driver there.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.parallel import make_particle_mesh
from svgdcpp_tpu_torch.parallel import ParticleGroup, initialize_distributed

torch.set_num_threads(1)

MEAN = np.array([-0.6871, 0.8010])
COV = 5.0 * np.array([[0.2260, 0.1652], [0.1652, 0.6779]])


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


def rbf(pkg, x0, model, **kw):
    return pkg.GaussianRBFKernel(x0, pkg.ScaleMethod.MEDIAN, model, **kw)


def composed(pkg, x0, model):
    return rbf(pkg, x0, model, median_method="exact") + pkg.GaussianRBFKernel(
        x0, pkg.ScaleMethod.CONSTANT, constant_scale=0.25 * np.eye(2))


def imq(pkg, x0, model):
    """RBF(median) + an inverse-multiquadric leaf: a kernel that does not
    flatten to RBF terms."""
    lib = torch if pkg is st else jnp

    def fn(x, params, loc):
        d = x - loc
        return 1.0 / lib.sqrt(1.0 + params[0] * (d @ d))

    return rbf(pkg, x0, model, median_method="exact") + pkg.Kernel(
        2, fn, (np.asarray(0.5),))


def build(pkg, x0, iters, impl, where=None, kernel=rbf, model=None, **kw):
    n, dim = x0.shape
    model = model(pkg) if model else pkg.MultivariateNormal(MEAN, COV)
    opts = dict(dimension=dim, num_iterations=iters,
                coordinate_matrix=x0.copy(), kernel=kernel(pkg, x0, model),
                model=model, optimizer=pkg.AdaGrad(dim, n, 0.1),
                phi_impl=impl, mesh=where, **kw)
    if pkg is st:
        opts["device"] = "cpu"
    return pkg.SVGD(pkg.SVGDOptions(**opts)).initialize()


def x0_for(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 2)) * 2.0


CASES = {
    # name -> (n, port route, kernel, extra options, JAX route, steps)
    "dense": (64, "dense", rbf, {}, "dense", 8),
    "dense_warm": (600, "dense", rbf, {}, "dense", 6),
    "blocked": (96, "blocked", rbf, {"row_tile": 16}, "blocked", 6),
    "fused": (600, "fused", rbf, {}, "fused", 6),
    "rbf_terms": (64, "rbf_terms", composed, {}, "rbf_terms", 6),
    "fused_terms": (96, "fused_terms", composed, {}, "fused_terms", 6),
    "generic": (32, "generic", imq, {"row_tile": 8}, "generic", 5),
    "fused_cuda_cross": (96, "fused_cuda", rbf, {"fused_sym": False},
                         "fused", 6),
    "fused_cuda_full": (96, "fused_cuda", rbf, {"fused_sym": "full"},
                        "fused", 6),
    "fused_cuda_panel": (96, "fused_cuda", rbf, {"fused_sym": "panel"},
                         "fused", 6),
    "fused_terms_cuda_full": (96, "fused_terms_cuda", composed,
                              {"fused_sym": "full"}, "fused_terms", 6),
}


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_matches_meshless_and_jax(group, mesh, name):
    n, impl, kernel, extra, jax_impl, steps = CASES[name]
    x0 = x0_for(n, seed=len(name))
    meshed = build(st, x0, steps, impl, group, kernel, **extra)
    if impl == "fused_cuda":
        assert meshed.fused_sym_form == (extra["fused_sym"] or False)
    got = meshed.run().numpy()
    if impl.startswith("fused"):
        assert meshed.median_fallbacks == 0
    # The meshless driver's name of the full-width triangle is True.
    meshless_extra = {k: True if v == "full" else v for k, v in extra.items()}
    plain = build(st, x0, steps, impl, None, kernel, **meshless_extra).run()
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-8, atol=1e-10)
    jax_extra = {k: v for k, v in extra.items() if k != "fused_sym"}
    want = np.asarray(build(sv, x0, steps, jax_impl, mesh, kernel,
                            **jax_extra).run())
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def aniso_kernel(pkg, x0, model):
    return rbf(pkg, x0, model) + pkg.GaussianRBFKernel(
        x0, pkg.ScaleMethod.CONSTANT,
        constant_scale=np.array([[0.3, 0.1], [0.1, 0.2]]))


@pytest.mark.parametrize("n,kernel", [(64, "rbf"), (2048, "rbf"),
                                      (64, "composed"), (2048, "composed"),
                                      (32, "imq"), (2048, "aniso")])
def test_auto_under_a_mesh_equals_jax(group, mesh, n, kernel):
    kern = {"rbf": rbf, "composed": composed, "imq": imq,
            "aniso": aniso_kernel}[kernel]
    x0 = x0_for(n, seed=5)
    got = build(st, x0, 1, "auto", group, kern)
    want = build(sv, x0, 1, "auto", mesh, kern)
    assert got._phi_impl == want._phi_impl
    if kernel == "aniso":  # the anisotropic kernel route is single-device
        assert build(st, x0, 1, "auto", None,
                     kern)._aniso_terms_kernel_route()
        assert not got._aniso_terms_kernel_route()


@pytest.mark.parametrize("impl,kernel", [("fused_aniso_terms_cuda",
                                          aniso_kernel), ("cuda", rbf)])
def test_single_device_kernel_routes_raise_under_a_mesh(group, impl, kernel):
    with pytest.raises(ValueError, match="does not support SVGDOptions.mesh"):
        build(st, x0_for(64), 1, impl, group, kernel)


def test_bad_meshes_raise(group):
    with pytest.raises(TypeError, match="ParticleGroup"):
        build(st, x0_for(16), 1, "auto", object())
    fake = ParticleGroup(None, 0, 3, torch.device("cpu"), "gloo")
    # 16 particles over 3 ranks: the plain routes take it, the kernel
    # routes' sharded forms raise (uneven_split tests below).
    assert build(st, x0_for(16), 1, "dense", fake).make_state()[
        "coords"].shape == (6, 2)
    with pytest.raises(ValueError, match="duplicates"):
        build(st, x0_for(16), 1, "fused_cuda", fake)
    with pytest.raises(ValueError, match="fused_sym=True requires"):
        build(st, x0_for(64), 1, "fused_cuda", group, fused_sym=True)
    # Coordinates go to the group's device: an array raises there without
    # a CUDA device, a tensor elsewhere raises.
    on_card = ParticleGroup(None, 0, 1, torch.device("cuda", 0), "nccl")
    with pytest.raises(RuntimeError, match="CUDA"):
        build(st, x0_for(16), 1, "dense", on_card)
    x0 = torch.from_numpy(x0_for(16))
    model = st.MultivariateNormal(MEAN, COV)
    with pytest.raises(ValueError, match="SVGDOptions.mesh"):
        st.SVGD(st.SVGDOptions(
            dimension=2, num_iterations=1, coordinate_matrix=x0,
            kernel=rbf(st, x0, model), model=model,
            optimizer=st.AdaGrad(2, 16, 0.1), mesh=on_card))


def hooked(pkg):
    class Hooked(pkg.MultivariateNormal):
        def step(self):
            self.update_parameters((self.parameters[0] * 0.9,
                                    self.parameters[1]))
    return Hooked(MEAN, COV)


@pytest.mark.parametrize("impl,extra", [
    ("dense", {"track_stats": True}),
    ("fused", {"track_stats": True}),
    ("dense", {"lower_bound": np.array([-1.0, -0.5]), "upper_bound": 0.8}),
    ("fused", {"annealing": np.linspace(0.2, 1.0, 6)}),
    ("dense", {"hooked": True}),
])
def test_options_under_a_mesh_as_without(group, impl, extra):
    extra = dict(extra)
    model = hooked if extra.pop("hooked", False) else None
    x0 = x0_for(96, seed=8)
    runs = [build(st, x0, 6, impl, where, model=model, **extra)
            for where in (group, None)]
    outs = [r.run().numpy() for r in runs]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-12, atol=1e-14)
    if "track_stats" in extra:
        for key, want in runs[1].stats.items():
            np.testing.assert_allclose(runs[0].stats[key], want, rtol=1e-12,
                                       err_msg=key)
    if model is not None:
        assert not np.allclose(outs[0], build(st, x0, 6, impl, group).run())
    if "lower_bound" in extra:
        assert outs[0].max() <= 0.8 and outs[0][:, 1].min() >= -0.5


def test_hot_swaps_and_continuation_under_a_mesh(group):
    x0 = x0_for(64, seed=9)
    runs = [build(st, x0, 4, "rbf_terms", where, composed)
            for where in (group, None)]
    for r in runs:
        r.run()
        params = list(r.kernel.parameters)
        params[1] = 0.4 * np.eye(2)
        r.update_kernel_parameters(params)
        r.update_model_parameters((MEAN * 0.5, COV))
        r.step()
        r.run()
    np.testing.assert_allclose(runs[0].store.value.numpy(),
                               runs[1].store.value.numpy(), rtol=1e-12,
                               atol=1e-14)
    assert runs[0]._iteration == 9


def test_debug_dump_under_a_mesh(group, tmp_path):
    x0 = x0_for(16, seed=10)
    logs = []
    for where, name in ((group, "mesh"), (None, "plain")):
        path = tmp_path / f"{name}.txt"
        s = build(st, x0, 3, "auto", where, log_intermediate_matrices=True,
                  intermediate_matrices_output_path=str(path))
        assert s._phi_impl == "generic"
        s.run()
        logs.append((s._intermediate_logs, path.read_bytes()))
    for key, want in logs[1][0].items():
        np.testing.assert_allclose(logs[0][0][key], want, rtol=1e-12,
                                   atol=1e-14, err_msg=key)
    assert logs[0][0]["kernel"].shape == (3, 16, 16)
    assert logs[0][1].count(b"========== Step") == 3


def test_checkpoint_under_a_mesh_resumes_exactly(group, tmp_path):
    from svgdcpp_tpu_torch.parallel.sharded import ShardedState
    from svgdcpp_tpu_torch.utils.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    x0 = x0_for(600, seed=11)

    def driver(iters):
        return build(st, x0, iters, "fused", group)

    full = driver(10).run()
    first = driver(5)
    first.run()
    state = first.make_state()
    assert isinstance(state, ShardedState)
    save_checkpoint(tmp_path / "ck", state, step=5)
    second = driver(5)
    restored, step = restore_checkpoint(tmp_path / "ck", second.make_state())
    assert step == 5 and restored["iteration"] == 5
    second._absorb_state(restored)
    np.testing.assert_array_equal(second.run().numpy(), full.numpy())


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_dryrun_multichip(n_ranks, capfd):
    from svgdcpp_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(n_ranks)
    assert f"dryrun_multichip({n_ranks}): OK" in capfd.readouterr().out


# ----------------------------------------------------------------------
# Uneven splits (any n over the group)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("world,n", [(1, 7), (2, 13), (3, 13), (4, 13),
                                     (3, 2), (8, 192)])
def test_rows_split_any_count_in_order(world, n):
    """ParticleGroup.rows: contiguous blocks in rank order, the first
    n % world ranks one row more (numpy.array_split's rule)."""
    groups = [ParticleGroup(None, r, world, torch.device("cpu"), "gloo")
              for r in range(world)]
    rows = [g.rows(n) for g in groups]
    assert [r.stop - r.start for r in rows] == [
        len(a) for a in np.array_split(np.arange(n), world)]
    assert [g.share(n) for g in groups] == [r.stop - r.start for r in rows]
    assert rows[0].start == 0 and rows[-1].stop == n
    assert all(a.stop == b.start for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize("impl", ["dense", "blocked", "fused", "rbf_terms",
                                  "fused_terms", "generic", "auto"])
def test_uneven_split_takes_the_plain_routes(impl):
    """13 particles over 3 ranks (rank 1 of a group made by hand: nothing
    is exchanged until the driver steps): every plain route builds with
    this rank's rows, ``auto`` takes the plain rule."""
    fake = ParticleGroup(None, 1, 3, torch.device("cpu"), "gloo")
    kernel = {"rbf_terms": composed, "fused_terms": composed,
              "generic": imq}.get(impl, rbf)
    s = build(st, x0_for(13), 1, impl, fake, kernel)
    assert not s._mesh_even()
    state = s.make_state()
    np.testing.assert_array_equal(state["coords"].numpy(),
                                  x0_for(13)[slice(5, 9)])
    assert state["opt_state"]["s"].shape == (4, 2)
    if impl == "auto":
        assert s._phi_impl == build(st, x0_for(13), 1, "auto")._phi_impl


@pytest.mark.parametrize("impl,kernel", [("fused_cuda", rbf),
                                         ("fused_terms_cuda", composed)])
def test_uneven_split_refuses_the_kernel_routes(impl, kernel):
    fake = ParticleGroup(None, 0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="divide evenly.*duplicates"):
        build(st, x0_for(13), 1, impl, fake, kernel)
    # An even count keeps them.
    assert build(st, x0_for(12), 1, impl, fake, kernel)._mesh_even()


def test_jax_driver_refuses_an_uneven_mesh():
    """Why the uneven worlds (test_torch_sharded.py) hold the port to the
    meshless JAX driver: under a CPU mesh of 2 devices the JAX driver's
    placement of 13 rows raises in jax.device_put."""
    x0 = x0_for(13)
    with pytest.raises(ValueError, match="divisible"):
        build(sv, x0, 2, "dense",
              make_particle_mesh(jax.devices()[:2])).run()


def test_histogram_median_under_a_group(group):
    """The histogram selector through a one-rank group's count env (the
    ranks' histograms summed) equals the selector on the set, and JAX's."""
    from svgdcpp_tpu.ops import median as mj
    from svgdcpp_tpu_torch.ops import median as mt

    x = torch.from_numpy(x0_for(65, seed=12))
    want = mt.pairwise_distance_median_histogram(x)

    def env(**kw):
        return mt.centered_count_env(x, x.clone(), group=group, n_global=65,
                                     return_centered=True, **kw)

    got = mt.pairwise_distance_median(x, "histogram", count_env=env)
    assert float(got) == float(want)
    np.testing.assert_allclose(
        float(got), float(mj.pairwise_distance_median_histogram(
            jnp.asarray(x.numpy()))), rtol=1e-12)


def test_histogram_median_driver_under_a_group(group, mesh):
    """A MEDIAN kernel with median_method='histogram' on the dense route
    under a one-rank mesh, against the meshless driver and the JAX
    driver."""
    x0 = x0_for(40, seed=13)

    def hist(pkg, x, model):
        return rbf(pkg, x, model, median_method="histogram")

    got = build(st, x0, 5, "dense", group, hist).run().numpy()
    plain = build(st, x0, 5, "dense", None, hist).run().numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-12, atol=1e-14)
    want = np.asarray(build(sv, x0, 5, "dense", mesh, hist).run())
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
