"""svgdcpp_tpu_torch's SVGD class against svgdcpp_tpu's.

* Construction, validation messages, lifecycle errors, bounds, routes that
  are not ported yet.
* One step from the SAME state (the JAX SVGD's make_state() carried over
  by utils/convert.py) on the dense route at n=64 (exact median), the dense
  route at n=600 (warm median) and the fused route at n=1500: coords,
  optimizer state and median brackets within rtol 1e-9 (float64; the same
  arithmetic in another order).
* 15-step run() trajectories on the same three, and the flagship config
  (flagship_mvn(1500), AdaGrad 0.1) for 20 steps: rtol 1e-7 (rounding
  differences grow through AdaGrad's normalization over the steps).
* 'fused_cuda' on CPU tensors (the plain sweep) against the JAX package's
  'fused_pallas' (Pallas interpret mode) at n=600 for 3 steps, float32:
  rtol 2e-3, atol 2e-4, the JAX package's own tolerance for that pair.
* Composed kernels: the rbf_terms route against the JAX package's (4
  steps, float64, rtol 1e-9); auto's choice of route on the CPU (the JAX
  package's non-TPU rule) and on a CUDA device (its TPU rule with the CUDA
  routes); 'fused_terms_cuda' on CPU tensors equal to 'fused_terms'; the
  hot-swap's rejections with the JAX package's messages, and an accepted
  swap followed by more steps against the JAX package (rtol 1e-9).
* Where the driver runs: numpy coordinates go to SVGDOptions.device, the
  card by default (raising without one); the tests ask for the CPU with
  device="cpu" or a CPU tensor. The JAX names of the kernel routes name
  their CUDA counterparts.
* The 'cuda' route (K15's port) on CPU tensors against the JAX package's
  'pallas' route (interpret mode), float32, 3 AdaGrad steps at n=300: d=2
  MEDIAN and d=5 HESSIAN, rtol 2e-3, atol 2e-4.
"""

import jax
import numpy as np
import pytest
import torch

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.utils.workloads import flagship_mvn as flagship_j
from svgdcpp_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from svgdcpp_tpu_torch.utils.workloads import flagship_mvn

# The suite runs several xdist workers on one CPU: torch's default of an
# OpenMP thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

MEAN = np.array([-0.6871, 0.8010])
COV = 5.0 * np.array([[0.2260, 0.1652], [0.1652, 0.6779]])


def on_cpu(pkg):
    """SVGDOptions keywords that put the port on the CPU (its default device
    is the card); the JAX package takes none."""
    return {"device": "cpu"} if pkg is st else {}


def coords_for(pkg, x0):
    """x0 as the positional constructor takes it: a CPU tensor for the
    port, which keeps a tensor's device."""
    return torch.from_numpy(x0) if pkg is st else x0


def build(pkg, x0, iters, impl="auto", optimizer=None, **kw):
    n, dim = x0.shape
    model = pkg.MultivariateNormal(MEAN.astype(x0.dtype), COV.astype(x0.dtype))
    kernel = pkg.GaussianRBFKernel(x0.copy(), pkg.ScaleMethod.MEDIAN, model)
    opt = optimizer(pkg) if optimizer else pkg.AdaGrad(dim, n, 0.1)
    opts = pkg.SVGDOptions(
        dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model, optimizer=opt, phi_impl=impl, **kw,
        **on_cpu(pkg),
    )
    return pkg.SVGD(opts).initialize()


def x0_for(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 2)) * 2.0


def leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in leaves(t)]
    return [tree]


def assert_states_close(got, want, rtol):
    for key in ("coords", "opt_state", "scale_aux", "kernel_params"):
        lg, lw = leaves(got[key]), leaves(want[key])
        assert len(lg) == len(lw), key
        for a, b in zip(lg, lw):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            np.testing.assert_allclose(
                a, b, rtol=rtol, atol=rtol * max(1.0, np.abs(b).max()),
                err_msg=key,
            )
    assert int(got["iteration"]) == int(want["iteration"])


CASES = [(64, "dense"), (600, "dense"), (1500, "fused")]


@pytest.mark.parametrize("n,route", CASES)
def test_one_step_from_converted_state(n, route):
    x0 = x0_for(n)
    sj = build(sv, x0, 1)
    s_t = build(st, x0, 1)
    assert sj._phi_impl == s_t._phi_impl == route
    np_state = jax.device_get(sj.make_state())
    want, _ = jax.jit(sj.build_step_fn())(np_state)
    got, _ = s_t.build_step_fn()(state_from_numpy(np_state, device="cpu"))
    assert_states_close(state_to_numpy(got), jax.device_get(want), 1e-9)


@pytest.mark.parametrize("n,route", CASES)
def test_fifteen_step_trajectories(n, route):
    x0 = x0_for(n, seed=1)
    sj = build(sv, x0, 15)
    s_t = build(st, x0, 15)
    out_j = np.asarray(sj.run())
    out_t = s_t.run().numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-7, atol=1e-9)
    assert s_t._iteration == 15


def test_flagship_config_twenty_steps():
    mean, cov, x0 = flagship_mvn(1500)
    mean_j, cov_j, x0_j = flagship_j(1500)
    np.testing.assert_array_equal(x0, x0_j)

    def run(pkg):
        model = pkg.MultivariateNormal(mean, cov)
        kernel = pkg.GaussianRBFKernel(x0.copy(), pkg.ScaleMethod.MEDIAN, model)
        svgd = pkg.SVGD(pkg.SVGDOptions(
            dimension=2, num_iterations=20, coordinate_matrix=x0.copy(),
            kernel=kernel, model=model, optimizer=pkg.AdaGrad(2, 1500, 0.1),
            **on_cpu(pkg),
        )).initialize()
        return np.asarray(svgd.run()), svgd

    out_j, _ = run(sv)
    out_t, s_t = run(st)
    assert s_t._phi_impl == "fused"
    np.testing.assert_allclose(out_t, out_j, rtol=1e-7, atol=1e-9)
    assert s_t.median_fallbacks == 0


def test_fused_cuda_on_cpu_vs_fused_pallas_interpret():
    n = 600
    x0 = (np.random.default_rng(42).normal(size=(n, 2)) * 2).astype(np.float32)

    def run(pkg, impl):
        model = pkg.MultivariateNormal(np.zeros(2, np.float32), np.eye(2, dtype=np.float32))
        kernel = pkg.GaussianRBFKernel(x0.copy(), pkg.ScaleMethod.MEDIAN, model)
        svgd = pkg.SVGD(pkg.SVGDOptions(
            dimension=2, num_iterations=3, coordinate_matrix=x0.copy(),
            kernel=kernel, model=model, optimizer=pkg.AdaGrad(2, n, 0.1),
            phi_impl=impl, **on_cpu(pkg),
        )).initialize()
        return np.asarray(svgd.run())

    np.testing.assert_allclose(
        run(st, "fused_cuda"), run(sv, "fused_pallas"), rtol=2e-3, atol=2e-4
    )


def test_fallback_counted_and_matches_jax():
    """A bracket that cannot hold the median forces the bisection fallback
    on both sides; the port counts it."""
    x0 = x0_for(1500, seed=3)
    sj = build(sv, x0, 1)
    s_t = build(st, x0, 1)
    np_state = jax.device_get(sj.make_state())
    aux = dict(np_state["scale_aux"][0])
    for key in ("lo1", "lo2"):
        aux[key] = np.asarray(1e3, np.float64)
    for key in ("hi1", "hi2"):
        aux[key] = np.asarray(2e3, np.float64)
    np_state["scale_aux"] = (aux,)
    want, _ = jax.jit(sj.build_step_fn())(np_state)
    got, _ = s_t.build_step_fn()(state_from_numpy(np_state, device="cpu"))
    assert s_t.median_fallbacks == 1
    assert_states_close(state_to_numpy(got), jax.device_get(want), 1e-9)


def test_annealing_stats_and_other_optimizers():
    x0 = x0_for(64, seed=2)
    tau = np.linspace(0.2, 1.0, 6)

    def adam(pkg):
        return pkg.Adam(2, 64, 0.05, 0.9, 0.999)

    sj = build(sv, x0, 6, optimizer=adam, annealing=tau, track_stats=True)
    s_t = build(st, x0, 6, optimizer=adam, annealing=tau, track_stats=True)
    np.testing.assert_allclose(s_t.run().numpy(), np.asarray(sj.run()), rtol=1e-9)
    assert set(s_t.stats) == set(sj.stats)
    for key in sj.stats:
        np.testing.assert_allclose(s_t.stats[key], np.asarray(sj.stats[key]), rtol=1e-9)


def test_bounds_clamp_matches_jax():
    x0 = x0_for(64, seed=4)
    sj = build(sv, x0, 5, lower_bound=-0.5, upper_bound=[1.0, 0.7])
    s_t = build(st, x0, 5, lower_bound=-0.5, upper_bound=[1.0, 0.7])
    out_t = s_t.run().numpy()
    np.testing.assert_allclose(out_t, np.asarray(sj.run()), rtol=1e-9)
    assert (out_t >= -0.5).all() and (out_t[:, 0] <= 1.0).all()
    assert (out_t[:, 1] <= 0.7).all()


def test_hot_swap_and_continued_run_match_jax():
    x0 = x0_for(64, seed=5)
    p = 0.4 * np.eye(2)

    def run(pkg):
        model = pkg.MultivariateNormal(MEAN, COV)
        kernel = pkg.GaussianRBFKernel(
            x0.copy(), pkg.ScaleMethod.CONSTANT, constant_scale=p
        )
        svgd = pkg.SVGD(2, 4, coords_for(pkg, x0.copy()), kernel, model,
                        pkg.AdaGrad(2, 64, 0.1))
        svgd.Initialize()
        svgd.Run()
        svgd.UpdateKernelParameters((0.9 * np.eye(2),))
        svgd.UpdateModelParameters((MEAN + 0.5, COV))
        svgd.Step()
        return np.asarray(svgd.Run())

    np.testing.assert_allclose(run(st), run(sv), rtol=1e-9)


def test_custom_hooks_run_each_iteration():
    x0 = x0_for(32, seed=6)
    calls = []

    class CountingModel(st.MultivariateNormal):
        def step(self):
            calls.append(1)

    model = CountingModel(MEAN, COV)
    kernel = st.GaussianRBFKernel(x0, st.ScaleMethod.MEDIAN, model)
    svgd = st.SVGD(st.SVGDOptions(
        dimension=2, num_iterations=3, coordinate_matrix=x0, kernel=kernel,
        model=model, optimizer=st.AdaGrad(2, 32, 0.1), device="cpu",
    )).initialize()
    svgd.run()
    assert len(calls) == 3 and svgd._iteration == 3


def _error_pair(make):
    with pytest.raises(Exception) as ej:
        make(sv)
    with pytest.raises(Exception) as et:
        make(st)
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)


def test_constructor_validation_matches_jax():
    x0 = x0_for(8)

    def parts(pkg):
        model = pkg.MultivariateNormal(MEAN, COV)
        return model, pkg.GaussianRBFKernel(x0, pkg.ScaleMethod.MEDIAN), pkg.AdaGrad(2, 8, 0.1)

    def c(pkg):
        return coords_for(pkg, x0)

    _error_pair(lambda pkg: pkg.SVGD(3, 1, c(pkg), *parts(pkg)[1::-1], parts(pkg)[2]))
    _error_pair(lambda pkg: pkg.SVGD(2, 1, c(pkg), None, parts(pkg)[0], parts(pkg)[2]))
    _error_pair(lambda pkg: pkg.SVGD(2, 1, c(pkg), parts(pkg)[1], None, parts(pkg)[2]))
    _error_pair(lambda pkg: pkg.SVGD(2, 1, c(pkg), parts(pkg)[1], parts(pkg)[0], None))
    _error_pair(lambda pkg: pkg.SVGD(*range(12)))
    _error_pair(lambda pkg: pkg.SVGD(2, 1, c(pkg), dimension=2))
    _error_pair(lambda pkg: pkg.SVGD(
        2, 1, c(pkg), parts(pkg)[1], parts(pkg)[0], parts(pkg)[2], [0.0, 0.0, 0.0]
    ))
    _error_pair(lambda pkg: pkg.SVGD(
        2, 1, c(pkg), parts(pkg)[1], parts(pkg)[0], parts(pkg)[2]
    ).run())
    # phi_impl='fused' needs a MEDIAN kernel: same message
    _error_pair(lambda pkg: pkg.SVGD(pkg.SVGDOptions(
        dimension=2, num_iterations=1, coordinate_matrix=x0,
        kernel=pkg.GaussianRBFKernel(x0, pkg.ScaleMethod.CONSTANT,
                                     constant_scale=np.eye(2)),
        model=parts(pkg)[0], optimizer=parts(pkg)[2], phi_impl="fused",
        **on_cpu(pkg),
    )).initialize())


@pytest.mark.parametrize("options", [
    {"impl": "generic"},
    {"mesh": object()},
    {"log_intermediate_matrices": True},
    {"impl": "fused_cuda", "fused_dot_dtype": "bfloat16"},
    {"impl": "cuda", "fused_dot_dtype": "bfloat16"},
])
def test_unported_routes_raise_not_implemented(options):
    x0 = x0_for(16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(st, x0, 1, **options)


@pytest.mark.parametrize("jax_name,cuda_name,composed_kernel", [
    ("fused_aniso_terms_pallas", "fused_aniso_terms_cuda", True),
    ("pallas", "cuda", False),
])
def test_jax_route_names_point_to_cuda(jax_name, cuda_name, composed_kernel):
    """The Mosaic routes' JAX names raise ValueError naming their CUDA
    counterparts, which run (on CPU tensors, their plain versions)."""
    x0 = x0_for(40)

    def make(impl):
        if composed_kernel:
            return build_composed(st, x0, 1, ANISO, impl=impl)
        return build(st, x0, 1, impl=impl)

    with pytest.raises(ValueError, match=f"'{cuda_name}'"):
        make(jax_name)
    svgd = make(cuda_name)
    assert svgd._phi_impl == cuda_name
    assert svgd.run().isfinite().all()


def test_numpy_coords_default_to_cuda(monkeypatch):
    """Coordinates that are not a tensor go to SVGDOptions.device, the card
    by default: without a CUDA device that raises, naming device="cpu";
    with device="cpu" they run on the CPU. A tensor keeps its device, and
    the BLR builder follows the same rule."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x0 = x0_for(16)
    model = st.MultivariateNormal(MEAN, COV)

    def options(coords, **kw):
        return st.SVGDOptions(
            dimension=2, num_iterations=1, coordinate_matrix=coords,
            kernel=st.GaussianRBFKernel(x0, st.ScaleMethod.MEDIAN, model),
            model=model, optimizer=st.AdaGrad(2, 16, 0.1), **kw,
        )

    assert st.SVGDOptions().device == "cuda"
    for coords in (x0, x0.tolist()):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            st.SVGD(options(coords))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        st.SVGD(2, 1, x0, st.GaussianRBFKernel(x0), model,
                st.AdaGrad(2, 16, 0.1))
    for svgd in (st.SVGD(options(x0, device="cpu")),
                 st.SVGD(options(torch.from_numpy(x0)))):
        assert svgd.store.value.device.type == "cpu"
        assert svgd.initialize().run().device.type == "cpu"
    from svgdcpp_tpu_torch.utils.workloads import blr_workload, build_blr_svgd

    feats, labels, xb = blr_workload(16, 3, n_data=32)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_blr_svgd(xb, feats, labels)
    assert build_blr_svgd(xb, feats, labels, device="cpu").store.value.device.type == "cpu"


def builder_case(name, device):
    """One of the workload builders, called on a numpy x0 with ``device``."""
    from svgdcpp_tpu_torch.utils import workloads as wl

    if name == "mvn":
        mean, cov, x0 = flagship_mvn(600)
        return lambda: wl.build_mvn_svgd(x0, mean, cov, device=device)
    if name == "hier":
        feats, labels, xb = wl.blr_workload(600, 3, n_data=32,
                                            hierarchical=True)
        return lambda: wl.build_blr_svgd(xb, feats, labels, hierarchical=True,
                                         device=device)
    mean, cov, xa, p_aniso = wl.aniso_mvn_workload(600, dim=3)
    return lambda: wl.build_aniso_svgd(xa, mean, cov, p_aniso, device=device)


def count_medians(monkeypatch):
    """Count the median selections of the kernels' scale and of the fused
    routes' seed."""
    from svgdcpp_tpu_torch.kernels import gaussian_rbf
    from svgdcpp_tpu_torch.ops import median

    calls = []
    real = median.pairwise_distance_median

    def counted(coords, *args, **kwargs):
        calls.append(coords.device.type)
        return real(coords, *args, **kwargs)

    for module in (median, gaussian_rbf):
        monkeypatch.setattr(module, "pairwise_distance_median", counted)
    return calls


@pytest.mark.parametrize("name", ["mvn", "hier", "aniso"])
def test_builders_place_numpy_x0_before_the_median(name, monkeypatch):
    """A numpy x0 goes to the builder's device before the kernel is built:
    without a CUDA device the default raises before any median is taken,
    and with device="cpu" the median is taken once, on the driver's
    device, and the fused routes' seed reuses it."""
    calls = count_medians(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        builder_case(name, "cuda")()
    assert calls == []
    svgd = builder_case(name, "cpu")()
    assert calls == ["cpu"]
    assert svgd.store.value.device.type == "cpu"


def composed(pkg, x0, const, op="+", model=None):
    """Median RBF (op) constant RBF, the hierarchical-BLR kernel's shape."""
    med = pkg.GaussianRBFKernel(x0.copy(), pkg.ScaleMethod.MEDIAN, model)
    c = pkg.GaussianRBFKernel(
        x0.copy(), pkg.ScaleMethod.CONSTANT, constant_scale=np.asarray(const)
    )
    return {"+": med + c, "*": med * c, "/": med / c}[op]


def build_composed(pkg, x0, iters, const, op="+", impl="auto", **kw):
    n, dim = x0.shape
    model = pkg.MultivariateNormal(MEAN.astype(x0.dtype), COV.astype(x0.dtype))
    opts = pkg.SVGDOptions(
        dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
        kernel=composed(pkg, x0, const, op, model), model=model,
        optimizer=pkg.Adam(dim, n, 0.05, 0.9, 0.999), phi_impl=impl, **kw,
        **on_cpu(pkg),
    )
    return pkg.SVGD(opts).initialize()


ANISO = np.array([[0.3, 0.1], [0.1, 0.2]])


@pytest.mark.parametrize("op,const", [("+", ANISO), ("/", 0.05 * np.eye(2))])
def test_rbf_terms_route_matches_jax(op, const):
    x0 = x0_for(64, seed=7)
    sj = build_composed(sv, x0, 4, const, op)
    s_t = build_composed(st, x0, 4, const, op)
    assert sj._phi_impl == s_t._phi_impl == "rbf_terms"
    assert s_t._term_psd == sj._term_psd
    np.testing.assert_allclose(s_t.run().numpy(), np.asarray(sj.run()),
                               rtol=1e-9, atol=1e-12)


def test_composed_kernel_auto_and_fused_pallas_name():
    """auto on the CPU follows the JAX package's non-TPU rule; on a CUDA
    device (the rule evaluated with on_cuda=True) its TPU rule with the
    CUDA routes; the JAX names of the Mosaic routes point to the CUDA
    ones."""
    iso = 0.1 * np.eye(2)
    for n, op, const, cpu, cuda in [
        (16, "+", iso, "rbf_terms", "rbf_terms"),
        (300, "+", iso, "rbf_terms", "fused_terms_cuda"),
        (1100, "+", iso, "fused_terms", "fused_terms_cuda"),
        (300, "/", iso, "rbf_terms", "rbf_terms"),
        (1100, "/", iso, "fused_terms", "fused_terms"),
        (1100, "+", ANISO, "rbf_terms", "rbf_terms"),
    ]:
        x0 = x0_for(n)
        s_t = build_composed(st, x0, 1, const, op)
        sj = build_composed(sv, x0, 1, const, op)
        assert s_t._phi_impl == sj._phi_impl == cpu, (n, op)
        assert s_t._auto_impl(on_cuda=True) == cuda, (n, op)
    # where the TPU rule takes the anisotropic Mosaic sweep: its CUDA port
    s_t = build_composed(st, x0_for(2100), 1, ANISO)
    assert s_t._phi_impl == "rbf_terms"
    assert s_t._auto_impl(on_cuda=True) == "fused_aniso_terms_cuda"
    # a custom kernel takes the generic route: not ported
    model = st.MultivariateNormal(MEAN, COV)
    x0 = x0_for(16)
    custom = st.Kernel(2, lambda x, p, loc: torch.exp(-torch.sum((x - loc) ** 2)))
    with pytest.raises(NotImplementedError, match="generic"):
        st.SVGD(2, 1, torch.from_numpy(x0), custom, model,
                st.AdaGrad(2, 16, 0.1)).initialize()
    with pytest.raises(ValueError, match="fused_cuda"):
        build(st, x0, 1, impl="fused_pallas")
    with pytest.raises(ValueError, match="'fused_terms_cuda'"):
        build_composed(st, x0, 1, iso, impl="fused_terms_pallas")


def test_composed_route_validation_matches_jax():
    x0 = x0_for(40)
    # a single RBF on a terms route, and a composition on a single-RBF one
    _error_pair(lambda pkg: build(pkg, x0, 1, impl="rbf_terms"))
    _error_pair(lambda pkg: build_composed(pkg, x0, 1, 0.1 * np.eye(2),
                                           impl="dense"))
    # an anisotropic constant slot on the fused terms route
    _error_pair(lambda pkg: build_composed(pkg, x0, 1, ANISO,
                                           impl="fused_terms"))
    # division terms on the kernel route: the JAX message, its route's name
    with pytest.raises(ValueError) as ej:
        build_composed(sv, x0, 1, 0.1 * np.eye(2), "/",
                       impl="fused_terms_pallas")
    with pytest.raises(ValueError) as et:
        build_composed(st, x0, 1, 0.1 * np.eye(2), "/",
                       impl="fused_terms_cuda")
    assert str(et.value) == str(ej.value).replace(
        "fused_terms_pallas", "fused_terms_cuda"
    )


def test_fused_terms_cuda_on_cpu_equals_fused_terms():
    x0 = x0_for(1100, seed=8)
    runs = {
        impl: build_composed(st, x0, 3, 0.1 * np.eye(2), impl=impl)
        for impl in ("fused_terms_cuda", "fused_terms")
    }
    outs = {impl: s.run().numpy() for impl, s in runs.items()}
    np.testing.assert_array_equal(outs["fused_terms_cuda"], outs["fused_terms"])
    assert runs["fused_terms_cuda"].median_fallbacks == 0


def test_fused_terms_hot_swap_matches_jax():
    x0 = x0_for(1100, seed=9)
    iso = 0.1 * np.eye(2)

    def swapped(pkg, impl):
        svgd = build_composed(pkg, x0, 2, iso, impl=impl)
        svgd.run()
        med = svgd.kernel.parameters[0]
        svgd.update_kernel_parameters((med, 0.3 * np.eye(2)))
        return np.asarray(svgd.run())

    np.testing.assert_allclose(
        swapped(st, "fused_terms"), swapped(sv, "fused_terms"),
        rtol=1e-9, atol=1e-12,
    )
    # rejections: an anisotropic swap on a fused terms route, a
    # non-positive one on the kernel route; the driver keeps its parameters
    for impl_t, impl_j, bad in [
        ("fused_terms", "fused_terms", ANISO),
        ("fused_terms_cuda", "fused_terms_pallas", -0.1 * np.eye(2)),
    ]:
        with pytest.raises(ValueError) as ej:
            s_j = build_composed(sv, x0, 1, iso, impl=impl_j)
            s_j.update_kernel_parameters((s_j.kernel.parameters[0], bad))
        s_t = build_composed(st, x0, 1, iso, impl=impl_t)
        before = [p.clone() for p in s_t.kernel.parameters]
        with pytest.raises(ValueError) as et:
            s_t.update_kernel_parameters((s_t.kernel.parameters[0], bad))
        assert str(et.value) == str(ej.value).replace(
            "fused_terms_pallas", "fused_terms_cuda"
        )
        for a, b in zip(s_t.kernel.parameters, before):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dim,scale", [(2, "MEDIAN"), (5, "HESSIAN")])
def test_cuda_route_on_cpu_vs_pallas_route(dim, scale):
    """'cuda' (K15's port; phi_rbf_blocked on CPU tensors) against the JAX
    package's 'pallas' route in interpret mode, float32, 3 AdaGrad steps at
    n=300: the tolerance the JAX package holds its kernel routes to."""
    n = 300
    rng = np.random.default_rng(50 + dim)
    x0 = (rng.normal(size=(n, dim)) * 1.5).astype(np.float32)
    a = rng.normal(size=(dim, dim)) * 0.4
    mean = rng.normal(size=dim).astype(np.float32)
    cov = (np.eye(dim) + a @ a.T).astype(np.float32)

    def run(pkg, impl):
        model = pkg.MultivariateNormal(mean, cov)
        kernel = pkg.GaussianRBFKernel(
            x0.copy(), getattr(pkg.ScaleMethod, scale), model
        )
        svgd = pkg.SVGD(pkg.SVGDOptions(
            dimension=dim, num_iterations=3, coordinate_matrix=x0.copy(),
            kernel=kernel, model=model, optimizer=pkg.AdaGrad(dim, n, 0.1),
            phi_impl=impl, **on_cpu(pkg),
        )).initialize()
        assert svgd._rbf_psd is (scale == "MEDIAN")
        return np.asarray(svgd.run())

    np.testing.assert_allclose(
        run(st, "cuda"), run(sv, "pallas"), rtol=2e-3, atol=2e-4
    )


@pytest.mark.parametrize("scale", ["MEDIAN", "CONSTANT", "HESSIAN"])
def test_cuda_route_decomposes_p_on_the_host_for_hessian_only(
    scale, monkeypatch
):
    """The 'cuda' route hands K15's wrapper the eigendecomposition of
    P_sym/2 where it needs no host read each step: MEDIAN's gamma I as (its
    diagonal, I), a CONSTANT P decomposed once (again after a hot-swap); a
    HESSIAN scale gets none, and the wrapper decomposes it."""
    import svgdcpp_tpu_torch.svgd as driver

    n, dim = 40, 3
    rng = np.random.default_rng(60)
    x0 = rng.normal(size=(n, dim)) * 1.5
    a = rng.normal(size=(dim, dim)) * 0.4
    model = st.MultivariateNormal(np.zeros(dim), np.eye(dim) + a @ a.T)
    p_const = 0.3 * np.eye(dim) + 0.1 * rng.normal(size=(dim, dim))
    kernel = st.GaussianRBFKernel(
        x0.copy(), getattr(st.ScaleMethod, scale), model,
        constant_scale=p_const if scale == "CONSTANT" else None,
    )
    decompositions, calls = [], []
    real_eigen, real_phi = driver.symmetric_eigen, driver.phi_rbf_cuda
    monkeypatch.setattr(driver, "symmetric_eigen",
                        lambda p: decompositions.append(p) or real_eigen(p))
    monkeypatch.setattr(driver, "phi_rbf_cuda", lambda c, s, p, psd, eig: (
        calls.append((p, eig)) or real_phi(c, s, p, psd=psd, eig=eig)))
    svgd = st.SVGD(st.SVGDOptions(
        dimension=dim, num_iterations=3, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model, optimizer=st.AdaGrad(dim, n, 0.1),
        phi_impl="cuda", device="cpu",
    )).initialize()
    svgd.run()
    if scale == "CONSTANT":
        svgd.update_kernel_parameters((0.5 * p_const,))
        svgd.run()
    assert len(calls) == 3 * (2 if scale == "CONSTANT" else 1)
    want_decompositions = {"MEDIAN": 0, "CONSTANT": 2, "HESSIAN": 0}[scale]
    assert len(decompositions) == want_decompositions
    for p, eig in calls:
        if scale == "HESSIAN":
            assert eig is None
            continue
        lam, v = eig
        assert lam.device == p.device and v.device == p.device
        np.testing.assert_allclose(
            (v * lam) @ v.T, 0.5 * (p + p.T).double(), atol=1e-12
        )
    if scale == "CONSTANT":  # one decomposition per P, kept across steps
        assert calls[0][1] is calls[2][1] and calls[3][1] is calls[5][1]
        assert calls[0][1] is not calls[3][1]


@pytest.mark.parametrize("impl,names", [
    ("fused", ["scores", "plan", "sweep", "median", "optimizer"]),
    ("dense", ["scores", "scale", "sweep", "optimizer"]),
])
def test_section_hook_marks_the_step(impl, names):
    """SVGD.section_hook sees each section of the driver's step end, in
    order, and changes nothing the step computes."""
    x0 = x0_for(300, seed=11)
    plain = build(st, x0, 2, impl=impl).run()
    svgd = build(st, x0, 2, impl=impl)
    seen = []
    svgd.section_hook = seen.append
    svgd._step_fn = svgd.build_step_fn()
    out = svgd.run()
    assert seen == names * 2
    assert torch.equal(out, plain)
