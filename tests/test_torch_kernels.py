"""svgdcpp_tpu_torch kernels and pairwise ops against svgdcpp_tpu.

Same numpy inputs, float64 on both sides. Tolerance rtol 1e-12 (closed
forms; the median selectors are exact at these sizes), with an absolute
floor of 1e-12 times the largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.ops import pairwise as pw_j
from svgdcpp_tpu_torch.ops import pairwise as pw_t

# The suite runs several xdist workers on one CPU: torch's default of an
# OpenMP thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

RTOL = 1e-12


def assert_close(got, want, rtol=RTOL):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max())
    )


def pair_models(rng, d):
    a = rng.normal(size=(d, d))
    mean, cov = rng.normal(size=d), a @ a.T / d + np.eye(d)
    return sv.MultivariateNormal(mean, cov), st.MultivariateNormal(mean, cov)


@pytest.mark.parametrize("n", [64, 600])
def test_median_scale_matches_jax(rng, n):
    """n=64 takes the exact sort, n=600 the hybrid selector."""
    x = rng.normal(size=(n, 3)) * 1.7 + 4.0
    kj = sv.GaussianRBFKernel(x, sv.ScaleMethod.MEDIAN)
    kt = st.GaussianRBFKernel(x, st.ScaleMethod.MEDIAN)
    assert_close(kt.parameters[0], kj.parameters[0])
    assert_close(kt.ComputeScale(), kj.ComputeScale())


def test_hessian_and_constant_scales_match_jax(rng):
    x = rng.normal(size=(40, 3))
    mj, mt = pair_models(rng, 3)
    kj = sv.GaussianRBFKernel(x, sv.ScaleMethod.HESSIAN, mj)
    kt = st.GaussianRBFKernel(x, st.ScaleMethod.HESSIAN, mt)
    assert_close(kt.parameters[0], kj.parameters[0])
    p = np.diag([0.5, 1.0, 2.0])
    kj = sv.GaussianRBFKernel(x, sv.ScaleMethod.CONSTANT, constant_scale=p)
    kt = st.GaussianRBFKernel(x, st.ScaleMethod.CONSTANT, constant_scale=p)
    assert_close(kt.parameters[0], kj.parameters[0])


def test_fused_seed_reuses_the_constructors_median(rng, monkeypatch):
    """The fused routes' seed on the coordinates the constructor's MEDIAN
    scale was taken on reuses that median; other coordinates or another
    method take their own."""
    from svgdcpp_tpu_torch.ops import median as mt

    x = torch.from_numpy(rng.normal(size=(600, 2)))
    kt = st.GaussianRBFKernel(x, st.ScaleMethod.MEDIAN)
    want = mt.fused_median_seed(x)
    calls = []
    real = mt.pairwise_distance_median

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(mt, "pairwise_distance_median", counted)
    got = kt.init_fused_aux(x.clone())
    assert not calls
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key])
    kt.init_fused_aux(x + 1e-3)
    assert len(calls) == 1
    kt.median_method = "exact"
    kt.init_fused_aux(x)
    assert len(calls) == 2


def test_scale_aux_seeds_match_jax(rng):
    x = rng.normal(size=(600, 2))
    kj = sv.GaussianRBFKernel(x, sv.ScaleMethod.MEDIAN)
    kt = st.GaussianRBFKernel(x, st.ScaleMethod.MEDIAN)
    fj = kj.init_fused_aux(jnp.asarray(x))
    ft = kt.init_fused_aux(torch.from_numpy(x))
    assert set(ft) == set(fj)
    for key in fj:
        assert_close(ft[key], fj[key])
    wj = kj.init_scale_aux(jnp.asarray(x))
    wt = kt.init_scale_aux(torch.from_numpy(x))
    for key in wj:
        assert_close(wt[key], wj[key])
    assert kt.init_scale_aux(torch.from_numpy(x[:100])) is None
    # one warm update from those aux values
    sj, aj = kj.compute_scale_with_aux(jnp.asarray(x), None, wj)
    s_t, a_t = kt.compute_scale_with_aux(torch.from_numpy(x), None, wt)
    assert_close(s_t, sj)
    for key in aj:
        assert_close(a_t[key], aj[key])


def test_kernel_pure_grad_and_evaluate_match_jax(rng):
    x = rng.normal(size=(9, 3))
    kj = sv.GaussianRBFKernel(x, sv.ScaleMethod.MEDIAN)
    kt = st.GaussianRBFKernel(x, st.ScaleMethod.MEDIAN)
    loc = rng.normal(size=3)
    params_j, params_t = kj.parameters, kt.parameters
    assert_close(
        kt.kernel_pure(torch.from_numpy(x[0]), params_t, torch.from_numpy(loc)),
        kj.kernel_pure(jnp.asarray(x[0]), params_j, jnp.asarray(loc)),
    )
    assert_close(
        kt.kernel_grad_pure(torch.from_numpy(x[0]), params_t, torch.from_numpy(loc)),
        kj.kernel_grad_pure(jnp.asarray(x[0]), params_j, jnp.asarray(loc)),
    )
    kj.update_location(loc)
    kt.UpdateLocation(loc)
    assert_close(kt.EvaluateKernel(torch.from_numpy(x)), kj.evaluate_kernel(jnp.asarray(x)))
    assert_close(
        kt.EvaluateKernelGrad(torch.from_numpy(x)),
        kj.evaluate_kernel_grad(jnp.asarray(x)),
    )


@pytest.mark.parametrize("op", ["+", "-", "*", "/"])
def test_composed_kernels_construct_and_evaluate(rng, op):
    x = rng.normal(size=(12, 2))
    apply = {
        "+": lambda a, b: a + b,
        "-": lambda a, b: a - b,
        "*": lambda a, b: a * b,
        "/": lambda a, b: a / b,
    }[op]
    p = 0.3 * np.eye(2)
    cj = apply(
        sv.GaussianRBFKernel(x, sv.ScaleMethod.MEDIAN),
        sv.GaussianRBFKernel(x, sv.ScaleMethod.CONSTANT, constant_scale=p),
    )
    ct = apply(
        st.GaussianRBFKernel(x, st.ScaleMethod.MEDIAN),
        st.GaussianRBFKernel(x, st.ScaleMethod.CONSTANT, constant_scale=p),
    )
    ct.initialize()
    assert [i for i, _ in ct.adaptive_slots()] == [i for i, _ in cj.adaptive_slots()]
    loc = rng.normal(size=2)
    cj.update_location(loc)
    ct.update_location(loc)
    assert_close(ct.evaluate_kernel(torch.from_numpy(x)), cj.evaluate_kernel(jnp.asarray(x)))
    assert_close(
        ct.evaluate_kernel_grad(torch.from_numpy(x)),
        cj.evaluate_kernel_grad(jnp.asarray(x)),
    )


@pytest.mark.parametrize("offset", [0.0, 1e4])
def test_pairwise_matches_jax(rng, offset):
    x = rng.normal(size=(50, 4)) + offset
    p = rng.normal(size=(4, 4))
    assert_close(
        pw_t.squared_pairwise_distances(torch.from_numpy(x)),
        pw_j.squared_pairwise_distances(jnp.asarray(x)),
        rtol=1e-9,
    )
    for psd in (True, False):
        assert_close(
            pw_t.weighted_quadratic_pairwise(torch.from_numpy(x), torch.from_numpy(p), psd),
            pw_j.weighted_quadratic_pairwise(jnp.asarray(x), jnp.asarray(p), psd),
            rtol=1e-9,
        )
    for n_cols, req in [(10, 1024), (10**6, 1024), (3, 7)]:
        assert pw_t.auto_row_tile(n_cols, req) == pw_j.auto_row_tile(n_cols, req)


def test_kernel_errors_match_jax():
    x = np.zeros((4, 2))
    cases = [
        lambda pkg: pkg.GaussianRBFKernel(x, pkg.ScaleMethod.HESSIAN),
        lambda pkg: pkg.GaussianRBFKernel(x, pkg.ScaleMethod.CONSTANT),
        lambda pkg: pkg.GaussianRBFKernel(
            x, pkg.ScaleMethod.CONSTANT, constant_scale=np.eye(3)
        ),
        lambda pkg: pkg.Kernel().initialize(),
        lambda pkg: pkg.Kernel(2).initialize(),
        lambda pkg: pkg.GaussianRBFKernel(x).update_location(np.zeros(3)),
        lambda pkg: pkg.GaussianRBFKernel(x) + pkg.GaussianRBFKernel(np.zeros((4, 3))),
    ]
    for case in cases:
        with pytest.raises(Exception) as ej:
            case(sv)
        with pytest.raises(Exception) as et:
            case(st)
        assert type(et.value).__name__ == type(ej.value).__name__
        assert str(et.value) == str(ej.value)
