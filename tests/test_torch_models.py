"""svgdcpp_tpu_torch models against svgdcpp_tpu on the same inputs.

Inputs are made with numpy from a seed and handed to both packages in
float64. Tolerance: rtol 1e-12 (the same closed forms; only the order of
floating-point operations may differ), with an absolute floor of 1e-12
times the largest magnitude for entries that cancel to ~0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st

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


def spd(rng, d, scale=1.0):
    a = rng.normal(size=(d, d))
    return scale * (a @ a.T / d + np.eye(d))


def mvn_pair(rng, d, scale=1.0):
    mean = rng.normal(size=d)
    cov = spd(rng, d, scale)
    return sv.MultivariateNormal(mean, cov), st.MultivariateNormal(mean, cov)


EVALUATE = [
    "evaluate_model",
    "evaluate_log_model",
    "evaluate_model_grad",
    "evaluate_log_model_grad",
    "evaluate_model_hessian",
    "evaluate_log_model_hessian",
    "evaluate_model_normalized",
    "evaluate_log_model_normalized",
    "evaluate_model_grad_normalized",
]


@pytest.mark.parametrize("d", [2, 5])
@pytest.mark.parametrize("method", EVALUATE)
def test_mvn_evaluate_matches_jax(rng, d, method):
    mj, mt = mvn_pair(rng, d, scale=2.0)
    x = rng.normal(size=(7, d))
    want = getattr(mj, method)(jnp.asarray(x))
    assert_close(getattr(mt, method)(torch.from_numpy(x)), want)
    # a single (m,) particle too
    assert_close(
        getattr(mt, method)(torch.from_numpy(x[0])),
        getattr(mj, method)(jnp.asarray(x[0])),
    )


@pytest.mark.parametrize("d", [2, 5])
def test_mvn_pure_score_hessian_and_constants(rng, d):
    mj, mt = mvn_pair(rng, d)
    x = rng.normal(size=d)
    pj = mj.parameters
    pt = mt.parameters
    assert_close(
        mt.log_density_pure(torch.from_numpy(x), pt),
        mj.log_density_pure(jnp.asarray(x), pj),
    )
    assert_close(
        mt.grad_log_density_pure(torch.from_numpy(x), pt),
        mj.grad_log_density_pure(jnp.asarray(x), pj),
    )
    assert_close(
        mt.hessian_log_density_pure(torch.from_numpy(x), pt),
        mj.hessian_log_density_pure(jnp.asarray(x), pj),
    )
    assert_close(mt.get_normalization_constant(), mj.get_normalization_constant())
    assert_close(
        mt.GetLogNormalizationConstant(), mj.GetLogNormalizationConstant()
    )


def test_mvn_update_parameters_guarded(rng):
    mj, mt = mvn_pair(rng, 3)
    new_mean = rng.normal(size=3)
    new_cov = spd(rng, 3, 3.0)
    mj.update_parameters((new_mean, new_cov))
    mt.UpdateParameters((new_mean, new_cov))
    assert_close(mt.get_normalization_constant(), mj.get_normalization_constant())
    x = rng.normal(size=(4, 3))
    assert_close(
        mt.evaluate_log_model(torch.from_numpy(x)),
        mj.evaluate_log_model(jnp.asarray(x)),
    )
    # rejected updates: the same errors, and the old parameters survive
    for bad in [
        (np.zeros(2), np.eye(3)),
        (np.zeros(2), np.eye(2)),
        (np.zeros(3), -np.eye(3)),
    ]:
        with pytest.raises(Exception) as ej:
            mj.update_parameters(bad)
        with pytest.raises(Exception) as et:
            mt.update_parameters(bad)
        assert type(et.value).__name__ == type(ej.value).__name__
        assert str(et.value) == str(ej.value)
    assert_close(mt.parameters[1], new_cov)


@pytest.mark.parametrize("op", ["+", "-", "*", "/"])
def test_composed_models_match_jax(rng, op):
    d = 2
    mean = rng.normal(size=d)
    # same mean, wider first covariance: f1 >= f2 everywhere, so f1 - f2
    # is a valid (positive) density away from the mean
    a_j = sv.MultivariateNormal(mean, 2.0 * np.eye(d))
    a_t = st.MultivariateNormal(mean, 2.0 * np.eye(d))
    cov_b = 0.9 * np.eye(d)
    b_j, b_t = sv.MultivariateNormal(mean, cov_b), st.MultivariateNormal(mean, cov_b)
    apply = {
        "+": lambda a, b: a + b,
        "-": lambda a, b: a - b,
        "*": lambda a, b: a * b,
        "/": lambda a, b: a / b,
    }[op]
    cj, ct = apply(a_j, b_j), apply(a_t, b_t)
    ct.initialize()
    x = mean + rng.normal(size=(6, d)) + 0.5
    for method in ("evaluate_model", "evaluate_log_model",
                   "evaluate_log_model_grad", "evaluate_log_model_hessian"):
        assert_close(
            getattr(ct, method)(torch.from_numpy(x)),
            getattr(cj, method)(jnp.asarray(x)),
            rtol=1e-10,
        )


@pytest.mark.parametrize("weights", [None, [0.3, 0.7]])
def test_mixture_matches_jax(rng, weights):
    d = 2
    parts = [mvn_pair(rng, d) for _ in range(2)]
    mix_j = sv.mixture([p[0] for p in parts], weights)
    mix_t = st.mixture([p[1] for p in parts], weights)
    x = rng.normal(size=(5, d)) * 2
    for method in ("evaluate_log_model", "evaluate_log_model_grad",
                   "evaluate_log_model_hessian"):
        assert_close(
            getattr(mix_t, method)(torch.from_numpy(x)),
            getattr(mix_j, method)(jnp.asarray(x)),
        )


def test_user_density_model_autodiff(rng):
    """A Model from a plain density function: log(f) composition, score and
    Hessian by autodiff in both packages."""

    def dens_j(x, p):
        return jnp.exp(-jnp.sum((x - p[0]) ** 2) * p[1]) * (1.5 + jnp.sin(x[0]))

    def dens_t(x, p):
        return torch.exp(-torch.sum((x - p[0]) ** 2) * p[1]) * (1.5 + torch.sin(x[0]))

    mu = rng.normal(size=3)
    scale = np.asarray(0.4)
    mj = sv.Model(3, density_fn=dens_j, parameters=(mu, scale))
    mt = st.Model(3, density_fn=dens_t, parameters=(mu, scale))
    mt.Initialize()
    x = rng.normal(size=(5, 3))
    for method in EVALUATE[:6]:
        assert_close(
            getattr(mt, method)(torch.from_numpy(x)),
            getattr(mj, method)(jnp.asarray(x)),
        )


def test_model_errors_match_jax():
    cases = [
        lambda pkg: pkg.Model().initialize(),
        lambda pkg: pkg.Model(2).initialize(),
        lambda pkg: pkg.MultivariateNormal(np.zeros(2), np.eye(2))
        + pkg.MultivariateNormal(np.zeros(3), np.eye(3)),
        lambda pkg: pkg.MultivariateNormal(np.zeros(2), np.eye(3)),
        lambda pkg: pkg.mixture([]),
    ]
    for case in cases:
        with pytest.raises(Exception) as ej:
            case(sv)
        with pytest.raises(Exception) as et:
            case(st)
        assert type(et.value).__name__ == type(ej.value).__name__
        assert str(et.value) == str(ej.value)
