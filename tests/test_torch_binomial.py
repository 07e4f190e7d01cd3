"""svgdcpp_tpu_torch's BinomialLikelihood against svgdcpp_tpu's.

* Log-density and score against the JAX model and the closed forms
  (scipy's logpmf; k/x - (n-k)/(1-x)): rtol 1e-12, float64.
* The constructor's errors: the same exception types and messages.
* The JAX test's bounded run (tests/test_binomial.py: 30 particles on the
  unit box, Adam 0.005, 400 steps, MEDIAN RBF): the port's coordinates
  against the JAX driver's (rtol 1e-9, atol 1e-12), and the JAX test's
  criterion, the particle mean within 4 posterior sd of the MLE.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.models.binomial_likelihood import (
    binomial_log_density as log_j,
)
from svgdcpp_tpu_torch.models.binomial_likelihood import (
    binomial_density,
    binomial_log_density,
)

torch.set_num_threads(1)

TRIALS = np.array([30.0, 10.0, 25.0])
SUCCESSES = np.array([12.0, 3.0, 20.0])


def test_exported_as_in_jax():
    assert "BinomialLikelihood" in st.__all__
    assert st.models.BinomialLikelihood is st.BinomialLikelihood


def test_log_density_and_score_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.1, 0.9, (7, 3))
    mj = sv.BinomialLikelihood(TRIALS, SUCCESSES)
    mt = st.BinomialLikelihood(TRIALS, SUCCESSES)
    pj, pt = tuple(mj.parameters), tuple(mt.parameters)
    want = jax.vmap(lambda xi: log_j(xi, pj))(jnp.asarray(x))
    got = vmap(lambda xi: binomial_log_density(xi, pt))(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    from scipy.stats import binom

    expected = [sum(binom.logpmf(k, n, p) for n, k, p in
                    zip(TRIALS, SUCCESSES, row)) for row in x]
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-12)
    np.testing.assert_allclose(
        binomial_density(torch.from_numpy(x[0]), pt).item(),
        np.exp(expected[0]), rtol=1e-12)
    score_j = jax.vmap(lambda xi: mj.grad_log_density_pure(xi, pj))(
        jnp.asarray(x))
    score_t = vmap(lambda xi: mt.grad_log_density_pure(xi, pt))(
        torch.from_numpy(x))
    np.testing.assert_allclose(score_t.numpy(), np.asarray(score_j),
                               rtol=1e-12)
    closed = SUCCESSES / x - (TRIALS - SUCCESSES) / (1.0 - x)
    np.testing.assert_allclose(score_t.numpy(), closed, rtol=1e-12)


@pytest.mark.parametrize("trials,successes,error", [
    (np.ones(3), np.ones(2), "DimensionMismatchError"),
    ([5.0], [7.0], "ValueError"),
    ([5.0], [-1.0], "ValueError"),
    ([-2.0], [-3.0], "ValueError"),
])
def test_constructor_errors_match_jax(trials, successes, error):
    with pytest.raises(getattr(sv, error, ValueError)) as ej:
        sv.BinomialLikelihood(trials, successes)
    with pytest.raises(getattr(st, error, ValueError)) as et:
        st.BinomialLikelihood(trials, successes)
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)


def bounded_run(pkg, x0):
    trials = np.array([200.0, 100.0])
    successes = np.array([60.0, 85.0])
    model = pkg.BinomialLikelihood(trials, successes)
    n = x0.shape[0]
    kernel = pkg.GaussianRBFKernel(x0.copy(), pkg.ScaleMethod.MEDIAN, model)
    kw = {"device": "cpu"} if pkg is st else {}
    drv = pkg.SVGD(pkg.SVGDOptions(
        dimension=2, num_iterations=400, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model,
        optimizer=pkg.Adam(2, n, 0.005, 0.9, 0.999),
        lower_bound=np.array([1e-3, 1e-3]),
        upper_bound=np.array([1.0 - 1e-3, 1.0 - 1e-3]), **kw)).initialize()
    return np.asarray(drv.run()), successes / trials, trials


def test_bounded_run_matches_jax_and_concentrates_at_the_mle():
    x0 = np.random.default_rng(42).uniform(0.05, 0.95, (30, 2))
    want, _, _ = bounded_run(sv, x0)
    got, mle, trials = bounded_run(st, x0)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    assert (got > 0).all() and (got < 1).all()
    sd = np.sqrt(mle * (1 - mle) / trials)
    assert np.all(np.abs(got.mean(axis=0) - mle) < 4 * sd)
