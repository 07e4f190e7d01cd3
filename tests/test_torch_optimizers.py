"""svgdcpp_tpu_torch optimizers against svgdcpp_tpu: 10 steps on the same
numpy gradients, float64, rtol 1e-12 (the same update formulas)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st

# The suite runs several xdist workers on one CPU: torch's default of an
# OpenMP thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

FACTORIES = {
    "adagrad": lambda pkg: pkg.AdaGrad(3, 8, 0.1),
    "adam": lambda pkg: pkg.Adam(3, 8, 0.05, 0.9, 0.999),
    "rmsprop": lambda pkg: pkg.RMSProp(3, 8, 0.02, 0.9, 1e-6),
}


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_ten_steps_match_jax(rng, name):
    oj = FACTORIES[name](sv)
    ot = FACTORIES[name](st)
    sj = oj.init(jnp.float64)
    s_t = ot.init(torch.float64)
    for _ in range(10):
        g = rng.normal(size=(8, 3))
        sj, inc_j = oj.step(sj, jnp.asarray(g))
        s_t, inc_t = ot.step(s_t, torch.from_numpy(g))
        np.testing.assert_allclose(inc_t.numpy(), np.asarray(inc_j), rtol=1e-12)
    for key in sj:
        np.testing.assert_allclose(
            np.asarray(s_t[key]), np.asarray(sj[key]), rtol=1e-12
        )


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_stateful_api_matches_jax(rng, name):
    oj = FACTORIES[name](sv).Initialize(jnp.float64)
    ot = FACTORIES[name](st).Initialize(torch.float64)
    for _ in range(3):
        g = rng.normal(size=(8, 3))
        np.testing.assert_allclose(
            ot.Step(torch.from_numpy(g)).numpy(), np.asarray(oj.Step(g)), rtol=1e-12
        )


def test_beta_validation_messages_match_jax():
    cases = [
        lambda pkg: pkg.Adam(2, 2, 0.1, 1.0, 0.9),
        lambda pkg: pkg.Adam(2, 2, 0.1, 0.9, -0.1),
        lambda pkg: pkg.RMSProp(2, 2, 0.1, 1.5),
    ]
    for case in cases:
        with pytest.raises(Exception) as ej:
            case(sv)
        with pytest.raises(Exception) as et:
            case(st)
        assert str(et.value) == str(ej.value)
