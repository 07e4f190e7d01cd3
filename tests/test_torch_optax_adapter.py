"""svgdcpp_tpu_torch's ``TorchOptimizer`` (a torch.optim class behind the
init/step contract) against svgdcpp_tpu's ``OptaxOptimizer`` on optax.

float64 throughout. One step of SGD: rtol 1e-12 (JAX
tests/test_optimizers.py:109-119). Drivers over 50 steps: atol 1e-8 (torch's
and optax's Adam order their operations differently). The state is a plain
dict of tensors, so a step is a pure function of its arguments, and it goes
through a checkpoint, a row split and a hot-swap.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(1)

MEAN = np.array([1.0, -1.0])
COV = 0.5 * np.eye(2)


def test_sgd_increment_is_lr_times_phi(rng):
    opt = st.TorchOptimizer(torch.optim.SGD, 2, 4, lr=0.05)
    state = opt.init(torch.float64)
    g = torch.from_numpy(rng.normal(size=(4, 2)))
    _, inc = opt.step(state, g)
    np.testing.assert_allclose(inc.numpy(), 0.05 * g.numpy(), rtol=1e-12)
    params = torch.from_numpy(rng.normal(size=(4, 2)))
    _, inc = opt.step(state, g, params)
    np.testing.assert_allclose(inc.numpy(), 0.05 * g.numpy(), rtol=1e-12)


def test_adam_state_is_torchs_and_steps_are_pure(rng):
    opt = st.TorchOptimizer(torch.optim.Adam, 2, 4, lr=0.1)
    state = opt.init(torch.float64)
    assert set(state["param"]) == {"step", "exp_avg", "exp_avg_sq"}
    assert int(state["steps"]) == 0 and state["steps"].device.type == "cpu"
    # torch keeps Adam's step on the host unless capturable=True.
    assert state["param"]["step"].device.type == "cpu"
    g = torch.from_numpy(rng.normal(size=(4, 2)))
    x = torch.from_numpy(rng.normal(size=(4, 2)))
    s1, inc1 = opt.step(state, g, x)
    s1_copy = {k: v.clone() for k, v in s1["param"].items()}
    s2a, inc2a = opt.step(s1, g, x)
    s2b, inc2b = opt.step(s1, g, x)
    torch.testing.assert_close(inc2a, inc2b, rtol=0, atol=0)
    for k, v in s1_copy.items():  # the input state is not touched
        torch.testing.assert_close(s1["param"][k], v, rtol=0, atol=0)
    assert float(s2a["param"]["step"]) == 2.0 and int(s2a["steps"]) == 2
    # The first step starts the optimizer afresh: bias correction at t = 1.
    np.testing.assert_allclose(
        inc1.numpy(), 0.1 * g.numpy() / (np.abs(g.numpy()) + 1e-8),
        rtol=1e-12)


def test_adam_state_splits_by_rows():
    opt = st.TorchOptimizer(torch.optim.Adam, 3, 5, lr=0.1)
    state = opt.init(torch.float64)
    flags = opt.state_is_particle_sharded(state)
    assert flags == {"steps": False, "param": {
        "step": False, "exp_avg": True, "exp_avg_sq": True}}
    local = opt.shard_state(state, slice(2, 4))
    assert local["param"]["exp_avg"].shape == (2, 3)
    assert local["param"]["step"] is state["param"]["step"]


def build(pkg, x0, iters, optimizer, impl="dense"):
    n, dim = x0.shape
    model = pkg.MultivariateNormal(MEAN, COV)
    kernel = pkg.GaussianRBFKernel(x0, pkg.ScaleMethod.MEDIAN, model)
    opts = dict(dimension=dim, num_iterations=iters,
                coordinate_matrix=x0.copy(), kernel=kernel, model=model,
                optimizer=optimizer, phi_impl=impl)
    if pkg is st:
        opts["device"] = "cpu"
    return pkg.SVGD(pkg.SVGDOptions(**opts)).initialize()


ADAPTERS = {
    "adam": (lambda n: st.TorchOptimizer(torch.optim.Adam, 2, n, lr=0.1),
             lambda n: sv.OptaxOptimizer(optax.adam(0.1), 2, n)),
    "adamw": (lambda n: st.TorchOptimizer(torch.optim.AdamW, 2, n, lr=0.1,
                                          weight_decay=1e-2),
              lambda n: sv.OptaxOptimizer(
                  optax.adamw(0.1, weight_decay=1e-2), 2, n)),
    "sgd_momentum": (
        lambda n: st.TorchOptimizer(torch.optim.SGD, 2, n, lr=0.05,
                                    momentum=0.9),
        lambda n: sv.OptaxOptimizer(optax.sgd(0.05, momentum=0.9), 2, n)),
}


@pytest.mark.parametrize("name", sorted(ADAPTERS))
def test_driver_matches_jax_on_optax(rng, name):
    make_t, make_j = ADAPTERS[name]
    x0 = rng.normal(size=(16, 2)) * 2
    got = build(st, x0, 50, make_t(16)).run().numpy()
    want = np.asarray(build(sv, x0, 50, make_j(16)).run())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
    assert np.abs(got - x0).max() > 0.1


def test_adamw_reads_the_coordinates(rng):
    """The same gradient at other coordinates gives another increment, as
    optax.adamw's does, and both equal step for step."""
    opt_t = st.TorchOptimizer(torch.optim.AdamW, 2, 4, lr=0.1,
                              weight_decay=1e-2)
    opt_j = sv.OptaxOptimizer(optax.adamw(0.1, weight_decay=1e-2), 2, 4)
    s_t, s_j = opt_t.init(torch.float64), opt_j.init(jnp.float64)
    g = rng.normal(size=(4, 2))
    incs = []
    for p in (np.zeros((4, 2)), np.ones((4, 2))):
        _, inc_t = opt_t.step(s_t, torch.from_numpy(g), torch.from_numpy(p))
        _, inc_j = opt_j.step(s_j, jnp.asarray(g), jnp.asarray(p))
        np.testing.assert_allclose(inc_t.numpy(), np.asarray(inc_j),
                                   rtol=1e-12, atol=1e-15)
        incs.append(inc_t.numpy())
    assert not np.allclose(*incs)


def test_checkpoint_round_trip_resumes_exactly(rng, tmp_path):
    x0 = rng.normal(size=(16, 2)) * 2

    def driver(iters):
        return build(st, x0, iters, ADAPTERS["adam"][0](16))

    full = driver(10).run()
    first = driver(5)
    first.run()
    save_checkpoint(tmp_path / "ck", first.make_state(), step=5)
    second = driver(5)
    restored, step = restore_checkpoint(tmp_path / "ck", second.make_state())
    assert step == 5 and int(restored["opt_state"]["steps"]) == 5
    assert restored["opt_state"]["param"]["step"].device.type == "cpu"
    second._absorb_state(restored)
    np.testing.assert_array_equal(second.run().numpy(), full.numpy())


def test_hot_swap_matches_jax(rng):
    """A model hot-swap between runs keeps the adapter's state, as the JAX
    driver keeps optax's."""
    x0 = rng.normal(size=(16, 2)) * 2
    outs = []
    for pkg, make in ((st, ADAPTERS["adam"][0]), (sv, ADAPTERS["adam"][1])):
        s = build(pkg, x0, 10, make(16))
        s.run()
        s.update_model_parameters((MEAN * 0.5, COV))
        outs.append(np.asarray(s.run()))
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-8)
