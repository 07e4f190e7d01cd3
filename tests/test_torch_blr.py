"""svgdcpp_tpu_torch's Bayesian logistic regression path against
svgdcpp_tpu's (the bench's --config blr and --config hier).

* The models: log-density and the closed-form score against the JAX
  models, float64, d = 5 and 50, flat and hierarchical: rtol 1e-10 (the
  same arithmetic summed in another order); the closed-form score against
  torch.func.grad of the log-density: rtol 1e-10.
* blr_workload equal, array for array, to bench.make_blr_workload.
* The drivers, built by utils/workloads.build_blr_svgd as the bench builds
  its own: hierarchical BLR at n=64 (auto -> rbf_terms) and n=1100 (auto ->
  fused_terms on the CPU), flat BLR at d=50, n=64 (dense) and n=1100
  (fused), 5 Adam steps in float64 from the same x0: rtol 1e-9 (measured
  max |dcoords| about 1e-14 relative).
* One step from the SAME state (the JAX make_state() carried over by
  utils/convert.py, composed kernel parameters and Adam's m, v and integer
  count included) on the hierarchical rbf_terms and fused_terms routes:
  rtol 1e-9.
* float32 coordinates with the float64 data the workload gives: the model
  parameters reach the step in float32, the coordinates stay float32, and
  the run stays within 1e-4 of the float64 run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import bench
import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu_torch.models import bayesian_logistic_regression as blr_t
from svgdcpp_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from svgdcpp_tpu_torch.utils.workloads import blr_workload, build_blr_svgd

# The suite runs several xdist workers on one CPU: torch's default of an
# OpenMP thread per core in each of them oversubscribes it.
torch.set_num_threads(1)


def data(d, n_data=200, seed=3):
    rng = np.random.default_rng(seed)
    feats, labels, _ = blr_t.make_synthetic_classification(rng, n_data, d)
    return feats.numpy(), labels.numpy()


def models(d, hierarchical):
    feats, labels = data(d)
    if hierarchical:
        return (
            sv.HierarchicalBayesianLogisticRegression(feats, labels, 1.5, 0.02),
            st.HierarchicalBayesianLogisticRegression(feats, labels, 1.5, 0.02),
            d + 1,
        )
    return (
        sv.BayesianLogisticRegression(feats, labels, 0.1),
        st.BayesianLogisticRegression(feats, labels, 0.1),
        d,
    )


def points(dim, seed=4):
    return np.random.default_rng(seed).normal(size=(7, dim)) * 0.5


@pytest.mark.parametrize("d", [5, 50])
@pytest.mark.parametrize("hierarchical", [False, True])
def test_log_density_and_score_match_jax(d, hierarchical):
    mj, mt, dim = models(d, hierarchical)
    x = points(dim)
    np.testing.assert_allclose(
        mt.evaluate_log_model(x).numpy(),
        np.asarray(mj.evaluate_log_model(x)), rtol=1e-10,
    )
    pj = tuple(mj.parameters)
    pt = tuple(mt.parameters)
    want = jax.vmap(lambda xi: mj.grad_log_density_pure(xi, pj))(jnp.asarray(x))
    got = vmap(lambda xi: mt.grad_log_density_pure(xi, pt))(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


@pytest.mark.parametrize("hierarchical", [False, True])
def test_closed_form_score_matches_autodiff(hierarchical):
    _, mt, dim = models(5, hierarchical)
    x = torch.from_numpy(points(dim, seed=5))
    params = tuple(mt.parameters)
    closed = vmap(lambda xi: mt.grad_log_density_pure(xi, params))(x)
    auto = vmap(lambda xi: grad(mt.log_density_pure)(xi, params))(x)
    np.testing.assert_allclose(closed.numpy(), auto.numpy(), rtol=1e-10)


@pytest.mark.parametrize("particles,dim,hierarchical",
                         [(200, 10, False), (64, 10, True)])
def test_blr_workload_equals_the_bench(particles, dim, hierarchical):
    got = blr_workload(particles, dim, hierarchical=hierarchical)
    want = bench.make_blr_workload(particles, dim, hierarchical=hierarchical)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


DRIVER_CASES = [
    (64, 5, True, "rbf_terms"),
    (1100, 5, True, "fused_terms"),
    (64, 50, False, "dense"),
    (1100, 50, False, "fused"),
]


@pytest.mark.parametrize("n,d,hierarchical,route", DRIVER_CASES)
def test_driver_five_adam_steps_match_jax(n, d, hierarchical, route):
    feats, labels, x0 = blr_workload(n, d, hierarchical=hierarchical)
    x0 = x0.astype(np.float64)
    sj = bench.build_blr_svgd(x0, feats, labels, hierarchical=hierarchical,
                              steps_per_call=5)
    s_t = build_blr_svgd(x0, feats, labels, hierarchical=hierarchical,
                         num_iterations=5, device="cpu")
    assert sj._phi_impl == s_t._phi_impl == route
    out_j = np.asarray(sj.run())
    out_t = s_t.run().numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-9, atol=1e-12)
    assert s_t._iteration == 5


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("n,route", [(64, "rbf_terms"), (1100, "fused_terms")])
def test_one_step_from_converted_hier_state(n, route):
    feats, labels, x0 = blr_workload(n, 5, hierarchical=True)
    x0 = x0.astype(np.float64)
    sj = bench.build_blr_svgd(x0, feats, labels, hierarchical=True,
                              steps_per_call=1)
    s_t = build_blr_svgd(x0, feats, labels, hierarchical=True,
                         num_iterations=1, device="cpu")
    assert sj._phi_impl == s_t._phi_impl == route
    sj.run()  # a non-zero Adam state and count to carry across
    np_state = jax.device_get(sj.make_state())
    assert int(np_state["opt_state"]["count"]) == 1
    want, _ = jax.jit(sj.build_step_fn())(np_state)
    torch_state = state_from_numpy(np_state, device="cpu")
    assert torch_state["opt_state"]["count"].dtype == torch.int32
    assert len(torch_state["kernel_params"]) == 2
    got, _ = s_t.build_step_fn()(torch_state)
    got, want = state_to_numpy(got), jax.device_get(want)
    for key in ("coords", "opt_state", "kernel_params", "scale_aux",
                "model_params"):
        lg, lw = _leaves(got[key]), _leaves(want[key])
        assert len(lg) == len(lw), key
        for a, b in zip(lg, lw):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            np.testing.assert_allclose(
                a, b, rtol=1e-9, atol=1e-9 * max(1.0, np.abs(b).max()),
                err_msg=key,
            )
    assert int(got["iteration"]) == int(want["iteration"]) == 2


@pytest.mark.parametrize("hierarchical", [False, True])
def test_float32_coords_with_float64_data(hierarchical):
    d = 5
    feats, labels, x0 = blr_workload(300, d, hierarchical=hierarchical)
    assert feats.dtype == np.float64 and x0.dtype == np.float32
    s32 = build_blr_svgd(torch.from_numpy(x0), feats, labels,
                         hierarchical=hierarchical, num_iterations=4)
    state = s32.make_state()
    assert all(p.dtype == torch.float32 for p in state["model_params"])
    out32 = s32.run()
    assert out32.dtype == torch.float32
    s64 = build_blr_svgd(x0.astype(np.float64), feats, labels,
                         hierarchical=hierarchical, num_iterations=4,
                         device="cpu")
    np.testing.assert_allclose(
        out32.double().numpy(), s64.run().numpy(), rtol=0, atol=1e-4
    )
