"""svgdcpp_tpu_torch's checkpoints against svgdcpp_tpu's.

* The port's own round trip: 5 steps, save, restore into a fresh driver,
  5 more steps equal 10 uninterrupted ones (JAX's tolerance, rtol 1e-12,
  atol 1e-15); a missing key raises KeyError; ``iteration`` is saved as an
  int32 0-d array and comes back a Python int.
* The npz keys of the drivers' states are the JAX package's, for AdaGrad,
  Adam and RMSProp, with one adaptive slot (an RBF) and two (RBF MEDIAN +
  RBF HESSIAN), on a plain route and a fused one; None leaves have no key.
* Across the packages: a JAX save restores in the port and a port save
  restores in JAX, with equal keys and arrays, and each continues as the
  other's run does (float64, rtol 1e-10).
"""

import jax
import numpy as np
import pytest
import torch

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.utils import checkpoint as ck_j
from svgdcpp_tpu_torch.utils import checkpoint as ck_t

torch.set_num_threads(1)

MEAN = np.array([0.5, -1.0])
COV = np.array([[1.0, 0.2], [0.2, 0.8]])

OPTIMIZERS = {
    "adagrad": lambda pkg, n: pkg.AdaGrad(2, n, 0.1),
    "adam": lambda pkg, n: pkg.Adam(2, n, 0.1, 0.9, 0.999),
    "rmsprop": lambda pkg, n: pkg.RMSProp(2, n, 0.05, 0.9),
}


def build(pkg, x0, iters, optimizer="adam", slots=1, impl="auto"):
    n = x0.shape[0]
    model = pkg.MultivariateNormal(MEAN, COV)
    kernel = pkg.GaussianRBFKernel(x0.copy(), pkg.ScaleMethod.MEDIAN, model)
    if slots == 2:
        kernel = kernel + pkg.GaussianRBFKernel(
            x0.copy(), pkg.ScaleMethod.HESSIAN, model)
    kw = {"device": "cpu"} if pkg is st else {}
    return pkg.SVGD(pkg.SVGDOptions(
        dimension=2, num_iterations=iters, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model, optimizer=OPTIMIZERS[optimizer](pkg, n),
        phi_impl=impl, **kw)).initialize()


def x0_for(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 2)) * 2.0


def test_round_trip_resumes_exactly(tmp_path):
    x0 = x0_for(12)
    full = build(st, x0, 10).run().numpy()
    a = build(st, x0, 5)
    a.run()
    path = ck_t.save_checkpoint(tmp_path / "ck", a.make_state(), step=5)
    assert path.endswith(".npz")
    b = build(st, x0, 5)
    restored, step = ck_t.restore_checkpoint(tmp_path / "ck", b.make_state())
    assert step == 5 and restored["iteration"] == 5
    assert isinstance(restored["iteration"], int)
    assert restored["coords"].dtype == torch.float64
    b._absorb_state(restored)
    np.testing.assert_allclose(b.run().numpy(), full, rtol=1e-12, atol=1e-15)
    saved = np.load(tmp_path / "ck.npz")
    assert saved["iteration"].dtype == np.int32 and saved["iteration"].shape == ()


def test_missing_key_raises(tmp_path):
    s = build(st, x0_for(8), 1)
    state = s.make_state()
    ck_t.save_checkpoint(tmp_path / "ck", {"coords": state["coords"]})
    with pytest.raises(KeyError, match="missing keys"):
        ck_t.restore_checkpoint(tmp_path / "ck", state)


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
@pytest.mark.parametrize("slots,impl", [(1, "dense"), (2, "rbf_terms"),
                                        (1, "fused")])
def test_keys_equal_jax(optimizer, slots, impl):
    x0 = x0_for(16, seed=1)
    sj = build(sv, x0, 2, optimizer, slots, impl)
    s_t = build(st, x0, 2, optimizer, slots, impl)
    sj.run()
    s_t.run()
    keys_j = sorted(ck_j._flatten_with_paths(jax.device_get(sj.make_state())))
    keys_t = sorted(ck_t._flatten_with_paths(s_t.make_state()))
    assert keys_t == keys_j
    if slots == 2:  # the HESSIAN slot has no aux: no key
        assert not any(k.startswith("scale_aux/1") for k in keys_t)


@pytest.mark.parametrize("optimizer", ["adam", "rmsprop"])
def test_saves_cross_between_the_packages(tmp_path, optimizer):
    x0 = x0_for(16, seed=2)
    sj = build(sv, x0, 4, optimizer)
    s_t = build(st, x0, 4, optimizer)
    sj.run()
    s_t.run()
    ck_j.save_checkpoint(tmp_path / "j", sj.make_state(), step=4)
    ck_t.save_checkpoint(tmp_path / "t", s_t.make_state(), step=4)
    dj, dt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(dj.files) == sorted(dt.files)
    for key in dj.files:
        assert dt[key].dtype == dj[key].dtype, key
        np.testing.assert_allclose(dt[key], dj[key], rtol=1e-10, atol=1e-13,
                                   err_msg=key)
    # each package resumes from the other's file and runs 4 more steps
    rj = build(sv, x0, 4, optimizer)
    state, step = ck_j.restore_checkpoint(tmp_path / "t", rj.make_state())
    rj._absorb_state(state)
    rt = build(st, x0, 4, optimizer)
    state, step_t = ck_t.restore_checkpoint(tmp_path / "j", rt.make_state())
    rt._absorb_state(state)
    assert step == step_t == 4
    cont_j = np.asarray(sj.run())
    cont_t = s_t.run().numpy()
    np.testing.assert_allclose(np.asarray(rj.run()), cont_t, rtol=1e-10,
                               atol=1e-13)
    np.testing.assert_allclose(rt.run().numpy(), cont_j, rtol=1e-10,
                               atol=1e-13)
    assert rj._iteration == rt._iteration == 8
