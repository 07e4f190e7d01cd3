"""The port's ``entry()`` (svgdcpp_tpu_torch/entry.py) against the JAX
package's ``__graft_entry__.entry()`` on the CPU.

* float32: the twin with ``device="cpu"`` against JAX's own ``entry()``
  after 1 and after 10 calls of ``fn``, both from the same seeded x0 (equal
  at the start). Both drivers take the dense route on the CPU (1024 is not
  above DENSE_PHI_MAX_PARTICLES) with the same step's exact median. The
  float32 sums differ in order, and AdaGrad's first steps, about
  lr * sign(g), let a rounding difference move a particle by more than
  phi's own error: 1.2e-7 after one call and 1.1e-5 after ten were read,
  so the tolerances are 1e-6 and 5e-5.
* float64: the twin with ``dtype=torch.float64`` against the JAX driver
  built by the same calls in float64, within 1e-10 after 1 and 10 calls
  (5e-14 was read after ten).
* ``fn`` is pure: it never writes into the tensors of the state it is
  given, and a state used twice gives the same next state.
* Without a card, ``entry()`` with its default device raises.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import __graft_entry__  # noqa: E402
import svgdcpp_tpu as sv  # noqa: E402
import svgdcpp_tpu_torch as st  # noqa: E402
from svgdcpp_tpu.utils.workloads import flagship_mvn  # noqa: E402
from svgdcpp_tpu_torch.entry import ENTRY_DIM, ENTRY_PARTICLES  # noqa: E402

torch.set_num_threads(1)

CALLS = (1, 10)
ATOL_F32 = {1: 1e-6, 10: 5e-5}
ATOL_F64 = 1e-10


def _jax_entry_f64():
    """``__graft_entry__.entry()``'s construction with a float64 x0."""
    n, dim = ENTRY_PARTICLES, ENTRY_DIM
    mean, cov, x0 = flagship_mvn(n, dtype=np.float64)
    model = sv.MultivariateNormal(mean, cov)
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=dim,
            num_iterations=1,
            coordinate_matrix=x0,
            kernel=kernel,
            model=model,
            optimizer=sv.AdaGrad(dim, n, 0.1),
        )
    )
    svgd.initialize()
    step_fn = svgd.build_step_fn()
    return (lambda state: step_fn(state)[0]), (svgd.make_state(),)


def _trajectory(fn, state, calls):
    """{k: coordinates after k calls of fn} for k in ``calls``."""
    out = {}
    for k in range(1, max(calls) + 1):
        state = fn(state)
        if k in calls:
            out[k] = np.asarray(state["coords"])
    return out


def _jax_trajectory(build):
    fn, (state,) = build()
    return np.asarray(state["coords"]), _trajectory(fn, state, CALLS)


def _torch_trajectory(dtype):
    fn, (state,) = st.entry(device="cpu", dtype=dtype)
    return state["coords"].numpy().copy(), _trajectory(fn, state, CALLS)


@pytest.mark.parametrize(
    "dtype, build",
    [(torch.float32, __graft_entry__.entry), (torch.float64, _jax_entry_f64)],
    ids=["float32", "float64"],
)
def test_entry_matches_jax_after_1_and_10_calls(dtype, build):
    x0_j, want = _jax_trajectory(build)
    x0_t, got = _torch_trajectory(dtype)
    assert x0_t.dtype == x0_j.dtype
    np.testing.assert_array_equal(x0_t, x0_j)
    for k in CALLS:
        assert got[k].dtype == want[k].dtype
        atol = ATOL_F32[k] if dtype == torch.float32 else ATOL_F64
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=f"after {k} calls")
        assert np.isfinite(got[k]).all()


def _tensors(tree, prefix=""):
    """(path, tensor) of every tensor in a nested dict/tuple/list state."""
    if torch.is_tensor(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return []
    return [pair for key, value in items
            for pair in _tensors(value, f"{prefix}/{key}")]


def test_entry_fn_is_pure():
    fn, (state,) = st.entry(device="cpu")
    before = [(path, t.clone()) for path, t in _tensors(state)]
    assert {path for path, _ in before} >= {"/coords", "/opt_state/s"}
    first = fn(state)
    for (path, saved), (_, now) in zip(before, _tensors(state)):
        assert torch.equal(saved, now), f"fn wrote into {path}"
    assert first["coords"] is not state["coords"]
    assert not torch.equal(first["coords"], state["coords"])
    assert first["iteration"] == state["iteration"] + 1
    again = fn(state)
    for (path, a), (_, b) in zip(_tensors(first), _tensors(again)):
        assert torch.equal(a, b), f"a second call differs at {path}"


def test_entry_takes_the_dense_route_on_the_cpu(monkeypatch):
    # The card's route (fused_cuda, K1's square form) is chip_smoke.py's
    # phase 47; on the CPU the JAX driver's rule takes the dense route.
    built = []
    initialize = st.SVGD.initialize

    def record(self):
        built.append(self)
        return initialize(self)

    monkeypatch.setattr(st.SVGD, "initialize", record)
    _, (state,) = st.entry(device="cpu")
    assert [svgd._phi_impl for svgd in built] == ["dense"]
    assert tuple(state["coords"].shape) == (ENTRY_PARTICLES, ENTRY_DIM)
    assert state["coords"].device.type == "cpu"


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.entry(device="cuda", dtype=torch.float64)
