"""svgdcpp_tpu_torch's intermediate-matrix debug dump against svgdcpp_tpu's.

* ``write_intermediate_matrices`` writes, byte for byte, the text of the
  JAX package's Python writer for the same arrays (also from tensors,
  appended with continuing step numbers), and raises the same RuntimeError
  when the file cannot be opened.
* ``log_intermediate_matrices=True`` on the driver forces the generic
  route; the stacked log_model_grad / kernel / kernel_grad / coords and
  the written file equal the JAX driver's (rtol 1e-10, the text compared
  after the same numbers are formatted), through run()'s plain loop and
  its eager hook loop, on the built-in RBF and on an asymmetric kernel.
The JAX runs are held to their Python writer (the native writer is the
JAX package's own option, and writes the same text).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svgdcpp_tpu as sv
import svgdcpp_tpu.utils.native as native_j
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.utils import logging as log_j
from svgdcpp_tpu_torch.utils import logging as log_t

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def python_writer_in_jax(monkeypatch):
    monkeypatch.setattr(native_j, "write_intermediate_log_native",
                        lambda *a, **k: False)


def random_logs(rng, steps, n, m):
    return {
        "log_model_grad": rng.normal(size=(steps, n, m)),
        "kernel": rng.normal(size=(steps, n, n)),
        "kernel_grad": rng.normal(size=(steps, n, n, m)),
        "coords": rng.normal(size=(steps, n, m)),
    }


@pytest.mark.parametrize("steps,n,m", [(2, 3, 2), (1, 5, 3)])
def test_writer_text_equals_jax(tmp_path, steps, n, m):
    logs = random_logs(np.random.default_rng(n), steps, n, m)
    log_j.write_intermediate_matrices(str(tmp_path / "j.txt"), logs)
    log_t.write_intermediate_matrices(
        str(tmp_path / "t.txt"),
        {k: torch.from_numpy(v) for k, v in logs.items()})
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    more = random_logs(np.random.default_rng(7), 1, n, m)
    log_j.write_intermediate_matrices(str(tmp_path / "j.txt"), more,
                                      start_step=steps + 1, append=True)
    log_t.write_intermediate_matrices(str(tmp_path / "t.txt"), more,
                                      start_step=steps + 1, append=True)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert f"========== Step {steps + 1} ==========" in (
        tmp_path / "t.txt").read_text()


def test_writer_open_failure_message(tmp_path):
    logs = random_logs(np.random.default_rng(0), 1, 2, 2)
    bad = str(tmp_path / "missing" / "log.txt")
    with pytest.raises(RuntimeError) as ej:
        log_j.write_intermediate_matrices(bad, logs)
    with pytest.raises(RuntimeError) as et:
        log_t.write_intermediate_matrices(bad, logs)
    assert str(et.value) == str(ej.value)
    assert "Cannot open" in str(et.value)


def asymmetric_kernel(pkg, dim):
    lib = torch if pkg is st else jnp
    p2 = np.array([[0.3, 0.2], [-0.2, 0.4]])

    def fn(x, params, loc):
        d = x - loc
        return lib.exp(-(d @ d) * params[0] - 0.1 * (x @ params[1] @ loc))

    return pkg.Kernel(dim, fn, (np.asarray(0.6), p2))


def hooked(pkg):
    """An MVN whose Step hook shrinks its mean each step."""
    class Hooked(pkg.MultivariateNormal):
        def step(self):
            mean, cov = self.parameters[0], self.parameters[1]
            self.update_parameters((mean * 0.9, cov))
    return Hooked


def logged_run(pkg, path, kernel_kind, hooks, phi_impl="auto"):
    n, dim, iters = 12, 2, 3
    x0 = np.random.default_rng(3).normal(size=(n, dim))
    cls = hooked(pkg) if hooks else pkg.MultivariateNormal
    model = cls(np.array([0.5, -0.2]), np.array([[1.0, 0.3], [0.3, 0.8]]))
    if kernel_kind == "rbf":
        kernel = pkg.GaussianRBFKernel(x0.copy(), pkg.ScaleMethod.MEDIAN,
                                       model, median_method="exact")
    else:
        kernel = asymmetric_kernel(pkg, dim)
    kw = {"device": "cpu"} if pkg is st else {}
    drv = pkg.SVGD(pkg.SVGDOptions(
        dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model, optimizer=pkg.Adam(dim, n, 0.1, 0.9, 0.999),
        log_intermediate_matrices=True,
        intermediate_matrices_output_path=str(path), phi_impl=phi_impl,
        **kw)).initialize()
    assert drv._phi_impl == "generic"
    assert drv._has_custom_hooks() == hooks
    drv.run()
    return drv


@pytest.mark.parametrize("kernel_kind", ["rbf", "asymmetric"])
@pytest.mark.parametrize("hooks", [False, True])
def test_driver_dump_equals_jax(tmp_path, kernel_kind, hooks):
    # phi_impl="dense" is overridden: the dump needs the generic route
    dj = logged_run(sv, tmp_path / "j.txt", kernel_kind, hooks, "auto")
    dt = logged_run(st, tmp_path / "t.txt", kernel_kind, hooks,
                    "dense" if kernel_kind == "rbf" else "auto")
    want, got = dj._intermediate_logs, dt._intermediate_logs
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == np.asarray(want[key]).shape, key
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=1e-10, atol=1e-13, err_msg=key)
    # the file is the writer's text of the stacks
    log_t.write_intermediate_matrices(str(tmp_path / "again.txt"), got)
    assert (tmp_path / "t.txt").read_bytes() == (
        tmp_path / "again.txt").read_bytes()
    text_j = (tmp_path / "j.txt").read_text().split()
    text_t = (tmp_path / "t.txt").read_text().split()
    assert len(text_t) == len(text_j)
    for a, b in zip(text_t, text_j):
        if a != b:
            np.testing.assert_allclose(float(a), float(b), rtol=1e-8,
                                       atol=1e-12)
