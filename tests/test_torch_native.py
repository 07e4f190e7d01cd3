"""svgdcpp_tpu_torch.utils.native: the C++ host helpers built from
native/svgd_host.cpp into the port's _build/.

* Where g++ is on PATH the library must build (``native_available()``),
  into ``svgdcpp_tpu_torch/_build/`` and never into ``native/``; without
  the library the NumPy answers stand in, as in the JAX package.
* ``kth_element`` and ``host_median`` against numpy, with and without the
  library.
* The native writer's text, byte for byte, against the port's Python
  writer and the JAX package's Python writer.
* The C++ oracle (float64, exact median every step) against the port's
  ``dense`` driver, rtol 1e-9 (the mirror of tests/test_checkpoint.py's
  cross-language check).
"""

import shutil

import numpy as np
import pytest
import torch

import svgdcpp_tpu.utils.native as native_j
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.utils import logging as log_j
from svgdcpp_tpu_torch.utils import cuda_build
from svgdcpp_tpu_torch.utils import logging as log_t
from svgdcpp_tpu_torch.utils import native

torch.set_num_threads(1)


def test_builds_where_gxx_is():
    if shutil.which("g++") is None:
        assert not native.native_available()
        return
    assert native.native_available()
    path = native.library_path()
    assert path.parent == cuda_build.BUILD_DIR and path.is_file()


def test_build_writes_only_under_build(tmp_path, monkeypatch):
    """A fresh build runs g++ (never make) with its output in _build/, and
    native/ is left as it was."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: nothing is built")
    native_dir = native.SOURCE.parent
    before = {p.name: p.stat().st_mtime_ns for p in native_dir.iterdir()}
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build_dir)
    commands = []
    run = native.subprocess.run

    def spy(cmd, **kw):
        commands.append(cmd)
        return run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", spy)
    path = native.build()
    assert path.parent == build_dir and path.is_file()
    assert len(commands) == 1 and commands[0][0].endswith("g++")
    assert list(native.CXX_FLAGS) == commands[0][1:5]
    assert native.build() == path and len(commands) == 1  # kept
    assert {p.name: p.stat().st_mtime_ns
            for p in native_dir.iterdir()} == before


@pytest.mark.parametrize("use_library", [True, False])
@pytest.mark.parametrize("size", [1, 7, 64, 1001])
def test_selection_matches_numpy(monkeypatch, use_library, size):
    if not use_library:
        monkeypatch.setattr(native, "_load", lambda: None)
    values = np.random.default_rng(size).normal(size=size)
    for k in {0, size // 2, size - 1}:
        assert native.kth_element(values, k) == np.sort(values)[k]
    s = np.sort(values)
    want = (0.5 * (s[size // 2 - 1] + s[size // 2]) if size % 2 == 0
            else s[size // 2])
    assert native.host_median(torch.from_numpy(values)) == want
    with pytest.raises(IndexError):
        native.kth_element(values, size)
    with pytest.raises(ValueError):
        native.host_median(np.zeros(0))


@pytest.mark.parametrize("steps,n,m", [(2, 3, 2), (1, 6, 3)])
def test_native_text_equals_the_python_writers(tmp_path, monkeypatch, steps,
                                               n, m):
    if not native.native_available():
        pytest.skip("no native library to compare")
    rng = np.random.default_rng(n)
    logs = {
        "log_model_grad": rng.normal(size=(steps, n, m)),
        "kernel": rng.normal(size=(steps, n, n)),
        "kernel_grad": rng.normal(size=(steps, n, n, m)) * 1e-7,
        "coords": rng.normal(size=(steps, n, m)) * 1e5,
    }
    log_t.write_intermediate_matrices(str(tmp_path / "native.txt"), logs)
    log_t.write_intermediate_matrices_python(
        str(tmp_path / "python.txt"), *(logs[k] for k in (
            "log_model_grad", "kernel", "kernel_grad", "coords")))
    monkeypatch.setattr(native_j, "write_intermediate_log_native",
                        lambda *a, **k: False)
    log_j.write_intermediate_matrices(str(tmp_path / "jax.txt"), logs)
    text = (tmp_path / "native.txt").read_bytes()
    assert text == (tmp_path / "python.txt").read_bytes()
    assert text == (tmp_path / "jax.txt").read_bytes()
    # Appending through the native writer continues the step numbers.
    log_t.write_intermediate_matrices(str(tmp_path / "native.txt"), logs,
                                      start_step=steps + 1, append=True)
    assert (tmp_path / "native.txt").read_text().count(
        "========== Step") == 2 * steps


def test_native_writer_failure_keeps_the_reference_message(tmp_path):
    if not native.native_available():
        pytest.skip("no native library")
    logs = {k: np.zeros((1, 2, 2)) for k in ("log_model_grad", "kernel",
                                              "coords")}
    logs["kernel_grad"] = np.zeros((1, 2, 2, 2))
    bad = str(tmp_path / "missing" / "log.txt")
    with pytest.raises(RuntimeError, match="Cannot open .* for writing"):
        log_t.write_intermediate_matrices(bad, logs)


def test_cpp_oracle_matches_the_dense_driver():
    n, dim, iters = 12, 2, 8
    mean = np.array([-0.6871, 0.8010])
    cov = 5 * np.array([[0.2260, 0.1652], [0.1652, 0.6779]])
    x0 = np.random.default_rng(42).uniform(-3, 3, (n, dim))
    cpp = native.cpp_oracle_mvn_rbf_adagrad(
        x0, mean, np.linalg.inv(cov), gamma=None, lr=0.1, iters=iters)
    if shutil.which("g++") is None:
        assert cpp is None
        return
    model = st.MultivariateNormal(mean, cov)
    kernel = st.GaussianRBFKernel(x0, st.ScaleMethod.MEDIAN, model,
                                  median_method="exact")
    svgd = st.SVGD(st.SVGDOptions(
        dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model, optimizer=st.AdaGrad(dim, n, 0.1),
        phi_impl="dense", device="cpu")).initialize()
    got = svgd.run().numpy()
    np.testing.assert_allclose(got, cpp, rtol=1e-9, atol=1e-12)
    assert np.abs(got - x0).max() > 1e-2
