"""The port's figures and notebooks on the CPU: examples/torch_plot_results.py
and examples/torch_{mvn,gmm}_example.ipynb, the twins of
tests/test_examples.py's figure and notebook checks.

* Each torch notebook is valid nbformat-4 JSON with no stored outputs; its
  code cells execute end to end with ``DEVICE = "cuda"`` replaced by
  ``"cpu"`` and ``plt.show()`` by ``plt.close('all')`` (both replacements
  must happen), and its run ends near the target (the mvn notebook's
  posterior mean within tests/test_examples.py's Monte-Carlo bound, the gmm
  notebook's particles on both modes).
* ``torch_plot_results.main(tmp, quick=True, device="cpu")`` writes a real
  2x2 overlay, a PNG over 20 kB.
* Neither the script nor a notebook imports the JAX package or a JAX
  example.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
sys.path.insert(0, str(EXAMPLES))

import torch_plot_results  # noqa: E402

torch.set_num_threads(1)

NOTEBOOKS = ("torch_mvn_example.ipynb", "torch_gmm_example.ipynb")
#: An import of JAX, of the JAX package or of a JAX example.
JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|svgdcpp_tpu|plot_results|mvn_example|"
    r"gmm_example|blr_example|hierarchical_example)\b", re.MULTILINE)


def _code(name):
    nb = json.loads((EXAMPLES / name).read_text())
    assert nb["nbformat"] == 4
    cells = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert all(c["outputs"] == [] and c["execution_count"] is None
               for c in cells), f"{name} stores outputs"
    return "\n".join("".join(c["source"]) for c in cells)


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_torch_notebook_executes_on_the_cpu(name):
    code = _code(name)
    assert "svgdcpp_tpu_torch" in code and "torch_plot_results" in code
    assert not JAX_IMPORT.search(code)
    device_line = 'DEVICE = "cuda"'
    assert device_line in code.splitlines(), "DEVICE not on a line of its own"
    assert "plt.show()" in code
    cpu = code.replace(device_line, 'DEVICE = "cpu"')
    cpu = cpu.replace("plt.show()", "plt.close('all')")
    assert device_line not in cpu and "plt.show()" not in cpu
    ns = {"__name__": f"nb_{name}"}
    exec(compile(cpu, str(EXAMPLES / name), "exec"), ns)
    assert ns["DEVICE"] == "cpu"
    final = ns["final"]
    if "mvn" in name:
        mean, cov, x0 = ns["mean"], ns["cov"], ns["x0"]
        tol = 2.0 * np.sqrt(np.diag(cov) / x0.shape[0])
        assert np.all(np.abs(final.mean(axis=0) - mean) < tol)
    else:
        near_1 = ns["d1"] < ns["d2"]
        assert 0 < near_1.sum() < len(near_1)


def test_torch_plot_results_writes_the_overlay(tmp_path):
    path = torch_plot_results.main(tmp_path, quick=True, device="cpu")
    assert path == tmp_path / "torch_examples_overlay.png"
    assert path.exists()
    assert path.stat().st_size > 20_000  # a real 2x2 overlay, not a stub


def test_torch_plot_results_imports_no_jax():
    probe = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "import torch_plot_results; "
             "print(sorted(m for m in ('jax', 'svgdcpp_tpu') "
             "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", probe, str(EXAMPLES)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
