"""What importing svgdcpp_tpu_torch (its sharded engine included) does and
does not do, on a machine without a CUDA device: no jax, no triton, no
kernel build, no change to torch's global settings; a CUDA-only call raises instead of computing on
the CPU; and an installed package carries every file its kernels' build
reads."""

import fnmatch
import os
import re
import shutil
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest
import torch

from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.utils import cuda_build

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys, torch
dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
precision = torch.get_float32_matmul_precision()
import svgdcpp_tpu_torch
import svgdcpp_tpu_torch.parallel
from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.utils import convert, workloads
assert "jax" not in sys.modules, "jax imported"
assert "triton" not in sys.modules, "triton imported"
assert "svgdcpp_tpu" not in sys.modules, "the JAX package imported"
assert not cuda_phi.library_loaded(), "kernels built at import"
assert torch.get_default_dtype() == dtype
assert torch.get_num_threads() == threads
assert torch.get_float32_matmul_precision() == precision
print("clean")
"""


def test_import_is_clean_in_a_fresh_process():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_package_source_never_imports_jax():
    forbidden = re.compile(r"^\s*(?:import|from)\s+(?:jax|svgdcpp_tpu)\b", re.M)
    sources = list((REPO / "svgdcpp_tpu_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    for path in sources:
        assert not forbidden.search(path.read_text()), path


def test_missing_nvcc_raises_with_the_command(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc") as err:
        cuda_build.build_library(cuda_phi.LIBRARY, cuda_phi.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in str(err.value)
    for src in cuda_phi.SOURCES:  # one compile command per source
        assert str(src) in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_non_cpu_tensor_never_falls_back_to_the_plain_version():
    x = torch.empty((8, 2), device="meta")
    thr = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_phi.phi_rbf_fused_cuda(x, x, 0.5, thr)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_phi.phi_rbf_fused_cuda_cross(x, x, x, 0.5, thr)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_phi.phi_rbf_terms_fused_cuda(x, x, [0.5, 0.1], (1, 1), thr)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_phi.phi_rbf_terms_fused_cuda_cross(x, x, x, [0.5], (1,), thr)
    p = torch.eye(2, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_phi.phi_rbf_aniso_terms_fused_cuda(x, x, [0.5], (1,), [p], (1,),
                                                thr)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_phi.phi_rbf_cuda(x, x, p)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_phi.count_le_cuda(x, x, thr)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_phi.phi_rbf_fused_sym_chunk_cuda(x, x, 0.5, thr, 1, 0)
    assert not cuda_phi.library_loaded()


def test_package_data_covers_every_kernel_include():
    """Every source the build compiles, and every file a csrc/ source
    includes with #include "...", matches a package-data glob of
    pyproject.toml, so an installed package can build its kernels."""
    config = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = config["tool"]["setuptools"]["package-data"]["svgdcpp_tpu_torch"]
    package = REPO / "svgdcpp_tpu_torch"
    csrc = package / "csrc"
    needed = {src.relative_to(package).as_posix() for src in cuda_phi.SOURCES}
    for src in csrc.iterdir():
        for name in re.findall(r'^\s*#include\s+"([^"]+)"', src.read_text(),
                               re.M):
            assert (csrc / name).is_file(), (src.name, name)
            needed.add(f"csrc/{name}")
    assert "csrc/sweep_common.cuh" in needed
    assert "csrc/fused_phi_panel.cu" in needed
    assert "csrc/count_le.cu" in needed
    assert "csrc/counts_sym.cuh" in needed
    for rel in sorted(needed):
        assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)


def test_chip_smoke_fails_without_a_card_or_alone(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line here (no
    CUDA device), and in a directory that holds only the script."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for cwd in (REPO, tmp_path):
        out = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
            text=True, timeout=120, env=env,
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
