"""Build the package's CUDA sources into shared libraries at first use.

``nvcc`` compiles the ``csrc/*.cu`` files for Hopper (``sm_90a``) into a
shared library with a plain C interface, which the caller loads with
``ctypes``. Nothing is built when a module is imported: the first launch of
a kernel builds its library.

The library goes to ``svgdcpp_tpu_torch/_build/`` (listed in .gitignore),
its file name keyed by a hash of the sources and the flags, so a library
built from other sources is never loaded. A file lock serialises
concurrent builds of the same library. There is no fallback: a missing
``nvcc`` or a failed build raises with the command that was run.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shlex
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: nvcc flags for every library: Hopper's sm_90a target (which also admits
#: wgmma and setmaxnreg), a plain C ABI loadable by ctypes, and ptxas's
#: per-kernel register and shared-memory report in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

BUILD_TIMEOUT_S = 600


def find_nvcc() -> str | None:
    """nvcc under $CUDA_HOME (default /usr/local/cuda), else on PATH."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    nvcc = Path(cuda_home or "/usr/local/cuda") / "bin" / "nvcc"
    if nvcc.is_file() and os.access(nvcc, os.X_OK):
        return str(nvcc)
    return shutil.which("nvcc")


def library_path(name: str, sources: Sequence[Path]) -> Path:
    """Where the library built from ``sources`` lives (hash-keyed)."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_library(name: str, sources: Sequence[Path]) -> Path:
    """Compile ``sources`` into ``lib<name>_<hash>.so`` unless it exists.

    The build log (nvcc's and ptxas's output) is kept beside the library
    as ``<library>.log``. Raises RuntimeError when nvcc is missing or
    fails.
    """
    sources = [Path(s) for s in sources]
    lib_path = library_path(name, sources)
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"lib{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():  # built by another process meanwhile
            return lib_path
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        nvcc = find_nvcc()
        cmd = [nvcc or "nvcc", *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        if nvcc is None:
            raise RuntimeError(
                "cannot build the CUDA kernels: nvcc was not found under "
                "$CUDA_HOME/bin or on PATH; the build command is: "
                + shlex.join(cmd)
            )
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S
        )
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"kernel build failed (exit {proc.returncode}): "
                f"{shlex.join(cmd)}\n{log}"
            )
        lib_path.with_name(lib_path.name + ".log").write_text(log)
        os.replace(tmp, lib_path)
    return lib_path
