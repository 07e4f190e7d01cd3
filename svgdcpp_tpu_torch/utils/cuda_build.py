"""Build the package's CUDA sources into shared libraries at first use.

``nvcc`` compiles the ``csrc/*.cu`` files for Hopper (``sm_90a``) into a
shared library with a plain C interface, which the caller loads with
``ctypes``. Nothing is built when a module is imported: the first launch of
a kernel builds its library. Each source compiles in its own nvcc process,
all started together, and one more nvcc links the objects.

The library goes to ``svgdcpp_tpu_torch/_build/`` (listed in .gitignore),
its file name keyed by a hash of the sources, the shared headers
(``csrc/*.cuh``) and the flags, so a library built from other sources is
never loaded. A file lock serialises concurrent builds of the same library.
There is no fallback: a missing ``nvcc`` or a failed build raises with the
command that was run.
"""

from __future__ import annotations

import contextlib
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

#: Hopper's sm_90a target (which also admits wgmma and setmaxnreg).
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

#: nvcc flags of each source's compile: position-independent code for a
#: plain C ABI loadable by ctypes, and ptxas's per-kernel register,
#: shared-memory and spill report in the build log.
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-c",
)

#: nvcc flags of the link into one shared library.
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

BUILD_TIMEOUT_S = 600


def find_nvcc() -> str | None:
    """nvcc under $CUDA_HOME (default /usr/local/cuda), else on PATH."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    nvcc = Path(cuda_home or "/usr/local/cuda") / "bin" / "nvcc"
    if nvcc.is_file() and os.access(nvcc, os.X_OK):
        return str(nvcc)
    return shutil.which("nvcc")


def _inputs(sources: Sequence[Path]) -> list[Path]:
    """The files a build reads: its sources and every shared header."""
    return [*sources, *sorted(CSRC_DIR.glob("*.cuh"))]


def library_path(name: str, sources: Sequence[Path]) -> Path:
    """Where the library built from ``sources`` lives (hash-keyed)."""
    h = hashlib.sha256()
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _inputs(sources):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def build_lock(name: str):
    """Hold ``_build/lib<name>.lock`` exclusively, so that one process at
    a time builds the library ``name``; the others wait, then find it
    built. The CUDA kernels' build and the native helpers' build
    (``utils/native.py``) take it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"lib{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def build_library(name: str, sources: Sequence[Path]) -> Path:
    """Compile ``sources`` into ``lib<name>_<hash>.so`` unless it exists.

    The build log (nvcc's and ptxas's output for every source) is kept
    beside the library as ``<library>.log``. Raises RuntimeError when nvcc
    is missing or fails.
    """
    sources = [Path(s) for s in sources]
    lib_path = library_path(name, sources)
    if lib_path.exists():
        return lib_path
    with build_lock(name):
        if lib_path.exists():  # built by another process meanwhile
            return lib_path
        stem = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}")
        nvcc = find_nvcc()
        objects = [Path(f"{stem}.{i}.o") for i in range(len(sources))]
        compiles = [
            [nvcc or "nvcc", *COMPILE_FLAGS, "-o", str(obj), str(src)]
            for src, obj in zip(sources, objects)
        ]
        tmp = Path(f"{stem}.so.tmp")
        link = [nvcc or "nvcc", *LINK_FLAGS, "-o", str(tmp), *map(str, objects)]
        if nvcc is None:
            raise RuntimeError(
                "cannot build the CUDA kernels: nvcc was not found under "
                "$CUDA_HOME/bin or on PATH; the build commands are: "
                + "; ".join(shlex.join(c) for c in [*compiles, link])
            )
        log = []
        try:
            procs = [
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )
                for cmd in compiles
            ]
            failed = []
            for cmd, proc in zip(compiles, procs):
                try:
                    out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    out, _ = proc.communicate()
                    out += f"\ntimed out after {BUILD_TIMEOUT_S} s"
                log.append(f"$ {shlex.join(cmd)}\n{out}")
                if proc.returncode != 0:
                    failed.append(cmd)
            if not failed:
                proc = subprocess.run(
                    link, capture_output=True, text=True,
                    timeout=BUILD_TIMEOUT_S,
                )
                log.append(f"$ {shlex.join(link)}\n{proc.stdout}{proc.stderr}")
                if proc.returncode != 0:
                    failed.append(link)
            if failed:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"kernel build failed: {shlex.join(failed[0])}\n"
                    + "\n".join(log)
                )
            lib_path.with_name(lib_path.name + ".log").write_text("\n".join(log))
            os.replace(tmp, lib_path)
        finally:
            for obj in objects:
                obj.unlink(missing_ok=True)
    return lib_path
