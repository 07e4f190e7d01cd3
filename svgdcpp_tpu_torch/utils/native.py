"""ctypes bindings for the native host helpers (``native/svgd_host.cpp``).

Port of ``svgdcpp_tpu.utils.native``: exact selection on the host (the
k-th element and the reference's median), the debug dump's text writer,
and an independent C++ SVGD oracle (MVN + isotropic RBF + AdaGrad, one
pair at a time in float64). They run on the host, off the card's path.

The library is built at first use from ``native/svgd_host.cpp`` as it
stands, with ``g++`` and ``native/Makefile``'s flags, into
``svgdcpp_tpu_torch/_build/`` (keyed by a hash of the source and the flags,
under ``utils/cuda_build``'s file lock). Nothing is ever written into
``native/``, whose ``libsvgd_host.so`` belongs to the JAX package's build.
Without a toolchain, or when the build fails, ``native_available()`` is
False, the selection helpers answer with NumPy, the writer returns False
(the caller writes the text in Python) and the oracle returns None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .cuda_build import BUILD_DIR, PACKAGE_DIR, build_lock

#: The C++ source, shared with the JAX package.
SOURCE = PACKAGE_DIR.parent / "native" / "svgd_host.cpp"

#: native/Makefile's flags for a shared library with a plain C ABI.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> Path:
    """Where the library built from SOURCE with CXX_FLAGS lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsvgd_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile SOURCE into ``_build/`` unless it is there; raises
    RuntimeError without g++ or when g++ fails."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("cannot build the native helpers: no g++ on PATH")
    with build_lock("svgd_host"):
        if lib_path.exists():  # built by another process meanwhile
            return lib_path
        tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.so.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build failed: {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    return lib_path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is None and not _load_failed:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (OSError, RuntimeError, subprocess.SubprocessError):
                _load_failed = True
        return _lib


_F64P = ctypes.POINTER(ctypes.c_double)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.svgd_kth_element_f64.restype = ctypes.c_double
    lib.svgd_kth_element_f64.argtypes = [_F64P, ctypes.c_int64,
                                         ctypes.c_int64]
    lib.svgd_median_f64.restype = ctypes.c_double
    lib.svgd_median_f64.argtypes = [_F64P, ctypes.c_int64]
    lib.svgd_write_intermediate_log_v2.restype = ctypes.c_int
    lib.svgd_write_intermediate_log_v2.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ] + [_F64P] * 4
    lib.svgd_oracle_mvn_rbf_adagrad.restype = ctypes.c_int
    lib.svgd_oracle_mvn_rbf_adagrad.argtypes = [
        _F64P, ctypes.c_int64, ctypes.c_int64, _F64P, _F64P,
        ctypes.c_double, ctypes.c_double, ctypes.c_int64,
    ]
    return lib


def native_available() -> bool:
    return _load() is not None


def _as_f64_buffer(arr) -> np.ndarray:
    """A C-contiguous float64 host array of an array or a tensor (on any
    device)."""
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(arr, dtype=np.float64))


def _ptr(buf: np.ndarray):
    return buf.ctypes.data_as(_F64P)


def kth_element(values, k: int) -> float:
    """k-th smallest (0-indexed) via std::nth_element; NumPy without the
    library."""
    buf = _as_f64_buffer(values).ravel().copy()
    if not 0 <= int(k) < buf.size:
        raise IndexError(f"k={k} out of range for {buf.size} values")
    lib = _load()
    if lib is None:
        return float(np.partition(buf, k)[k])
    return float(lib.svgd_kth_element_f64(_ptr(buf), buf.size, int(k)))


def host_median(values) -> float:
    """The reference's median (even counts average the two middle values)
    on the host."""
    buf = _as_f64_buffer(values).ravel().copy()
    if buf.size == 0:
        raise ValueError("median of empty array")
    lib = _load()
    if lib is None:
        n = buf.size
        s = np.sort(buf)
        if n % 2 == 0:
            return float(0.5 * (s[n // 2 - 1] + s[n // 2]))
        return float(s[n // 2])
    return float(lib.svgd_median_f64(_ptr(buf), buf.size))


def write_intermediate_log_native(path: str, lmg_ref, ker_ref, kgrad_ref,
                                  coords_ref, *, start_step: int = 1,
                                  append: bool = False) -> bool:
    """Write the debug log with the native writer.

    The inputs are in the REFERENCE orientation: lmg and coords (T, m, n),
    ker (T, n, n), kgrad (T, m*n, n). ``start_step``/``append`` extend an
    existing dump with the new steps. Returns False without the library
    (the caller writes the text in Python); raises RuntimeError, its
    ``rc`` the writer's code, when the writer fails.
    """
    lib = _load()
    if lib is None:
        return False
    lmg = _as_f64_buffer(lmg_ref)
    ker = _as_f64_buffer(ker_ref)
    kgrad = _as_f64_buffer(kgrad_ref)
    coords = _as_f64_buffer(coords_ref)
    steps, m, n = lmg.shape
    rc = lib.svgd_write_intermediate_log_v2(
        str(path).encode(), steps, n, m, int(start_step), 1 if append else 0,
        _ptr(lmg), _ptr(ker), _ptr(kgrad), _ptr(coords),
    )
    if rc != 0:
        # native/svgd_host.cpp's codes: 1 fopen failed, 2 fwrite failed
        # mid-dump (a truncated file is left), 3 fclose failed.
        reason = {
            1: f"cannot open {path} for writing",
            2: f"write failed mid-dump (disk full?); partial file left at {path}",
            3: f"close failed for {path} (buffered data may be lost)",
        }.get(rc, f"failed with code {rc} for {path}")
        err = RuntimeError(f"native log writer: {reason}")
        err.rc = rc
        raise err
    return True


def cpp_oracle_mvn_rbf_adagrad(coords, mean, cov_inv, *, gamma=None,
                               lr=0.1, iters=1):
    """Run the independent C++ SVGD oracle: MVN scores, the isotropic RBF
    (``gamma`` None: the median bandwidth log(n)/med^2 of every step, the
    exact median), AdaGrad, one pair at a time in float64 on the host.
    Returns the (n, m) float64 coordinates after ``iters`` steps as a
    NumPy array; None without the library."""
    lib = _load()
    if lib is None:
        return None
    x = _as_f64_buffer(coords).copy()
    mean_b = _as_f64_buffer(mean)
    cov_b = _as_f64_buffer(cov_inv)
    rc = lib.svgd_oracle_mvn_rbf_adagrad(
        _ptr(x), x.shape[0], x.shape[1], _ptr(mean_b), _ptr(cov_b),
        -1.0 if gamma is None else float(gamma), float(lr), int(iters),
    )
    if rc != 0:
        raise RuntimeError(f"C++ oracle failed with code {rc}")
    return x
