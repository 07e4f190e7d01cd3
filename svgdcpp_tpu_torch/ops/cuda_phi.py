"""Fused phi + median-count sweeps on the card: wrappers of the CUDA kernels.

Four hand-written Hopper kernels, built into one library, replace the
Pallas kernels of the main path and of the composed-kernel path in
``svgdcpp_tpu/ops/pallas_phi.py``:

  * ``fused_phi_counts_square`` (``csrc/fused_phi.cu``) -- ``_fused_kernel``
    (K1), the square/cross sweep (each target row against every source).
  * ``fused_phi_counts_sym``    (``csrc/fused_phi.cu``) -- ``_sym_kernel``
    (K2), the upper-triangle sweep over one particle set (each unordered
    pair once, both directions).
  * ``fused_phi_terms_square``  (``csrc/fused_phi_terms.cu``) --
    ``_fused_terms_direct_kernel`` and ``_fused_terms_kernel`` (K6, K7):
    the square/cross sweep of a signed sum of isotropic RBF terms.
  * ``fused_phi_terms_sym``     (``csrc/fused_phi_terms.cu``) --
    ``_sym_terms_direct_kernel`` and ``_sym_terms_kernel`` (K8, K9): its
    upper-triangle sweep.

Each returns phi and the int64 counts of pair squared distances at or below
each threshold, like ``ops/phi.phi_rbf_terms_cross_fused_counts``, their
plain version. Every dimension 1 <= m <= MAX_M runs; above it the wrappers
raise.

Where the wrappers run: a tensor on the CPU goes to the plain version (the
CPU tests use this); a tensor on a CUDA device launches the kernel or
raises. There is no fallback from the card to the plain version.

Each wrapper counts its kernel's launches in ``launch_counts`` (one plain
integer per kernel), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..kernels.algebra import MAX_RBF_TERMS
from ..utils.cuda_build import CSRC_DIR, build_library, library_path
from .phi import (
    phi_rbf_cross_fused_counts,
    phi_rbf_fused_counts,
    phi_rbf_terms_cross_fused_counts,
    phi_rbf_terms_fused_counts,
)

#: Use the triangle kernels from this many particles up (``sym=None``). The
#: number is the JAX package's crossover for its TPU kernels, taken as a
#: starting point; the crossover on the card is still to be measured.
SYM_MIN_N = 2048

#: Largest dimension, threshold count and term count the kernels take.
MAX_M = 64
MAX_T = 8
MAX_TERMS = MAX_RBF_TERMS

SQUARE_KERNEL = "fused_phi_counts_square"
SYM_KERNEL = "fused_phi_counts_sym"
TERMS_SQUARE_KERNEL = "fused_phi_terms_square"
TERMS_SYM_KERNEL = "fused_phi_terms_sym"

#: Launches of each kernel since the last reset_launch_counts().
launch_counts = {
    SQUARE_KERNEL: 0, SYM_KERNEL: 0, TERMS_SQUARE_KERNEL: 0,
    TERMS_SYM_KERNEL: 0,
}

LIBRARY = "svgd_fused_phi"
SOURCES = (CSRC_DIR / "fused_phi.cu", CSRC_DIR / "fused_phi_terms.cu")

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def library_loaded() -> bool:
    """Whether the kernels' library has been built and loaded."""
    return _lib is not None


def build_log_path():
    """The nvcc/ptxas log kept beside the library (once it is built)."""
    path = library_path(LIBRARY, SOURCES)
    return path.with_name(path.name + ".log")


def load_library() -> ctypes.CDLL:
    """Build (first use only) and load the kernels' library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(LIBRARY, SOURCES)))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            signatures = {
                "svgd_fused_phi_counts_square":
                    [ptr] * 5 + [i32] * 4 + [ptr] * 3,
                "svgd_fused_phi_counts_sym": [ptr] * 4 + [i32] * 3 + [ptr] * 3,
                "svgd_fused_phi_terms_square":
                    [ptr] * 5 + [i32, ptr] + [i32] * 4 + [ptr] * 3,
                "svgd_fused_phi_terms_sym":
                    [ptr] * 4 + [i32, ptr] + [i32] * 3 + [ptr] * 3,
            }
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = i32
            _lib = lib
    return _lib


def resolve_sym(sym, n: int) -> bool:
    """Resolve a ``sym`` request: None picks the triangle kernel from
    SYM_MIN_N particles up; True/False force it on/off."""
    if sym is None:
        return n >= SYM_MIN_N
    return bool(sym)


def _check_launch(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{kernel} launch failed: CUDA error {rc} "
            f"({torch.cuda.get_device_name()})"
        )


def check_dimension(m: int) -> None:
    """Raise for a dimension the kernels do not take."""
    if not 1 <= m <= MAX_M:
        raise ValueError(
            f"the CUDA sweeps take 1 <= m <= {MAX_M} dimensions, got m={m} "
            "(ROADMAP.md item 17: wider sweeps)"
        )


def _device_operands(coords, scores, gammas, thresholds_sq):
    """Validate the CUDA path's inputs and return float32 device operands
    (gammas (nterms,), thresholds (T,)) without any host read."""
    if coords.ndim != 2 or scores.shape != coords.shape:
        raise ValueError(
            f"coords and scores must both be (n, m); got {tuple(coords.shape)}"
            f" and {tuple(scores.shape)}"
        )
    check_dimension(coords.shape[1])
    t = thresholds_sq.shape[0]
    if not 1 <= t <= MAX_T:
        raise ValueError(
            f"the CUDA sweeps take 1 <= T <= {MAX_T} thresholds, got T={t}"
        )
    if not 1 <= len(gammas) <= MAX_TERMS:
        raise ValueError(
            f"the CUDA sweeps take 1 to {MAX_TERMS} terms, got {len(gammas)}"
        )
    device = coords.device
    if scores.device != device or thresholds_sq.device != device:
        raise ValueError("coords, scores and thresholds must share one device")
    g = torch.stack([
        torch.as_tensor(gm, dtype=torch.float32, device=device).reshape(())
        for gm in gammas
    ])
    thr = thresholds_sq.to(torch.float32).contiguous()
    return g, thr


def _require_cuda(tensor) -> None:
    if tensor.device.type != "cuda":
        raise ValueError(
            f"the CUDA sweeps take tensors on the CPU (plain version) or on a "
            f"CUDA device; got {tensor.device}"
        )


def _host_signs(signs, nterms):
    if len(signs) != nterms:
        raise ValueError(f"{len(signs)} signs for {nterms} gammas")
    return (ctypes.c_float * nterms)(*(float(s) for s in signs))


def _square_launch(targets, sources, scores, gammas, signs, thresholds_sq):
    """K1 (one positive term, ``signs`` None) or the terms square kernel."""
    g, thr = _device_operands(sources, scores, gammas, thresholds_sq)
    if targets.ndim != 2 or targets.shape[1] != sources.shape[1]:
        raise ValueError("targets must be (n_t, m) with the sources' m")
    if targets.device != sources.device:
        raise ValueError("targets and sources must share one device")
    n_t, m = targets.shape
    n_s = sources.shape[0]
    # phi is translation-invariant: center on the source mean (float32
    # cancellation guard), as the plain version and the JAX wrapper do.
    src32 = sources.to(torch.float32)
    center = src32.mean(dim=0)
    tgt_c = (targets.to(torch.float32) - center).contiguous()
    src_c = (src32 - center).contiguous()
    sc32 = scores.to(torch.float32).contiguous()
    phi = torch.empty((n_t, m), dtype=torch.float32, device=targets.device)
    counts = torch.zeros(thr.shape[0], dtype=torch.int64, device=targets.device)
    lib = load_library()
    with torch.cuda.device(targets.device):
        stream = torch.cuda.current_stream().cuda_stream
        if signs is None:
            name = SQUARE_KERNEL
            rc = lib.svgd_fused_phi_counts_square(
                tgt_c.data_ptr(), src_c.data_ptr(), sc32.data_ptr(),
                g.data_ptr(), thr.data_ptr(), n_t, n_s, m, thr.shape[0],
                phi.data_ptr(), counts.data_ptr(), stream,
            )
        else:
            name = TERMS_SQUARE_KERNEL
            rc = lib.svgd_fused_phi_terms_square(
                tgt_c.data_ptr(), src_c.data_ptr(), sc32.data_ptr(),
                g.data_ptr(), _host_signs(signs, g.shape[0]), g.shape[0],
                thr.data_ptr(), n_t, n_s, m, thr.shape[0], phi.data_ptr(),
                counts.data_ptr(), stream,
            )
    _check_launch(rc, name)
    launch_counts[name] += 1
    return phi.to(targets.dtype), counts


def _sym_launch(coords, scores, gammas, signs, thresholds_sq):
    """K2 (one positive term, ``signs`` None) or the terms triangle kernel."""
    g, thr = _device_operands(coords, scores, gammas, thresholds_sq)
    n, m = coords.shape
    c32 = coords.to(torch.float32)
    coords_c = (c32 - c32.mean(dim=0)).contiguous()
    sc32 = scores.to(torch.float32).contiguous()
    acc = torch.zeros((2 * m, n), dtype=torch.float32, device=coords.device)
    upper = torch.zeros(thr.shape[0], dtype=torch.int64, device=coords.device)
    lib = load_library()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        if signs is None:
            name = SYM_KERNEL
            rc = lib.svgd_fused_phi_counts_sym(
                coords_c.data_ptr(), sc32.data_ptr(), g.data_ptr(),
                thr.data_ptr(), n, m, thr.shape[0], acc.data_ptr(),
                upper.data_ptr(), stream,
            )
        else:
            name = TERMS_SYM_KERNEL
            rc = lib.svgd_fused_phi_terms_sym(
                coords_c.data_ptr(), sc32.data_ptr(), g.data_ptr(),
                _host_signs(signs, g.shape[0]), g.shape[0], thr.data_ptr(),
                n, m, thr.shape[0], acc.data_ptr(), upper.data_ptr(), stream,
            )
    _check_launch(rc, name)
    launch_counts[name] += 1
    # Epilogue (the JAX one, pallas_phi.py:701-708 and :2514-2528, on the
    # columns kept): acc = [KS | D] with D = sum_j w (x_i - x_j), w = gamma k
    # for one term. The self pairs (k_t = 1) entered KS in both directions,
    # so subtract sum_t s_t * s_i once; their D term is 0. The kernel counted
    # the upper triangle with its diagonal, so counts = 2U - n.
    a = acc.T
    if signs is None:
        phi = (a[:, :m] - sc32 + 2.0 * g[0] * a[:, m:]) / n
    else:
        phi = (a[:, :m] - sum(float(s) for s in signs) * sc32
               + 2.0 * a[:, m:]) / n
    return phi.to(coords.dtype), 2 * upper - n


def phi_rbf_fused_cuda(coords, scores, gamma, thresholds_sq, sym=None):
    """Fused sweep over one particle set: (phi (n, m), counts (T,) int64).

    Counterpart of ``svgdcpp_tpu.ops.pallas_phi.phi_rbf_fused_pallas``. On
    a CUDA tensor: the triangle kernel when ``resolve_sym(sym, n)``, else
    the square kernel, in float32 (phi is returned in the coords' dtype).
    On a CPU tensor: the plain version ``phi_rbf_fused_counts`` (its
    square sweep gives the same phi and counts as either kernel).
    """
    if coords.device.type == "cpu":
        return phi_rbf_fused_counts(coords, scores, gamma, thresholds_sq)
    _require_cuda(coords)
    if resolve_sym(sym, coords.shape[0]):
        return _sym_launch(coords, scores, [gamma], None, thresholds_sq)
    return _square_launch(coords, coords, scores, [gamma], None, thresholds_sq)


def phi_rbf_fused_cuda_cross(targets, sources, source_scores, gamma,
                             thresholds_sq):
    """Cross form: ``targets`` against ``sources``, phi normalized by the
    source count; counts cover all n_t x n_s pairs. Counterpart of
    ``svgdcpp_tpu.ops.pallas_phi.phi_rbf_fused_pallas_cross``; CPU tensors
    go to the plain ``phi_rbf_cross_fused_counts``."""
    if targets.device.type == "cpu":
        return phi_rbf_cross_fused_counts(
            targets, sources, source_scores, gamma, thresholds_sq
        )
    _require_cuda(targets)
    return _square_launch(
        targets, sources, source_scores, [gamma], None, thresholds_sq
    )


def phi_rbf_terms_fused_cuda(coords, scores, gammas, signs, thresholds_sq,
                             sym=None):
    """Composed-kernel fused sweep over one particle set: phi of
    ``sum_t signs[t] exp(-gammas[t] sq)`` and the counts.

    Counterpart of ``svgdcpp_tpu.ops.pallas_phi.phi_rbf_terms_fused_pallas``.
    ``gammas`` are scalars (device tensors on the card, never read on the
    host), ``signs`` Python numbers of either sign, 1 to MAX_TERMS of each.
    On a CUDA tensor: the terms triangle kernel when
    ``resolve_sym(sym, n)``, else the terms square kernel, in float32. On a
    CPU tensor: the plain ``phi_rbf_terms_fused_counts``.
    """
    if coords.device.type == "cpu":
        return phi_rbf_terms_fused_counts(
            coords, scores, gammas, signs, thresholds_sq
        )
    _require_cuda(coords)
    if resolve_sym(sym, coords.shape[0]):
        return _sym_launch(coords, scores, gammas, signs, thresholds_sq)
    return _square_launch(coords, coords, scores, gammas, signs, thresholds_sq)


def phi_rbf_terms_fused_cuda_cross(targets, sources, source_scores, gammas,
                                   signs, thresholds_sq):
    """Cross form of the composed-kernel sweep (phi normalized by the
    source count, counts over all n_t x n_s pairs). Counterpart of
    ``svgdcpp_tpu.ops.pallas_phi.phi_rbf_terms_fused_pallas_cross``; CPU
    tensors go to the plain ``phi_rbf_terms_cross_fused_counts``."""
    if targets.device.type == "cpu":
        return phi_rbf_terms_cross_fused_counts(
            targets, sources, source_scores, gammas, signs, thresholds_sq
        )
    _require_cuda(targets)
    return _square_launch(
        targets, sources, source_scores, gammas, signs, thresholds_sq
    )
