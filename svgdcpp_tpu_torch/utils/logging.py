"""Intermediate-matrix debug logging.

Port of ``svgdcpp_tpu.utils.logging`` (the reference's per-iteration
matrix snapshots, SVGD.hpp:346-366, 460-476): with
``log_intermediate_matrices`` the drivers stack LogModelGrad / Kernel /
KernelGrad / CoordMat per iteration, and this module writes them to a text
file in the reference's layout after the run, through the native writer
(``utils/native.py``) where it builds and in Python otherwise. The text is
the JAX package's writer's, byte for byte.
"""

from __future__ import annotations

import numpy as np

from ..core.exceptions import SVGD_LOG_PREFIX
from .native import write_intermediate_log_native


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _format_matrix(mat: np.ndarray) -> str:
    return "\n".join(" ".join(f"{v:.9g}" for v in row)
                     for row in np.atleast_2d(mat))


def write_intermediate_matrices(path: str, logs: dict, *,
                                start_step: int = 1, append: bool = False):
    """Write stacked per-iteration matrices in the reference's text format.

    ``logs`` holds arrays or tensors stacked over iterations in (n, m)
    layout: log_model_grad (T, n, m), kernel (T, n, n) with
    K[i, j] = k(x_j, x_i), kernel_grad (T, n, n, m) with
    G[i, j] = grad_{x_j} k(x_j, x_i), coords (T, n, m). They are written
    in the reference's orientations: LogModelGrad and CoordMat m x n,
    Kernel n x n indexed (j, i), KernelGrad the (m n) x n stacked blocks
    (SVGD.hpp:498-504). ``start_step``/``append`` extend an existing dump
    with the new iterations only.
    """
    lmg = _host(logs["log_model_grad"])
    ker = _host(logs["kernel"])
    kgrad = _host(logs["kernel_grad"])
    coords = _host(logs["coords"])
    num_steps = lmg.shape[0]
    n, m = lmg.shape[1], lmg.shape[2]

    # The native writer (utils/native.py) writes the same text faster.
    try:
        wrote = write_intermediate_log_native(
            path,
            lmg.transpose(0, 2, 1),
            ker.transpose(0, 2, 1),
            kgrad.transpose(0, 2, 3, 1).reshape(num_steps, n * m, n),
            coords.transpose(0, 2, 1),
            start_step=start_step,
            append=append,
        )
    except RuntimeError as e:
        # The native writer's failure modes; an open failure (rc 1) keeps
        # the reference's exact message (SVGD.hpp:466).
        if getattr(e, "rc", 1) == 1:
            raise RuntimeError(
                SVGD_LOG_PREFIX
                + f"[Runtime Error] Cannot open {path} for writing."
            ) from e
        raise RuntimeError(SVGD_LOG_PREFIX + f"[Runtime Error] {e}") from e
    if wrote:
        return
    write_intermediate_matrices_python(path, lmg, ker, kgrad, coords,
                                       start_step=start_step, append=append)


def write_intermediate_matrices_python(path, lmg, ker, kgrad, coords, *,
                                       start_step: int = 1,
                                       append: bool = False):
    """The Python writer of :func:`write_intermediate_matrices`'s text,
    for host arrays in the (n, m) layout; the native writer's fallback."""
    num_steps = lmg.shape[0]
    n, m = lmg.shape[1], lmg.shape[2]
    try:
        out = open(path, "a" if append else "w")
    except OSError as e:
        raise RuntimeError(
            SVGD_LOG_PREFIX + f"[Runtime Error] Cannot open {path} for writing."
        ) from e
    with out:
        for t in range(num_steps):
            # reference kernel_matrix_(j, i) = kernel[i, j]; reference
            # kernel_grad block (j*m:(j+1)*m, i) = kernel_grad[i, j, :]
            kg_ref = kgrad[t].transpose(1, 2, 0).reshape(n * m, n)
            out.write(
                f"========== Step {start_step + t} =========="
                f"\nLogModelGrad=\n{_format_matrix(lmg[t].T)}"
                f"\n\nKernel=\n{_format_matrix(ker[t].T)}"
                f"\n\nKernelGrad=\n{_format_matrix(kg_ref)}"
                f"\n\nCoordMat=\n{_format_matrix(coords[t].T)}"
                "\n\n"
            )
