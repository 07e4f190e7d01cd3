"""Fused phi sweeps and count passes on the card: wrappers of the CUDA
kernels.

Twelve hand-written Hopper kernels, built into one library (with a
thirteenth, ``sym_eigen``, beside K15's), replace the Pallas kernels of the
package's paths in ``svgdcpp_tpu/ops/pallas_phi.py``:

  * ``fused_phi_counts_square`` (``csrc/fused_phi.cu``) -- ``_fused_kernel``
    (K1), the square/cross sweep (each target row against every source):
    the sources split over the grid and summed in order by a finishing
    pass, one row a thread on the CUDA cores up to m = 4, the Gram tile and
    the contraction on the tensor cores in 3xTF32 above
    (``csrc/square_mma.cuh``), past m = 64 a block's target rows resident,
    the sources through a ``cp.async`` ring and every accumulator column in
    registers over its source range (``csrc/square_wide_sm90.cuh``).
  * ``fused_phi_counts_sym``    (``csrc/fused_phi.cu``) -- ``_sym_kernel``
    (K2), the upper-triangle sweep over one particle set (each unordered
    pair once, both directions; on ``csrc/micro_tile.cuh``'s body at
    m = 1-8 and 11, ``csrc/counts_sym.cuh``'s up to 64 and
    ``csrc/wide_tri.cuh``'s tensor-core body past it).
  * ``fused_phi_terms_square``  (``csrc/fused_phi_terms.cu``) --
    ``_fused_terms_direct_kernel`` and ``_fused_terms_kernel`` (K6, K7):
    the square/cross sweep of a signed sum of isotropic RBF terms, on K1's
    design and bodies (``csrc/square_mma.cuh``) with two weights a pair,
    k_c and w (two operand bands on the tensor cores).
  * ``fused_phi_terms_sym``     (``csrc/fused_phi_terms.cu``) --
    ``_sym_terms_direct_kernel`` and ``_sym_terms_kernel`` (K8, K9): its
    upper-triangle sweep (the micro-tile body, ``csrc/terms_sym.cuh``'s up
    to 64, ``csrc/wide_tri.cuh``'s past it).
  * ``fused_phi_aniso_terms_sym`` (``csrc/fused_phi_aniso.cu``) --
    ``_sym_aniso_terms_kernel`` (K14): the sweep of a composed kernel with
    anisotropic (full-P) terms. With one anisotropic term up to m = 32 a
    one-pass kernel (every ordered pair once, both term groups in one pass,
    n phi and all n^2 counts out); otherwise the terms triangle kernel's
    body under its own name, with one term group per anisotropic term;
    past m = 64 the same groups on ``csrc/wide_tri_sm90.cuh``'s tensor-core
    body (``fused_phi_aniso_terms_wide``: a single-term group, each
    anisotropic one and group 0 of one isotropic term, on one weight tile;
    group 0 of more on two; with none, the counts from K16's self form).
  * ``phi_rbf_square``          (``csrc/phi_rbf.cu``) -- ``_phi_kernel``
    (K15): the sweep of one RBF with a full, fixed P, no counts (the
    triangle at m = 1-8 and 11, the square sweep up to 64); with it
    ``sym_eigen``, the Jacobi decomposition of P on the card. Past m = 64
    ``phi_rbf_wide``: the JAX kernel's own form, the Gram tile of X
    against Y = X (P_sym/2) on ``csrc/wide_tri.cuh``'s body, with P itself
    and no decomposition.
  * ``fused_phi_counts_sympanel`` (``csrc/fused_phi_panel.cu``) --
    ``_sym_panel_kernel`` (K3): the triangle sweep of one RBF laid out as
    pairs of super-blocks, each with its own output window, summed by an
    epilogue (``ops/phi.sympanel_epilogue``).
  * ``fused_phi_terms_sympanel`` (``csrc/fused_phi_panel.cu``) --
    ``_sym_panel_terms_direct_kernel`` and ``_sym_panel_terms_kernel``
    (K12, K13): the same for a signed sum of isotropic RBF terms.
  * ``fused_phi_counts_sym_chunk`` (``csrc/fused_phi.cu``),
    ``fused_phi_terms_sym_chunk`` (``csrc/fused_phi_terms.cu``) and
    ``fused_phi_counts_sympanel_chunk`` (``csrc/fused_phi_panel.cu``) --
    the same kernels as the sharded engine runs them (K4; K10 and K11; K5):
    one rank's range of the triangle's tile list or of the panel list,
    returning the raw accumulator and upper counts, which the engine sums
    over the ranks before one epilogue (``parallel/sharded.py``).
  * ``count_le_cross`` (``csrc/count_le.cu``) -- ``_count_kernel`` (K16):
    the median selection's count pass, under ``ops/median.count_le_cross``.

All but ``phi_rbf_square`` return phi and the int64 counts of pair squared
distances at or below each threshold, like
``ops/phi.phi_rbf_terms_cross_fused_counts``,
``phi_rbf_aniso_terms_fused_counts`` and the panel schedules
``phi_rbf_sympanel_fused_counts`` / ``phi_rbf_terms_sympanel_fused_counts``,
their plain versions; ``phi_rbf_square`` returns phi, like
``ops/phi.phi_rbf_blocked``. Every sweep and the count kernel take any
m >= 1: past MAX_M = 64 the sweeps run wide bodies that hold nothing sized
by m (``csrc/square_wide_sm90.cuh``'s for the float32 square sweeps,
``csrc/wide_tri_sm90.cuh``'s body for the float32 triangles and K14's
groups, ``csrc/wide_tri.cuh``'s for K15, and which the panels run on the
tile pairs of a panel). ``sym_eigen`` alone takes 1 <= m <= MAX_M:
its matrix and its order table live in one block's shared memory, and
past MAX_M K15 takes P itself, so nothing calls it there.

The bfloat16 operand opt-in (``dot_dtype='bfloat16'``, the JAX package's
``fused_dot_dtype``) runs instances of their own, at every m: K1's (square
and cross, ``fused_phi_counts_square_bf16``, on ``square_wide_body``) and
K15's (``phi_rbf_wide_bf16``, on ``wide_tri.cuh``'s body) in one TF32 pass
on bf16-rounded values; K2's (``fused_phi_counts_sym_bf16``) and K3's
(``fused_phi_counts_sympanel_bf16``) on ``csrc/bf16_tri_sm90.cuh``'s body,
bf16 ``mma.sync`` on operands its pack kernel rounds once into a
workspace, the accumulator [KS | KX | rowsum] finished by
``ops/phi.bf16_sym_finish``. They round the Gram operands, the pair
weights and the contraction's records to bf16 where the JAX kernels do;
the norms and the epilogue's coordinates stay float32. The plain versions
in ``ops/phi`` take the same ``dot_dtype`` and round at the same points.

Which form sweeps one particle set is ``resolve_sym``: by default the JAX
package's decision up to MAX_M and the card's own past it
(``ops/sym_plan.card_resolve_sym``), or the caller's.

Where the wrappers run: a tensor on the CPU goes to the plain version (the
CPU tests use this); a tensor on a CUDA device launches the kernel or
raises. There is no fallback from the card to the plain version.

The quadratic forms of K14 and K15 up to MAX_M come from factors
prepared in float64 (``cholesky_factors``, which the driver keeps while a
constant P stays the same; ``eigen_rows``), so each kernel takes the
difference form of its form. ``eigen_rows`` decomposes an (m, m) matrix
(``symmetric_eigen``: on the card the kernel ``sym_eigen``, which reads
nothing on the host) unless the caller passes the decomposition. Past
MAX_M, K14's groups take the same factors' rows z_t = x L_t by the Gram
identity (``aniso_group_operands``: L_t padded with zeros to the rows'
width), and K15 takes P itself (``ops/phi.gram_operands``), so nothing
is decomposed there.

Each wrapper counts its kernel's launches in ``launch_counts`` (one plain
integer per kernel), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..kernels.algebra import MAX_RBF_TERMS
from ..utils.cuda_build import CSRC_DIR, build_library, library_path
from .median import count_le_plain
from .phi import (
    aniso_groups_finish,
    bf16_sym_finish,
    dot_bf16,
    gram_operands,
    panel_index,
    phi_rbf_aniso_terms_fused_counts,
    phi_rbf_cross_fused_counts,
    phi_rbf_eigen,
    phi_rbf_fused_counts,
    phi_rbf_gram,
    phi_rbf_sym_chunk_counts,
    phi_rbf_sym_fused_counts,
    phi_rbf_sympanel_chunk_counts,
    phi_rbf_sympanel_fused_counts,
    phi_rbf_terms_cross_fused_counts,
    phi_rbf_terms_fused_counts,
    phi_rbf_terms_sym_chunk_counts,
    phi_rbf_terms_sympanel_fused_counts,
    sympanel_epilogue,
    sympanel_scatter,
)
from .sym_plan import (
    KERNEL_MAX_M,
    SYM_MIN_N,
    bf16_work_bytes,
    card_panel_plan,
    card_resolve_sym,
    panel_chunk,
    sym_tile_chunk,
    wide_row_width,
)

#: Largest dimension sym_eigen takes (every sweep takes any m), threshold
#: count and term count the kernels take, and the most
#: anisotropic terms (gradient accumulators) K14's kernel takes: the JAX
#: package's _ANISO_MAX_W.
MAX_M = KERNEL_MAX_M
MAX_T = 8
#: Thresholds one count-kernel launch takes; more go in several launches.
COUNT_MAX_T = 32
MAX_TERMS = MAX_RBF_TERMS
MAX_ANISO_TERMS = 8

#: One anisotropic term takes K14's one-pass kernel up to this m; past it
#: the term-group kernel, which ran 1.6-1.9x faster at m = 50 and 64, where
#: the one-pass kernel's rows spill (PERF.md section 6, PR 9).
ONE_PASS_MAX_M = 32

SQUARE_KERNEL = "fused_phi_counts_square"
SYM_KERNEL = "fused_phi_counts_sym"
TERMS_SQUARE_KERNEL = "fused_phi_terms_square"
TERMS_SYM_KERNEL = "fused_phi_terms_sym"
ANISO_KERNEL = "fused_phi_aniso_terms_sym"
#: K14's term groups past MAX_M (csrc/fused_phi_aniso.cu on
#: csrc/wide_tri_sm90.cuh's body: fused_phi_aniso_terms_wide_groups_kernel,
#: and fused_phi_aniso_terms_wide_iso_kernel for two or more isotropic
#: terms), one launch a call of the entry.
ANISO_WIDE_KERNEL = "fused_phi_aniso_terms_wide"
PHI_RBF_KERNEL = "phi_rbf_square"
#: K15 past MAX_M (csrc/phi_rbf.cu, P itself on the wide body).
PHI_RBF_WIDE_KERNEL = "phi_rbf_wide"
SYM_EIGEN_KERNEL = "sym_eigen"
SYMPANEL_KERNEL = "fused_phi_counts_sympanel"
TERMS_SYMPANEL_KERNEL = "fused_phi_terms_sympanel"
SYM_CHUNK_KERNEL = "fused_phi_counts_sym_chunk"
TERMS_SYM_CHUNK_KERNEL = "fused_phi_terms_sym_chunk"
SYMPANEL_CHUNK_KERNEL = "fused_phi_counts_sympanel_chunk"
COUNT_KERNEL = "count_le_cross"
#: The bfloat16 operand opt-in's instances (K1, K2, K3, K15).
SQUARE_BF16_KERNEL = "fused_phi_counts_square_bf16"
SYM_BF16_KERNEL = "fused_phi_counts_sym_bf16"
SYMPANEL_BF16_KERNEL = "fused_phi_counts_sympanel_bf16"
PHI_RBF_WIDE_BF16_KERNEL = "phi_rbf_wide_bf16"

#: Launches of each kernel since the last reset_launch_counts(). A panel
#: kernel's wide instance (m > MAX_M) counts under its family's key.
launch_counts = {
    SQUARE_KERNEL: 0, SYM_KERNEL: 0, TERMS_SQUARE_KERNEL: 0,
    TERMS_SYM_KERNEL: 0, ANISO_KERNEL: 0, ANISO_WIDE_KERNEL: 0,
    PHI_RBF_KERNEL: 0, PHI_RBF_WIDE_KERNEL: 0, SYM_EIGEN_KERNEL: 0,
    SYMPANEL_KERNEL: 0, TERMS_SYMPANEL_KERNEL: 0, SYM_CHUNK_KERNEL: 0,
    TERMS_SYM_CHUNK_KERNEL: 0, SYMPANEL_CHUNK_KERNEL: 0, COUNT_KERNEL: 0,
    SQUARE_BF16_KERNEL: 0, SYM_BF16_KERNEL: 0, SYMPANEL_BF16_KERNEL: 0,
    PHI_RBF_WIDE_BF16_KERNEL: 0,
}

LIBRARY = "svgd_fused_phi"
SOURCES = tuple(
    CSRC_DIR / name
    for name in ("fused_phi.cu", "fused_phi_terms.cu", "fused_phi_aniso.cu",
                 "phi_rbf.cu", "fused_phi_panel.cu", "count_le.cu")
)

#: The grid's y dimension holds one panel each.
MAX_PANELS = 65535

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
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            signatures = {
                "svgd_fused_phi_counts_square":
                    [ptr] * 5 + [i32] * 4 + [ptr] * 3 + [i32, ptr],
                "svgd_fused_phi_counts_square_bf16":
                    [ptr] * 5 + [i32] * 4 + [ptr] * 3 + [i32, ptr],
                "svgd_square_splits": [i32] * 3,
                "svgd_square_bf16_splits": [i32] * 3,
                "svgd_fused_phi_counts_sym": [ptr] * 4 + [i32] * 3 + [ptr] * 3,
                "svgd_fused_phi_counts_sym_bf16":
                    [ptr] * 4 + [i32] * 3 + [ptr] * 4,
                "svgd_fused_phi_terms_square":
                    [ptr] * 5 + [i32, ptr] + [i32] * 4 + [ptr] * 3
                    + [i32, ptr],
                "svgd_fused_phi_terms_sym":
                    [ptr] * 4 + [i32, ptr] + [i32] * 3 + [ptr] * 3,
                "svgd_fused_phi_aniso_terms_sym":
                    [ptr] * 5 + [i32, ctypes.c_float, ptr] + [i32] * 3
                    + [ptr] * 3,
                "svgd_fused_phi_aniso_terms_groups":
                    [ptr] * 5 + [i32, ptr, i32, ptr] + [i32] * 3 + [ptr] * 3,
                "svgd_phi_rbf_square": [ptr] * 3 + [i32] * 3 + [ptr] * 2,
                "svgd_phi_rbf_wide": [ptr] * 4 + [i32] * 3 + [ptr] * 2,
                "svgd_phi_rbf_wide_bf16": [ptr] * 4 + [i32] * 3 + [ptr] * 2,
                "svgd_sym_eigen": [ptr, i32, ptr, ptr, ptr],
                "svgd_fused_phi_counts_sympanel":
                    [ptr] * 4 + [i32] * 5 + [ptr] * 3,
                "svgd_fused_phi_counts_sympanel_bf16":
                    [ptr] * 4 + [i32] * 5 + [ptr] * 4,
                "svgd_fused_phi_terms_sympanel":
                    [ptr] * 4 + [i32, ptr] + [i32] * 5 + [ptr] * 3,
                "svgd_fused_phi_counts_sym_chunk":
                    [ptr] * 4 + [i32] * 3 + [i64] * 2 + [ptr] * 3,
                "svgd_fused_phi_terms_sym_chunk":
                    [ptr] * 4 + [i32, ptr] + [i32] * 3 + [i64] * 2
                    + [ptr] * 3,
                "svgd_fused_phi_counts_sympanel_chunk":
                    [ptr] * 4 + [i32] * 7 + [ptr] * 3,
                "svgd_count_le_cross": [ptr] * 4 + [i32] * 4 + [ptr] * 2,
                "svgd_count_le_self": [ptr] * 3 + [i32] * 3 + [ptr] * 2,
                "svgd_sym_tile": [i32] * 2,
            }
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = i32
            _lib = lib
    return _lib


def resolve_sym(sym, n: int, m: int, num_terms: int | None = None):
    """Which form sweeps n particles of dimension m: False (the square
    kernel), True (the full-width triangle kernel) or "panel" (the panel
    triangle kernel), for one RBF (``num_terms`` None) or a composed kernel
    of ``num_terms`` terms.

    ``None`` gives, up to MAX_M, the JAX package's decision
    (``_resolve_sym`` at its default tiles, ``sym_plan.jax_resolve_sym``):
    the square sweep below SYM_MIN_N, the full-width triangle while its
    accumulator fits the TPU's VMEM budget, the panel form past it where
    its eligibility rules admit the shape, else the square sweep. Those are
    TPU numbers, taken as the starting point as SYM_MIN_N is; the
    crossovers on the card are measured in PERF.md. Past MAX_M it gives the
    card's own rule (``sym_plan.card_resolve_sym``): the square sweep below
    SYM_MIN_N, from there the form measured faster on the card, never the
    panel (its wide instance does the triangle's work and more, and the
    TPU's VMEM budget, the JAX rule's reason for it, does not bind on the
    card). ``True`` forces the full-width
    kernel at any n, where the JAX package's True is advisory (it takes the
    panel or the square form past the budget): on the card the accumulator
    lives in device memory and no shape is too wide for it. ``False`` and
    ``"panel"`` force the square and the panel kernel."""
    if sym is None:
        return card_resolve_sym(n, m, num_terms)
    if sym is True or sym is False or sym == "panel":
        return sym
    raise ValueError(
        f"sym must be None, True, False or 'panel', got {sym!r}"
    )


def _check_launch(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{kernel} launch failed: CUDA error {rc} "
            f"({torch.cuda.get_device_name()})"
        )


def check_dimension(m: int, *, eigen: bool = False) -> None:
    """Raise for a dimension the kernels do not take: every sweep takes any
    m >= 1; the decomposition sym_eigen (``eigen``) 1 <= m <= MAX_M."""
    if m < 1:
        raise ValueError(f"the CUDA sweeps take m >= 1 dimensions, got m={m}")
    if eigen and m > MAX_M:
        raise ValueError(
            f"sym_eigen takes 1 <= m <= {MAX_M} dimensions, got m={m}: the "
            "one-block Jacobi kernel holds the matrix, the eigenvectors and "
            "its order table in one block's shared memory (the table alone "
            "would take 260 KB at m = 512); past it the fixed-P sweep takes "
            "P itself, with no decomposition"
        )


def _check_pair(coords, scores):
    if coords.ndim != 2 or scores.shape != coords.shape:
        raise ValueError(
            f"coords and scores must both be (n, m); got {tuple(coords.shape)}"
            f" and {tuple(scores.shape)}"
        )
    check_dimension(coords.shape[1])
    if scores.device != coords.device:
        raise ValueError("coords and scores must share one device")


def _device_operands(coords, scores, gammas, thresholds_sq, min_terms=1):
    """Validate the CUDA path's inputs and return float32 device operands
    (gammas (nterms,), or one zero for no term; thresholds (T,)) without
    any host read."""
    _check_pair(coords, scores)
    t = thresholds_sq.shape[0]
    if not 1 <= t <= MAX_T:
        raise ValueError(
            f"the CUDA sweeps take 1 <= T <= {MAX_T} thresholds, got T={t}"
        )
    if not min_terms <= len(gammas) <= MAX_TERMS:
        raise ValueError(
            f"the CUDA sweeps take {min_terms} to {MAX_TERMS} terms, got "
            f"{len(gammas)}"
        )
    device = coords.device
    if thresholds_sq.device != device:
        raise ValueError("coords, scores and thresholds must share one device")
    g = torch.stack([
        torch.as_tensor(gm, dtype=torch.float32, device=device).reshape(())
        for gm in gammas
    ]) if gammas else torch.zeros(1, dtype=torch.float32, device=device)
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


def _centered32(coords):
    """float32 coordinates centered on their mean (phi is
    translation-invariant; the float32 cancellation guard of every sweep)."""
    c32 = coords.to(torch.float32)
    return c32 - c32.mean(dim=0)


def _tri_operands(coords_c, sc32, m):
    """(coordinates, scores, width) as the float32 triangle kernels take
    them: past MAX_M padded with zero columns to ``wide_row_width(m)``, so
    that the wide body's 16-byte copies start every row on a 16-byte
    boundary, which the library requires there (zero columns add nothing
    to sq, KS or D; the accumulator has 2 x width rows, of which the
    wrappers keep [0, m) and [width, width + m)); a scores view off a
    16-byte boundary is copied. ``coords_c`` is a fresh tensor. m <= MAX_M
    takes them as they are."""
    if m <= MAX_M:
        return coords_c, sc32, m
    width = wide_row_width(m)
    if width != m:
        pad = (0, width - m)
        return (torch.nn.functional.pad(coords_c, pad),
                torch.nn.functional.pad(sc32, pad), width)
    if sc32.data_ptr() % 16:
        sc32 = sc32.clone()
    return coords_c, sc32, m


def cholesky_factors(p_matrices, device):
    """K14's factors: L (T, m, m) in float64 on ``device``, with
    P_sym/2 = L_t L_t^T (P_sym = P_t + P_t^T), so that with z_t = x L_t,
    ``|z_ti - z_tj|^2 = d^T P_t d`` for d = x_i - x_j.

    ``torch.linalg.cholesky_ex`` does not read on the host; it does not
    check either, so every P_t must be positive definite (the route's gate,
    kernels/algebra.fused_aniso_terms_supported, proves it)."""
    p = torch.stack([
        torch.as_tensor(pm, device=device).to(torch.float64)
        for pm in p_matrices
    ])
    lower, _ = torch.linalg.cholesky_ex(0.5 * (p + p.transpose(-1, -2)))
    return lower


def symmetric_eigen(p_matrix, device=None):
    """(lam (m,), V (m, m)) in float64 on ``device`` (P's own by default),
    with P_sym/2 = V diag(lam) V^T, in any order of the eigenvalues.

    On a CUDA device the one-block Jacobi kernel ``svgd_sym_eigen``
    (csrc/phi_rbf.cu), which reads nothing on the host: a HESSIAN scale's
    new P each step does not synchronise the step. It takes m <= MAX_M
    (its matrix and order table live in one block's shared memory); past
    it K15 takes P itself, so nothing on the card calls it there. On the
    CPU its plain version, ``torch.linalg.eigh`` (which checks its result
    on the host, so it never runs on the card here), at any m. P may be
    indefinite."""
    p = torch.as_tensor(p_matrix)
    device = p.device if device is None else torch.device(device)
    p = p.to(device, torch.float64).contiguous()
    if p.ndim != 2 or p.shape[0] != p.shape[1]:
        raise ValueError(f"P must be (m, m), got {tuple(p.shape)}")
    if device.type == "cpu":
        return torch.linalg.eigh(0.5 * (p + p.T))
    _require_cuda(p)
    m = p.shape[0]
    check_dimension(m, eigen=True)
    lam = torch.empty(m, dtype=torch.float64, device=device)
    v = torch.empty((m, m), dtype=torch.float64, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        rc = lib.svgd_sym_eigen(
            p.data_ptr(), m, lam.data_ptr(), v.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(rc, SYM_EIGEN_KERNEL)
    launch_counts[SYM_EIGEN_KERNEL] += 1
    return lam, v


def eigen_rows(coords_c, p_matrix, eig=None):
    """K15's operands: (z (n, m), lam (m,), V (m, m)) in float64, with
    P_sym/2 = V diag(lam) V^T and z = coords_c V, so
    ``sum_k lam_k (z_ik - z_jk)^2 = d^T P d`` for any P, indefinite too.

    ``eig``: the caller's (lam, V) of P_sym/2, used as given; without it,
    ``symmetric_eigen(p_matrix)`` on the coordinates' device. Nothing is
    read on the host either way."""
    if eig is None:
        eig = symmetric_eigen(p_matrix, coords_c.device)
    lam, v = eig
    lam = lam.to(coords_c.device, torch.float64)
    v = v.to(coords_c.device, torch.float64)
    return coords_c.to(torch.float64) @ v, lam, v


def _square_launch(targets, sources, scores, gammas, signs, thresholds_sq,
                   bf16=False):
    """K1 (one positive term, ``signs`` None; ``bf16`` its bfloat16
    instance) or the terms square kernel.

    Both split the sources over the grid; the library gives the number of
    splits (``svgd_square_splits``, one rule for both kernels;
    ``svgd_square_bf16_splits`` for K1's bf16 instance) and the wrapper
    allocates the workspace of the splits' partial sums,
    (splits, n_t, 2w + 1), which the kernel's finishing pass sums in
    order. From m = 5 both kernels' tensor-core body copies sources and
    scores 16 bytes at a time, so a scores view that starts off a 16-byte
    boundary is copied first. Past MAX_M the float32 instances take rows of
    ``w = wide_row_width(m)`` floats (targets, sources and scores padded
    with zero columns, which add nothing to sq, KS or KX, so that every row
    of the wide body's 16-byte copies starts aligned), and phi is cut back
    to m columns; elsewhere w = m."""
    g, thr = _device_operands(sources, scores, gammas, thresholds_sq)
    if targets.ndim != 2 or targets.shape[1] != sources.shape[1]:
        raise ValueError("targets must be (n_t, m) with the sources' m")
    if targets.device != sources.device:
        raise ValueError("targets and sources must share one device")
    n_t, m = targets.shape
    n_s = sources.shape[0]
    # Center on the source mean, as the plain version and the JAX wrapper do.
    src32 = sources.to(torch.float32)
    center = src32.mean(dim=0)
    tgt_c = (targets.to(torch.float32) - center).contiguous()
    src_c = (src32 - center).contiguous()
    sc32 = scores.to(torch.float32).contiguous()
    width = m if bf16 else wide_row_width(m)
    if width != m:
        pad = (0, width - m)
        tgt_c, src_c, sc32 = (torch.nn.functional.pad(v, pad)
                              for v in (tgt_c, src_c, sc32))
    if sc32.data_ptr() % 16:
        sc32 = sc32.clone()
    phi = torch.empty((n_t, width), dtype=torch.float32,
                      device=targets.device)
    counts = torch.zeros(thr.shape[0], dtype=torch.int64, device=targets.device)
    lib = load_library()
    with torch.cuda.device(targets.device):
        stream = torch.cuda.current_stream().cuda_stream
        splits = (lib.svgd_square_bf16_splits if bf16
                  else lib.svgd_square_splits)(n_t, n_s, width)
        work = torch.empty((splits, n_t, 2 * width + 1), dtype=torch.float32,
                           device=targets.device)
        if bf16:
            name = SQUARE_BF16_KERNEL
            rc = lib.svgd_fused_phi_counts_square_bf16(
                tgt_c.data_ptr(), src_c.data_ptr(), sc32.data_ptr(),
                g.data_ptr(), thr.data_ptr(), n_t, n_s, m, thr.shape[0],
                phi.data_ptr(), counts.data_ptr(), work.data_ptr(), splits,
                stream,
            )
        elif signs is None:
            name = SQUARE_KERNEL
            rc = lib.svgd_fused_phi_counts_square(
                tgt_c.data_ptr(), src_c.data_ptr(), sc32.data_ptr(),
                g.data_ptr(), thr.data_ptr(), n_t, n_s, width, thr.shape[0],
                phi.data_ptr(), counts.data_ptr(), work.data_ptr(), splits,
                stream,
            )
        else:
            name = TERMS_SQUARE_KERNEL
            rc = lib.svgd_fused_phi_terms_square(
                tgt_c.data_ptr(), src_c.data_ptr(), sc32.data_ptr(),
                g.data_ptr(), _host_signs(signs, g.shape[0]), g.shape[0],
                thr.data_ptr(), n_t, n_s, width, thr.shape[0], phi.data_ptr(),
                counts.data_ptr(), work.data_ptr(), splits, stream,
            )
    _check_launch(rc, name)
    launch_counts[name] += 1
    return phi[:, :m].to(targets.dtype).contiguous(), counts


def _bf16_operands(coords, scores, panel=False, panel_blocks=None):
    """What K2's and K3's bfloat16 entries take besides gamma and the
    thresholds: (coordinates centred in float32 (n, m), scores in float32
    (n, m), both contiguous at any alignment; the workspace their pack
    kernel fills, ``sym_plan.bf16_work_bytes(n, m)`` bytes; the zeroed
    (2m + 1, n) accumulator [KS | KX | rowsum], into which K3's instance
    too flushes its panels' tile pairs; with ``panel``, the plan
    ``card_panel_plan(n, panel_blocks, bf16=True)``'s (nb, w), else
    None)."""
    n, m = coords.shape
    device = coords.device
    coords_c = _centered32(coords).contiguous()
    sc32 = scores.to(torch.float32).contiguous()
    work = torch.empty(bf16_work_bytes(n, m), dtype=torch.uint8,
                       device=device)
    plan = _panel_plan(n, panel_blocks, bf16=True)[:2] if panel else None
    acc = torch.zeros((2 * m + 1, n), dtype=torch.float32, device=device)
    return coords_c, sc32, work, acc, plan


def _bf16_tri_launch(coords, scores, gamma, thresholds_sq, panel=False,
                     panel_blocks=None):
    """K2's bfloat16 instance (``fused_phi_counts_sym_bf16``) or, with
    ``panel``, K3's (``fused_phi_counts_sympanel_bf16``): both on
    ``csrc/bf16_tri_sm90.cuh``'s body, whose entry first rounds the
    operands into the workspace with its pack kernel, then sweeps into
    [KS | KX | rowsum] (``_bf16_operands``), which
    ``ops/phi.bf16_sym_finish`` finishes."""
    g, thr = _device_operands(coords, scores, [gamma], thresholds_sq)
    n, m = coords.shape
    device = coords.device
    coords_c, sc32, work, acc, plan = _bf16_operands(coords, scores, panel,
                                                     panel_blocks)
    upper = torch.zeros(thr.shape[0], dtype=torch.int64, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if panel:
            name = SYMPANEL_BF16_KERNEL
            rc = lib.svgd_fused_phi_counts_sympanel_bf16(
                coords_c.data_ptr(), sc32.data_ptr(), g.data_ptr(),
                thr.data_ptr(), n, m, thr.shape[0], *plan, work.data_ptr(),
                acc.data_ptr(), upper.data_ptr(), stream,
            )
        else:
            name = SYM_BF16_KERNEL
            rc = lib.svgd_fused_phi_counts_sym_bf16(
                coords_c.data_ptr(), sc32.data_ptr(), g.data_ptr(),
                thr.data_ptr(), n, m, thr.shape[0], work.data_ptr(),
                acc.data_ptr(), upper.data_ptr(), stream,
            )
    _check_launch(rc, name)
    launch_counts[name] += 1
    return (bf16_sym_finish(acc, coords_c, sc32, g[0], n).to(coords.dtype),
            2 * upper - n)


def _sym_launch(coords, scores, gammas, signs, thresholds_sq):
    """K2 (one positive term, ``signs`` None) or the terms triangle
    kernel."""
    g, thr = _device_operands(coords, scores, gammas, thresholds_sq)
    n, m = coords.shape
    coords_c = _centered32(coords).contiguous()
    sc32 = scores.to(torch.float32).contiguous()
    xk, sk, width = _tri_operands(coords_c, sc32, m)
    acc = torch.zeros((2 * width, n), dtype=torch.float32,
                      device=coords.device)
    upper = torch.zeros(thr.shape[0], dtype=torch.int64, device=coords.device)
    lib = load_library()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        if signs is None:
            name = SYM_KERNEL
            rc = lib.svgd_fused_phi_counts_sym(
                xk.data_ptr(), sk.data_ptr(), g.data_ptr(),
                thr.data_ptr(), n, width, thr.shape[0], acc.data_ptr(),
                upper.data_ptr(), stream,
            )
        else:
            name = TERMS_SYM_KERNEL
            rc = lib.svgd_fused_phi_terms_sym(
                xk.data_ptr(), sk.data_ptr(), g.data_ptr(),
                _host_signs(signs, g.shape[0]), g.shape[0], thr.data_ptr(),
                n, width, thr.shape[0], acc.data_ptr(), upper.data_ptr(),
                stream,
            )
    _check_launch(rc, name)
    launch_counts[name] += 1
    # Epilogue (the JAX one, pallas_phi.py:701-708 and :2514-2528, on the
    # columns kept): acc = [KS | D] with D = sum_j w (x_i - x_j), w = gamma k
    # for one term. The self pairs (k_t = 1) entered KS in both directions,
    # so subtract sum_t s_t * s_i once; their D term is 0. The kernel counted
    # the upper triangle with its diagonal, so counts = 2U - n.
    a = acc.T
    ks, d = a[:, :m], a[:, width:width + m]
    if signs is None:
        phi = (ks - sc32 + 2.0 * g[0] * d) / n
    else:
        phi = (ks - sum(float(s) for s in signs) * sc32 + 2.0 * d) / n
    return phi.to(coords.dtype), 2 * upper - n


_panel_index_cache = {}


def _panel_index(nb, device, p0=0, count=None):
    """panel_index(nb, device, p0, count) on the device, built once per
    (nb, device, p0, count): a copy from the host each call would
    synchronise the step."""
    key = (nb, str(device), p0, count)
    if key not in _panel_index_cache:
        _panel_index_cache[key] = panel_index(nb, device, p0, count)
    return _panel_index_cache[key]


def _panel_plan(n, panel_blocks, bf16=False):
    """(nb, w, number of panels) of the card's panel plan for n particles
    (``bf16``: K3's bf16 instance's), whose panels fill the grid's y (at
    most MAX_PANELS)."""
    nb, w, _ = card_panel_plan(n, panel_blocks, bf16)
    num_p = nb * (nb + 1) // 2
    if num_p > MAX_PANELS:
        raise ValueError(
            f"the panel kernels take at most {MAX_PANELS} panels, got "
            f"{num_p} ({nb} super-blocks)"
        )
    return nb, w, num_p


def _panel_windows(num_p, m, w, device):
    """The zeroed (num_p, 2, 2m, w) float32 window buffer of a panel
    launch. Past m = 64 it grows with m (about 2.3 GB at N = 262,144,
    m = 123): a buffer larger than the card's memory raises here, with its
    size, before anything is allocated or launched."""
    shape = (num_p, 2, 2 * m, w)
    if device.type == "cuda":
        nbytes = 4 * num_p * 2 * 2 * m * w
        total = torch.cuda.get_device_properties(device).total_memory
        if nbytes > total:
            raise ValueError(
                f"the panel windows {shape} take {nbytes} bytes, more than "
                f"the {total} bytes of {torch.cuda.get_device_name(device)};"
                " take more super-blocks (panel_blocks) or the full-width "
                "triangle (sym=True)"
            )
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _sympanel_launch(coords, scores, gammas, signs, thresholds_sq,
                     panel_blocks):
    """K3's port (one positive term, ``signs`` None) or the terms panel
    kernel (K12/K13's), on the card's panel plan; past m = 64 the library
    runs their wide instances."""
    g, thr = _device_operands(coords, scores, gammas, thresholds_sq)
    n, m = coords.shape
    nb, w, num_p = _panel_plan(n, panel_blocks)
    panels = _panel_windows(num_p, m, w, coords.device)
    coords_c = _centered32(coords).contiguous()
    sc32 = scores.to(torch.float32).contiguous()
    upper = torch.zeros(thr.shape[0], dtype=torch.int64, device=coords.device)
    lib = load_library()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        if signs is None:
            name = SYMPANEL_KERNEL
            rc = lib.svgd_fused_phi_counts_sympanel(
                coords_c.data_ptr(), sc32.data_ptr(), g.data_ptr(),
                thr.data_ptr(), n, m, thr.shape[0], nb, w, panels.data_ptr(),
                upper.data_ptr(), stream,
            )
        else:
            name = TERMS_SYMPANEL_KERNEL
            rc = lib.svgd_fused_phi_terms_sympanel(
                coords_c.data_ptr(), sc32.data_ptr(), g.data_ptr(),
                _host_signs(signs, g.shape[0]), g.shape[0], thr.data_ptr(),
                n, m, thr.shape[0], nb, w, panels.data_ptr(),
                upper.data_ptr(), stream,
            )
    _check_launch(rc, name)
    launch_counts[name] += 1
    # One RBF: D is unweighted, so phi takes 2 gamma D; the terms kernel's
    # D carries the weights w = sum s gamma k.
    if signs is None:
        s_total, d_scale = 1.0, 2.0 * g[0]
    else:
        s_total, d_scale = sum(float(s) for s in signs), 2.0
    phi, counts = sympanel_epilogue(
        panels, upper, _panel_index(nb, coords.device), n, sc32, s_total,
        d_scale,
    )
    return phi.to(coords.dtype), counts


def _aniso_launch(coords, scores, iso_gammas, iso_signs, aniso_ps,
                  aniso_signs, thresholds_sq, lowers):
    """K14: the one-pass kernel, or the term-group triangle kernel (its
    wide instances past MAX_M, finished by ``ops/phi.aniso_groups_finish``)."""
    g, thr = _device_operands(coords, scores, iso_gammas, thresholds_sq,
                              min_terms=0)
    n_aniso = len(aniso_signs)
    if not 1 <= n_aniso <= MAX_ANISO_TERMS:
        raise ValueError(
            f"the anisotropic CUDA sweep takes 1 to {MAX_ANISO_TERMS} "
            f"anisotropic terms, got {n_aniso}"
        )
    n, m = coords.shape
    if lowers is None:
        lowers = cholesky_factors(aniso_ps, coords.device)
    coords_c = _centered32(coords).contiguous()
    sc32 = scores.to(torch.float32).contiguous()
    if n_aniso == 1 and m <= ONE_PASS_MAX_M:
        lib = load_library()
        acc = torch.zeros((m, n), dtype=torch.float32, device=coords.device)
        counts = torch.zeros(thr.shape[0], dtype=torch.int64,
                             device=coords.device)
        lower32 = lowers[0].to(torch.float32).contiguous()
        with torch.cuda.device(coords.device):
            rc = lib.svgd_fused_phi_aniso_terms_sym(
                coords_c.data_ptr(), sc32.data_ptr(), lower32.data_ptr(),
                g.data_ptr(), _host_signs(iso_signs, len(iso_gammas)),
                len(iso_gammas), float(aniso_signs[0]), thr.data_ptr(), n, m,
                thr.shape[0], acc.data_ptr(), counts.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
        _check_launch(rc, ANISO_KERNEL)
        launch_counts[ANISO_KERNEL] += 1
        # acc = n phi^T: KS + 2 D_iso + 2 D_z L^T over every ordered pair.
        return (acc.T / n).to(coords.dtype), counts
    acc, upper = _aniso_groups(coords_c, sc32, g, thr, len(iso_gammas),
                               iso_signs, aniso_signs, lowers)
    if m > MAX_M:
        phi = aniso_groups_finish(acc, sc32, g[0], iso_signs, aniso_signs,
                                  lowers, n)
        # With no isotropic term no group counted: the count kernel's self
        # form (the same tensor as rows and columns) counts all n^2 pairs.
        counts = (2 * upper - n if len(iso_gammas)
                  else count_le_cuda(coords_c, coords_c, thr))
        return phi.to(coords.dtype), counts
    # Up to MAX_M: acc[g] = [KS_g | D_g] with the signs in the weights. The
    # groups' KS add up; the self pairs (k = 1 for every term) entered KS
    # in both directions, so subtract (sum s) s_i once. D_0 is the
    # isotropic direction (weights already carry gamma);
    # D_1+t = sum_j s_t k_t (z_ti - z_tj), and D_t P_sym = 2 D_1+t L_t^T
    # (float64, never TF32).
    s_total = sum(float(s) for s in iso_signs) + sum(
        float(s) for s in aniso_signs
    )
    grad_aniso = torch.einsum(
        "tkn,tlk->nl", acc[1:, m:].to(torch.float64), lowers
    )
    phi = (acc[:, :m].sum(dim=0).T - s_total * sc32 + 2.0 * acc[0, m:].T
           + 2.0 * grad_aniso.to(torch.float32)) / n
    return phi.to(coords.dtype), 2 * upper - n


def aniso_group_operands(coords_c, sc32, lowers):
    """K14's term-group operands: (x, scores, z, width) with z
    (n_aniso, n, width) = x L_t formed in float64 and rounded to float32.
    Past MAX_M x and the scores come from ``_tri_operands`` (zero columns
    to ``wide_row_width(m)``) and each L_t is padded with zero rows and
    columns, so that z's columns past m are exact zeros (a product of
    zeros, not a float32 product padded after); up to MAX_M all stay at
    width m."""
    m = coords_c.shape[1]
    x, s, width = _tri_operands(coords_c, sc32, m)
    if width != m:
        pad = torch.zeros((lowers.shape[0], width, width),
                          dtype=torch.float64, device=coords_c.device)
        pad[:, :m, :m] = lowers
        lowers = pad
    z = (x.to(torch.float64) @ lowers).to(torch.float32).contiguous()
    return x, s, z, width


def _aniso_groups(coords_c, sc32, g, thr, n_iso, iso_signs, aniso_signs,
                  lowers):
    """One call of K14's term-group entry on centered float32 coordinates:
    the raw accumulator (1 + n_aniso, 2 width, n) of [KS_g | D_g] a group
    and the upper counts (T,). Past MAX_M its wide kernels leave each
    group's slab as ``ops/phi.aniso_groups_plain`` gives it (at width m
    there) and, with no isotropic term, the counts at 0."""
    n, m = coords_c.shape
    n_aniso = len(aniso_signs)
    x, s, z, width = aniso_group_operands(coords_c, sc32, lowers)
    acc = torch.zeros((1 + n_aniso, 2 * width, n), dtype=torch.float32,
                      device=coords_c.device)
    upper = torch.zeros(thr.shape[0], dtype=torch.int64,
                        device=coords_c.device)
    lib = load_library()
    with torch.cuda.device(coords_c.device):
        rc = lib.svgd_fused_phi_aniso_terms_groups(
            x.data_ptr(), z.data_ptr(), s.data_ptr(), g.data_ptr(),
            _host_signs(iso_signs, n_iso), n_iso,
            _host_signs(aniso_signs, n_aniso), n_aniso, thr.data_ptr(), n,
            width, thr.shape[0], acc.data_ptr(), upper.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    name = ANISO_WIDE_KERNEL if m > MAX_M else ANISO_KERNEL
    _check_launch(rc, name)
    launch_counts[name] += 1
    return acc, upper


def aniso_wide_groups_cuda(coords, scores, iso_gammas, iso_signs,
                           aniso_signs, thresholds_sq, lowers):
    """K14's wide term groups past MAX_M, unfinished: (acc
    (1 + n_aniso, 2 width, n), upper (T,)) of one launch of the wide entry
    on CUDA tensors (``lowers`` the float64 factors, ``cholesky_factors``),
    the counterpart of ``ops/phi.aniso_groups_plain``, whose slabs are
    acc's columns [0, m) and [width, width + m). The kernels' check
    (chip_smoke.py) reads it; the sweep's wrapper is
    ``phi_rbf_aniso_terms_fused_cuda``."""
    _require_cuda(coords)
    g, thr = _device_operands(coords, scores, iso_gammas, thresholds_sq,
                              min_terms=0)
    if coords.shape[1] <= MAX_M:
        raise ValueError(f"the wide groups take m > {MAX_M}, got "
                         f"m={coords.shape[1]}")
    return _aniso_groups(
        _centered32(coords).contiguous(),
        scores.to(torch.float32).contiguous(), g, thr, len(iso_gammas),
        iso_signs, aniso_signs, lowers)


def _phi_rbf_launch(coords, scores, p_matrix, psd, eig, bf16=False):
    """K15: the fixed-P sweep kernel (the decomposition, where the caller
    has none, on the card too); past MAX_M, and for the bfloat16 opt-in at
    any m, its wide instance on P itself."""
    _check_pair(coords, scores)
    n, m = coords.shape
    if m > MAX_M or bf16:
        return _phi_rbf_wide_launch(coords, scores, p_matrix, psd, eig, bf16)
    z64, lam, v = eigen_rows(_centered32(coords), p_matrix, eig)
    z = z64.to(torch.float32).contiguous()
    lam32 = lam.to(torch.float32).contiguous()
    sc32 = scores.to(torch.float32).contiguous()
    out = torch.zeros((2 * m, n), dtype=torch.float32, device=coords.device)
    lib = load_library()
    with torch.cuda.device(coords.device):
        rc = lib.svgd_phi_rbf_square(
            z.data_ptr(), sc32.data_ptr(), lam32.data_ptr(), n, m, int(psd),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(rc, PHI_RBF_KERNEL)
    launch_counts[PHI_RBF_KERNEL] += 1
    # out = [KS | D_z]; D P_sym = 2 D_z diag(lam) V^T (float64).
    grad = (out[m:].T.to(torch.float64) * lam) @ v.T
    phi = (out[:m].T + 2.0 * grad.to(torch.float32)) / n
    return phi.to(coords.dtype)


def _half_of(p_matrix, eig, device=None):
    """H = P_sym/2 in float64 on ``device`` (the coordinates'): from the
    caller's (lam, V) where given, else from P."""
    if eig is not None:
        lam, v = (torch.as_tensor(t).to(device, torch.float64) for t in eig)
        return (v * lam) @ v.T
    p = torch.as_tensor(p_matrix).to(device, torch.float64)
    return 0.5 * (p + p.T)


def _phi_rbf_wide_launch(coords, scores, p_matrix, psd, eig, bf16=False):
    """K15 past MAX_M (``phi_rbf_wide``; ``bf16`` its bfloat16 instance,
    ``phi_rbf_wide_bf16``, at any m): the JAX kernel's form on
    H = P_sym/2 itself, from P or from the caller's (lam, V) (a MEDIAN's
    gamma I, a kept decomposition), formed on the device in float64; the
    operands Y = X_c H and q from ``ops/phi.gram_operands``."""
    n, m = coords.shape
    device = coords.device
    half = _half_of(p_matrix, eig, device)
    coords_c = _centered32(coords).contiguous()
    y, q = gram_operands(coords_c, half)
    sc32 = scores.to(torch.float32).contiguous()
    out = torch.zeros((2 * m, n), dtype=torch.float32, device=device)
    lib = load_library()
    name = PHI_RBF_WIDE_BF16_KERNEL if bf16 else PHI_RBF_WIDE_KERNEL
    entry = lib.svgd_phi_rbf_wide_bf16 if bf16 else lib.svgd_phi_rbf_wide
    with torch.cuda.device(device):
        rc = entry(
            coords_c.data_ptr(), y.data_ptr(), q.data_ptr(), sc32.data_ptr(),
            n, m, int(psd), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(rc, name)
    launch_counts[name] += 1
    # out = [KS | D], D = sum_j k (x_i - x_j). In float32 the self pairs
    # (pinned, k = 1) entered KS in both directions, so subtract s_i once;
    # the bf16 instance enters each self pair once, unpinned, as the JAX
    # kernel's square sweep does. D P_sym = 2 D H (float64).
    grad = out[m:].T.to(torch.float64) @ half
    phi = out[:m].T + 2.0 * grad.to(torch.float32)
    if not bf16:
        phi = phi - sc32
    return (phi / n).to(coords.dtype)


def phi_rbf_fused_cuda(coords, scores, gamma, thresholds_sq, sym=None,
                       panel_blocks=None, dot_dtype="float32"):
    """Fused sweep over one particle set: (phi (n, m), counts (T,) int64).

    Counterpart of ``svgdcpp_tpu.ops.pallas_phi.phi_rbf_fused_pallas``. The
    form is ``resolve_sym(sym, n, m)``. On a CUDA tensor: the panel kernel
    for "panel" (``panel_blocks`` forces its super-block count), the
    full-width triangle kernel for True, else the square kernel, in float32
    (phi is returned in the coords' dtype); ``dot_dtype='bfloat16'`` (the
    JAX package's opt-in; 'float32' by default, any other value raises)
    takes each form's bfloat16 instance. On a CPU tensor the plain
    versions: the panel schedule ``phi_rbf_sympanel_fused_counts`` for
    "panel", else ``phi_rbf_fused_counts`` (its square sweep gives the same
    phi and counts as either other kernel in float32); under bf16 the
    triangle's own, ``phi_rbf_sym_fused_counts`` (the self pair pinned, as
    the triangle kernels pin it), for True.
    """
    bf16 = dot_bf16(dot_dtype)
    form = resolve_sym(sym, coords.shape[0], coords.shape[1])
    if coords.device.type == "cpu":
        if form == "panel":
            return phi_rbf_sympanel_fused_counts(
                coords, scores, gamma, thresholds_sq, panel_blocks,
                dot_dtype=dot_dtype,
            )
        if form and bf16:
            return phi_rbf_sym_fused_counts(coords, scores, gamma,
                                            thresholds_sq, dot_dtype)
        return phi_rbf_fused_counts(coords, scores, gamma, thresholds_sq,
                                    dot_dtype=dot_dtype)
    _require_cuda(coords)
    if bf16 and form:
        return _bf16_tri_launch(coords, scores, gamma, thresholds_sq,
                                form == "panel", panel_blocks)
    if form == "panel":
        return _sympanel_launch(coords, scores, [gamma], None, thresholds_sq,
                                panel_blocks)
    if form:
        return _sym_launch(coords, scores, [gamma], None, thresholds_sq)
    return _square_launch(coords, coords, scores, [gamma], None, thresholds_sq,
                          bf16)


def phi_rbf_fused_cuda_cross(targets, sources, source_scores, gamma,
                             thresholds_sq, dot_dtype="float32"):
    """Cross form: ``targets`` against ``sources``, phi normalized by the
    source count; counts cover all n_t x n_s pairs. Counterpart of
    ``svgdcpp_tpu.ops.pallas_phi.phi_rbf_fused_pallas_cross``
    (``dot_dtype`` as in :func:`phi_rbf_fused_cuda`); CPU tensors go to
    the plain ``phi_rbf_cross_fused_counts``."""
    bf16 = dot_bf16(dot_dtype)
    if targets.device.type == "cpu":
        return phi_rbf_cross_fused_counts(
            targets, sources, source_scores, gamma, thresholds_sq,
            dot_dtype=dot_dtype,
        )
    _require_cuda(targets)
    return _square_launch(
        targets, sources, source_scores, [gamma], None, thresholds_sq, bf16
    )


def phi_rbf_terms_fused_cuda(coords, scores, gammas, signs, thresholds_sq,
                             sym=None, panel_blocks=None):
    """Composed-kernel fused sweep over one particle set: phi of
    ``sum_t signs[t] exp(-gammas[t] sq)`` and the counts.

    Counterpart of ``svgdcpp_tpu.ops.pallas_phi.phi_rbf_terms_fused_pallas``.
    ``gammas`` are scalars (device tensors on the card, never read on the
    host), ``signs`` Python numbers of either sign, 1 to MAX_TERMS of each.
    The form is ``resolve_sym(sym, n, m, len(signs))``. On a CUDA tensor:
    the terms panel kernel for "panel" (``panel_blocks`` forces its
    super-block count), the terms triangle kernel for True, else the terms
    square kernel, in float32. On a CPU tensor: the plain
    ``phi_rbf_terms_sympanel_fused_counts`` for "panel", else
    ``phi_rbf_terms_fused_counts``.
    """
    form = resolve_sym(sym, coords.shape[0], coords.shape[1], len(signs))
    if coords.device.type == "cpu":
        if form == "panel":
            return phi_rbf_terms_sympanel_fused_counts(
                coords, scores, gammas, signs, thresholds_sq, panel_blocks
            )
        return phi_rbf_terms_fused_counts(
            coords, scores, gammas, signs, thresholds_sq
        )
    _require_cuda(coords)
    if form == "panel":
        return _sympanel_launch(coords, scores, gammas, signs, thresholds_sq,
                                panel_blocks)
    if form:
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


def phi_rbf_aniso_terms_fused_cuda(coords, scores, iso_gammas, iso_signs,
                                   aniso_ps, aniso_signs, thresholds_sq,
                                   lowers=None):
    """Fused sweep of a composed kernel with anisotropic terms over one
    particle set: phi of ``sum_iso s exp(-gamma sq) + sum_t s_t
    exp(-d^T P_t d)`` and the counts of the Euclidean pair distances.

    Counterpart of
    ``svgdcpp_tpu.ops.pallas_phi.phi_rbf_aniso_terms_fused_pallas``, and
    like it a triangle sweep at any n. ``iso_gammas`` are scalars (device
    tensors on the card, never read on the host), ``aniso_ps`` (m, m)
    precisions, each positive definite; the signs are Python numbers;
    ``lowers`` the factors ``cholesky_factors(aniso_ps)`` where the caller
    keeps them (a constant P; ``aniso_ps`` may then be None), else they are
    factored here. On a CUDA tensor, in float32, at any m: the kernel
    fused_phi_aniso_terms_sym, in one pass for one anisotropic term up to
    ONE_PASS_MAX_M, in term groups otherwise, past MAX_M the groups' wide
    instance fused_phi_aniso_terms_wide (``launch_counts`` under
    ANISO_WIDE_KERNEL; with no isotropic term the counts take one launch
    of the count kernel, ``count_le_cuda`` on the coordinates as rows and
    columns); with no anisotropic term (a hot-swap may leave
    none), the terms triangle kernel, which computes the same function. On
    a CPU tensor: the plain ``phi_rbf_aniso_terms_fused_counts``, in the
    factor form (``phi_rbf_factor``) where ``lowers`` are given.
    """
    if coords.device.type == "cpu":
        return phi_rbf_aniso_terms_fused_counts(
            coords, scores, iso_gammas, iso_signs, aniso_ps, aniso_signs,
            thresholds_sq, lowers=lowers,
        )
    _require_cuda(coords)
    if not aniso_signs:
        return _sym_launch(coords, scores, iso_gammas, iso_signs,
                           thresholds_sq)
    return _aniso_launch(coords, scores, iso_gammas, iso_signs, aniso_ps,
                         aniso_signs, thresholds_sq, lowers)


def phi_rbf_cuda(coords, scores, p_matrix, psd=True, eig=None,
                 dot_dtype="float32"):
    """RBF phi with one full (m, m) precision P over one particle set.

    Counterpart of ``svgdcpp_tpu.ops.pallas_phi.phi_rbf_pallas``: ``psd``
    clamps the quadratic form at 0 (False for an indefinite P, such as a
    HESSIAN scale). ``eig``: (lam, V) of P_sym/2 where the caller has it
    (a P fixed over the run, or gamma I); without it the wrapper decomposes
    P on the card (``symmetric_eigen``), with no host read. On a CUDA
    tensor, in float32: the kernel phi_rbf_square up to MAX_M (a triangle
    sweep at m = 1-8 and 11, the square sweep above); past it phi_rbf_wide
    (``launch_counts`` under PHI_RBF_WIDE_KERNEL), which takes P_sym/2
    itself (from ``eig`` where given) in the JAX kernel's Gram form, so
    nothing is decomposed. On a CPU tensor, at any m: the plain
    ``phi_rbf_eigen`` from ``eig``, or from the decomposition's plain
    version (``symmetric_eigen`` on the CPU, ``torch.linalg.eigh``).

    ``dot_dtype='bfloat16'`` (the JAX kernel's ``dot_dtype``; 'float32' by
    default, any other value raises): on a CUDA tensor phi_rbf_wide_bf16
    at any m (``launch_counts`` under PHI_RBF_WIDE_BF16_KERNEL), on a CPU
    tensor its plain version ``phi_rbf_gram(..., dot_dtype)``. No driver
    route passes it: the JAX package's 'pallas' route, which the 'cuda'
    route stands for, does not read the option.
    """
    bf16 = dot_bf16(dot_dtype)
    if coords.device.type == "cpu":
        if bf16:
            return phi_rbf_gram(coords, scores, _half_of(p_matrix, eig),
                                psd=psd, dot_dtype=dot_dtype)
        lam, v = symmetric_eigen(p_matrix, "cpu") if eig is None else eig
        return phi_rbf_eigen(coords, scores, lam, v, psd=psd)
    _require_cuda(coords)
    return _phi_rbf_launch(coords, scores, p_matrix, psd, eig, bf16)


# ----------------------------------------------------------------------
# The sharded engine's chunks (K4, K10/K11, K5) and the count pass (K16)
# ----------------------------------------------------------------------


def _check_chunk(world, rank):
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")


def _sym_chunk_launch(coords, scores, gammas, signs, thresholds_sq, world,
                      rank):
    """K4 (one positive term, ``signs`` None) or K10/K11's chunk kernel."""
    g, thr = _device_operands(coords, scores, gammas, thresholds_sq)
    n, m = coords.shape
    lib = load_library()
    # The range is one of the kernel's own tile list, whose tile side the
    # library gives for the instance that serves m.
    t0, count = sym_tile_chunk(n, world, rank,
                               lib.svgd_sym_tile(m, int(signs is not None)))
    # Every rank centers on the mean of the gathered global set.
    coords_c = _centered32(coords).contiguous()
    sc32 = scores.to(torch.float32).contiguous()
    xk, sk, width = _tri_operands(coords_c, sc32, m)
    acc = torch.zeros((2 * width, n), dtype=torch.float32,
                      device=coords.device)
    upper = torch.zeros(thr.shape[0], dtype=torch.int64, device=coords.device)
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        if signs is None:
            name = SYM_CHUNK_KERNEL
            rc = lib.svgd_fused_phi_counts_sym_chunk(
                xk.data_ptr(), sk.data_ptr(), g.data_ptr(),
                thr.data_ptr(), n, width, thr.shape[0], t0, count,
                acc.data_ptr(), upper.data_ptr(), stream,
            )
        else:
            name = TERMS_SYM_CHUNK_KERNEL
            rc = lib.svgd_fused_phi_terms_sym_chunk(
                xk.data_ptr(), sk.data_ptr(), g.data_ptr(),
                _host_signs(signs, g.shape[0]), g.shape[0], thr.data_ptr(),
                n, width, thr.shape[0], t0, count, acc.data_ptr(),
                upper.data_ptr(), stream,
            )
    _check_launch(rc, name)
    if count:
        launch_counts[name] += 1
    if width != m:  # the (2m, n) accumulator [KS | D] of the m columns
        acc = torch.cat((acc[:m], acc[width:width + m]))
    return acc, upper


def phi_rbf_fused_sym_chunk_cuda(coords, scores, gamma, thresholds_sq, world,
                                 rank):
    """Rank's chunk of one RBF's full-width triangle sweep over the GLOBAL
    set ``coords`` (n, m): (acc (2m, n) = [KS | D], upper (T,) int64), raw.

    Counterpart of ``svgdcpp_tpu.ops.pallas_phi.
    phi_rbf_fused_pallas_sym_sharded`` (K4). The chunk is rank's balanced
    range of the kernel's tile list (``sym_plan.sym_tile_chunk``); summed
    over the world's ranks, acc and upper are the whole triangle's, which
    ``ops/phi.phi_rbf_fused_sym_finish`` and 2U - n finish. On a CUDA
    tensor: the kernel fused_phi_counts_sym_chunk, in float32 (an empty
    range launches nothing). On a CPU tensor: the plain
    ``phi_rbf_sym_chunk_counts``."""
    _check_chunk(world, rank)
    if coords.device.type == "cpu":
        return phi_rbf_sym_chunk_counts(coords, scores, gamma, thresholds_sq,
                                        world, rank)
    _require_cuda(coords)
    return _sym_chunk_launch(coords, scores, [gamma], None, thresholds_sq,
                             world, rank)


def phi_rbf_terms_fused_sym_chunk_cuda(coords, scores, gammas, signs,
                                       thresholds_sq, world, rank):
    """Rank's chunk of a composed kernel's full-width triangle sweep over
    the GLOBAL set: (acc (2m, n), upper (T,) int64), raw, D weighted by
    w = sum s gamma k.

    Counterpart of ``svgdcpp_tpu.ops.pallas_phi.
    phi_rbf_terms_fused_pallas_sym_sharded`` and its ``_direct`` form (K11,
    K10: one CUDA kernel stands for both). Finish with
    ``ops/phi.phi_rbf_terms_fused_sym_finish``. On a CUDA tensor: the kernel
    fused_phi_terms_sym_chunk, in float32. On a CPU tensor: the plain
    ``phi_rbf_terms_sym_chunk_counts``."""
    _check_chunk(world, rank)
    if coords.device.type == "cpu":
        return phi_rbf_terms_sym_chunk_counts(
            coords, scores, gammas, signs, thresholds_sq, world, rank
        )
    _require_cuda(coords)
    return _sym_chunk_launch(coords, scores, gammas, signs, thresholds_sq,
                             world, rank)


def phi_rbf_sympanel_chunk_cuda(coords, scores, gamma, thresholds_sq, world,
                                rank, panel_blocks=None):
    """Rank's chunk of one RBF's panel triangle sweep over the GLOBAL set:
    (acc (2m, n), upper (T,) int64), raw.

    Counterpart of ``svgdcpp_tpu.ops.pallas_phi.
    phi_rbf_fused_pallas_sympanel_sharded`` (K5). The chunk is rank's
    balanced range of the card's panel list (``sym_plan.panel_chunk`` of
    ``card_panel_plan(n, panel_blocks)``); its windows are scattered onto
    acc (``ops/phi.sympanel_scatter``), so that the sum over the ranks is
    the whole sweep's accumulator. On a CUDA tensor: the kernel
    fused_phi_counts_sympanel_chunk, in float32. On a CPU tensor: the plain
    ``phi_rbf_sympanel_chunk_counts``."""
    _check_chunk(world, rank)
    if coords.device.type == "cpu":
        return phi_rbf_sympanel_chunk_counts(
            coords, scores, gamma, thresholds_sq, world, rank, panel_blocks
        )
    _require_cuda(coords)
    g, thr = _device_operands(coords, scores, [gamma], thresholds_sq)
    n, m = coords.shape
    nb, w, _ = _panel_plan(n, panel_blocks)
    p0, count = panel_chunk(nb, world, rank)
    coords_c = _centered32(coords).contiguous()
    sc32 = scores.to(torch.float32).contiguous()
    panels = _panel_windows(count, m, w, coords.device)
    upper = torch.zeros(thr.shape[0], dtype=torch.int64, device=coords.device)
    lib = load_library()
    with torch.cuda.device(coords.device):
        rc = lib.svgd_fused_phi_counts_sympanel_chunk(
            coords_c.data_ptr(), sc32.data_ptr(), g.data_ptr(),
            thr.data_ptr(), n, m, thr.shape[0], nb, w, p0, count,
            panels.data_ptr(), upper.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_launch(rc, SYMPANEL_CHUNK_KERNEL)
    if count:
        launch_counts[SYMPANEL_CHUNK_KERNEL] += 1
    index = _panel_index(nb, coords.device, p0, count)
    return sympanel_scatter(panels, index, nb, n), upper


def count_batches(thr):
    """The count kernel's launches over thresholds ``thr``: (t0, the
    thresholds t0 .. t0 + COUNT_MAX_T - 1 ascending, their places in that
    slice as int32), sorted on their device (no host read). A launch adds
    the count of its t-th threshold at ``counts[t0 + order[t]]``."""
    for t0 in range(0, thr.shape[0], COUNT_MAX_T):
        part, order = torch.sort(thr[t0:t0 + COUNT_MAX_T])
        yield t0, part, order.to(torch.int32)


def count_le_cuda(rows_coords, cols_coords, thresholds):
    """int64 counts (T,) of ``||r_i - c_j||^2 <= t`` over all pairs of rows
    and columns, for each threshold t.

    Counterpart of ``svgdcpp_tpu.ops.pallas_phi.count_le_pallas`` (K16).
    Both sets are centered on the column mean and the thresholds compared
    in float32. One set passed as both (the same tensor, as the
    single-device median passes it) takes the self form, the upper
    triangle of tile pairs (2U + diag); anything else, a clone included,
    the cross form. On CUDA tensors: the kernel count_le_cross at any m
    (differences up to m = 4, the FP32 Gram identity above, with the
    dimensions in slices past MAX_M), one launch per COUNT_MAX_T
    thresholds, each launch's thresholds sorted on the device. On CPU
    tensors: the plain pass ``ops/median.count_le_plain``."""
    if rows_coords.device.type == "cpu":
        return count_le_plain(rows_coords, cols_coords, thresholds)
    _require_cuda(rows_coords)
    if (rows_coords.ndim != 2 or cols_coords.ndim != 2
            or rows_coords.shape[1] != cols_coords.shape[1]):
        raise ValueError(
            f"rows and columns must be (n_r, m) and (n_c, m); got "
            f"{tuple(rows_coords.shape)} and {tuple(cols_coords.shape)}"
        )
    if rows_coords.shape[1] < 1:
        raise ValueError("the count kernel takes m >= 1 dimensions, got m=0")
    device = rows_coords.device
    if cols_coords.device != device:
        raise ValueError("rows and columns must share one device")
    thr = torch.as_tensor(thresholds, device=device).reshape(-1).to(
        torch.float32
    )
    counts = torch.zeros(thr.shape[0], dtype=torch.int64, device=device)
    n_r, m = rows_coords.shape
    n_c = cols_coords.shape[0]
    if n_r == 0 or n_c == 0 or thr.shape[0] == 0:
        return counts
    cols32 = cols_coords.to(torch.float32)
    center = cols32.mean(dim=0)
    cols_c = (cols32 - center).contiguous()
    same = rows_coords is cols_coords
    rows_c = cols_c if same else (
        rows_coords.to(torch.float32) - center).contiguous()
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for t0, part, order in count_batches(thr):
            out = counts[t0:t0 + COUNT_MAX_T]
            if same:
                rc = lib.svgd_count_le_self(
                    cols_c.data_ptr(), part.data_ptr(), order.data_ptr(),
                    n_c, m, part.shape[0], out.data_ptr(), stream,
                )
            else:
                rc = lib.svgd_count_le_cross(
                    rows_c.data_ptr(), cols_c.data_ptr(), part.data_ptr(),
                    order.data_ptr(), n_r, n_c, m, part.shape[0],
                    out.data_ptr(), stream,
                )
            _check_launch(rc, COUNT_KERNEL)
            launch_counts[COUNT_KERNEL] += 1
    return counts
