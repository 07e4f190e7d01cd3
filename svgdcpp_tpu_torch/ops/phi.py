"""Stein variational gradient phi_hat, plain torch sweeps.

    phi(x_i) = (1/n) sum_j [ k(x_j, x_i) grad_{x_j} log p(x_j)
                             + grad_{x_j} k(x_j, x_i) ]

Port of ``svgdcpp_tpu.ops.phi`` (reference hot loop SVGD.hpp:407-454):

  * ``phi_generic``     -- any kernel function, by torch.func: per target,
                           one VJP of the kernel row over the sources with a
                           ones cotangent sums grad_{x_j} k (the reference's
                           (m n) x n stack and indexer, SVGD.hpp:453),
                           streamed over row tiles of targets.
  * ``phi_rbf``         -- dense: K = exp(-quad), then
                           phi = (K S - (K X - rowsum(K) X)(P+P^T)) / n.
  * ``phi_rbf_blocked`` -- the same, streamed over row tiles so the n x n
                           kernel matrix never exists whole.
  * ``phi_rbf_terms``   -- a composed kernel flattened to signed RBF terms
                           (kernels/algebra.py): the signed sum of each
                           term's streamed phi.
  * ``phi_rbf_terms_cross_fused_counts`` and its wrappers -- ONE sweep
                           giving phi and the median-selection counts. This
                           is the plain version of the CUDA kernels in
                           ``ops/cuda_phi.py``, which hold themselves to it.
  * ``phi_rbf_aniso_terms_fused_counts`` -- the same for a composed kernel
                           with anisotropic (full-P) terms; at every m
                           but 1-8 and 11 the wide term groups' slabs,
                           ``aniso_groups_plain``, and their epilogue,
                           ``aniso_groups_finish``.
  * ``phi_rbf_eigen`` / ``phi_rbf_gram`` -- one RBF with a full, fixed P:
                           the fixed-P CUDA kernel's forms at m = 1-8 and
                           11 (the eigen basis) and at every other m (P
                           itself, the Gram operands of ``gram_operands``).
  * ``phi_rbf_sympanel_fused_counts`` / ``phi_rbf_terms_sympanel_fused_counts``
                        -- the same function as the fused sweeps, computed
                           on the panel kernels' schedule (super-block pairs,
                           their windows and ``sympanel_epilogue``): the
                           plain versions of the CUDA panel kernels.
  * ``phi_rbf_sym_chunk_counts`` / ``phi_rbf_terms_sym_chunk_counts`` /
    ``phi_rbf_sympanel_chunk_counts``
                        -- one rank's chunk of the triangle or of the panel
                           list, returning the raw accumulator and upper
                           counts that the sharded engine sums over the
                           ranks and finishes (``sym_finish``): the plain
                           versions of the CUDA chunk kernels.
  * ``dot_dtype='bfloat16'`` -- the JAX package's operand opt-in, on the
                           single-RBF sweeps (``phi_rbf_fused_counts``,
                           ``phi_rbf_cross_fused_counts``,
                           ``phi_rbf_sym_fused_counts``, the panel
                           schedules) and ``phi_rbf_gram``: the plain
                           versions of the kernels' bf16 instances, rounding
                           where the JAX kernels round (``round_bf16``).

Index convention: K[i, j] = k(x_j, x_i), row i is the target particle.
"""

from __future__ import annotations

import math

from typing import Callable, Tuple

import torch
from torch.func import grad, vjp, vmap

from .pairwise import auto_row_tile, sq_matmul, weighted_quadratic_pairwise
from .sym_plan import (
    DIFF_FORM_MAX_M,
    card_panel_plan,
    panel_chunk,
    panel_pairs,
    panel_tile128,
    sym_tile,
    sym_tile_chunk,
    upper_tile_rows,
)


# ----------------------------------------------------------------------
# The bfloat16 operand opt-in
# ----------------------------------------------------------------------

#: log2(e), by which the JAX kernels scale gamma (``_LOG2E``).
LOG2E = 1.4426950408889634

#: The operand dtypes of the fused kernel sweeps (the JAX package's
#: ``dot_dtype`` and ``SVGDOptions.fused_dot_dtype``).
DOT_DTYPES = ("float32", "bfloat16")


def dot_bf16(dot_dtype) -> bool:
    """Whether ``dot_dtype`` asks for the bfloat16 operand opt-in:
    'float32' or 'bfloat16'; any other value raises ValueError."""
    if not isinstance(dot_dtype, str) or dot_dtype not in DOT_DTYPES:
        raise ValueError(
            f"dot_dtype must be one of {DOT_DTYPES}, got {dot_dtype!r}"
        )
    return dot_dtype == "bfloat16"


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest, ties to even) through float32,
    as the JAX kernels round their float32 operands (``astype``), returned
    in t's dtype. Under the opt-in the sweeps round their Gram operands,
    their pair weights and the contractions' records [S | X | 1]; the
    squared norms and the epilogue's x_i stay unrounded
    (pallas_phi.py:409-433, :379, :707)."""
    return t.to(torch.float32).to(torch.bfloat16).to(t.dtype)


def _rounding(bf16: bool):
    return round_bf16 if bf16 else (lambda t: t)


# ----------------------------------------------------------------------
# Generic path: any kernel_fn(x, params, location)
# ----------------------------------------------------------------------


def phi_generic_cross(
    targets: torch.Tensor,
    sources: torch.Tensor,
    source_scores: torch.Tensor,
    kernel_fn: Callable,
    kernel_params,
    row_tile: int = 128,
) -> torch.Tensor:
    """Tile-streamed phi for an arbitrary composed or user kernel:

    phi_i = (1/n_src) sum_j [ k(s_j, t_i) score_j + grad_{s_j} k(s_j, t_i) ]

    Per target, the kernel row over the sources and one VJP of it with a
    ones cotangent (rows grad_{s_j} k, summed); targets go through in row
    tiles, so the live intermediate is (row_tile, n_src, m), never the
    (n, n, m) stack. ``row_tile`` is clamped to the JAX package's budget
    (``auto_row_tile`` with 4 m bytes a pair). The cross form (local rows
    against the gathered sources) is the sharded engine's generic phi; the
    division is by the number of sources.
    """
    n_t, m = targets.shape
    n_s = sources.shape[0]
    row_tile = auto_row_tile(n_s, row_tile, elem_bytes=4 * m)

    def per_target(x_i):
        def k_all(srcs):
            return vmap(lambda x_j: kernel_fn(x_j, kernel_params, x_i))(srcs)

        k_row, k_vjp = vjp(k_all, sources)
        (grad_rows,) = k_vjp(torch.ones_like(k_row))
        return k_row @ source_scores + torch.sum(grad_rows, dim=0)

    per_tile = vmap(per_target)
    out = [per_tile(targets[start:start + row_tile])
           for start in range(0, n_t, row_tile)]
    return torch.cat(out, dim=0) / n_s


def phi_generic(
    coords: torch.Tensor,
    scores: torch.Tensor,
    kernel_fn: Callable,
    kernel_params,
    row_tile: int = 128,
) -> torch.Tensor:
    """phi for an arbitrary composed or user kernel (tile-streamed);
    coords and scores are (n, m)."""
    return phi_generic_cross(
        coords, coords, scores, kernel_fn, kernel_params, row_tile
    )


def kernel_matrix_and_grad(
    coords: torch.Tensor, kernel_fn: Callable, kernel_params
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full K (n, n) and grad stack G (n, n, m) for the debug dump:
    K[i, j] = k(x_j, x_i), G[i, j] = grad_{x_j} k(x_j, x_i), the
    reference's kernel_matrix_ / kernel_grad_matrix_ pair (SVGD.hpp:500-502)
    in (n, m) layout. Only the intermediate-matrix logging builds them."""
    return kernel_matrix_and_grad_cross(coords, coords, kernel_fn,
                                        kernel_params)


def kernel_matrix_and_grad_cross(
    targets: torch.Tensor,
    sources: torch.Tensor,
    kernel_fn: Callable,
    kernel_params,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The target-row band K (n_t, n_s) / G (n_t, n_s, m) of the debug
    matrices: the sharded engine's rows against the gathered sources."""

    def pair(x_j, x_i):
        return kernel_fn(x_j, kernel_params, x_i)

    k = vmap(lambda xi: vmap(lambda xj: pair(xj, xi))(sources))(targets)
    g = vmap(lambda xi: vmap(lambda xj: grad(pair)(xj, xi))(sources))(targets)
    return k, g


# ----------------------------------------------------------------------
# Gaussian-RBF closed form: dense path
# ----------------------------------------------------------------------


def rbf_kernel_matrix(
    coords: torch.Tensor, p_matrix: torch.Tensor, psd: bool = True
) -> torch.Tensor:
    """K[i, j] = exp(-(x_j - x_i)^T P (x_j - x_i)) via the Gram identity;
    ``psd=False`` skips the clamp-at-zero noise guard (indefinite P)."""
    return torch.exp(-weighted_quadratic_pairwise(coords, p_matrix, psd=psd))


def phi_rbf(
    coords: torch.Tensor,
    scores: torch.Tensor,
    p_matrix: torch.Tensor,
    psd: bool = True,
) -> torch.Tensor:
    """Closed-form RBF phi: phi = (K S - (K X - rowsum(K) * X)(P + P^T)) / n."""
    n = coords.shape[0]
    k = rbf_kernel_matrix(coords, p_matrix, psd=psd)
    p_sym = p_matrix + p_matrix.T
    ks = k @ scores
    kx = k @ coords
    rowsum = torch.sum(k, dim=1)
    return (ks - (kx - rowsum[:, None] * coords) @ p_sym) / n


# ----------------------------------------------------------------------
# Gaussian-RBF closed form: tile-streamed (no n x n materialization)
# ----------------------------------------------------------------------


def phi_rbf_cross(
    targets: torch.Tensor,
    sources: torch.Tensor,
    source_scores: torch.Tensor,
    p_matrix: torch.Tensor,
    row_tile: int = 1024,
    psd: bool = True,
) -> torch.Tensor:
    """Streaming RBF phi for ``targets`` rows against ``sources``:

    phi_i = (1/n_src) sum_j [ k(s_j, t_i) score_j + grad_{s_j} k(s_j, t_i) ]

    Memory O(row_tile * n_src). Both sets are centered on the source mean
    (phi is translation-invariant; centering protects the Gram branch from
    float32 cancellation off origin). For m <= 4 the quadratic form and
    the summed kernel gradient come from explicit differences.
    """
    center = sources.mean(dim=0)
    targets = targets - center
    sources = sources - center

    n_t, m = targets.shape
    n_s = sources.shape[0]
    row_tile = auto_row_tile(n_s, row_tile)
    p_sym = p_matrix + p_matrix.T
    out = []

    if m <= DIFF_FORM_MAX_M:
        for start in range(0, n_t, row_tile):
            rows = targets[start : start + row_tile]
            diffs = [rows[:, a, None] - sources[None, :, a] for a in range(m)]
            quad = torch.zeros(
                (rows.shape[0], n_s), dtype=rows.dtype, device=rows.device
            )
            for a in range(m):
                for bb in range(a, m):
                    w = p_sym[a, bb] if a != bb else p_matrix[a, a]
                    quad = quad + w * diffs[a] * diffs[bb]
            if psd:
                quad = torch.clamp_min(quad, 0.0)
            k_tile = torch.exp(-quad)
            ks = k_tile @ source_scores
            # sum_j grad_{x_j} k = (P+P^T) sum_j K (x_i - x_j) per target i
            t_vec = torch.stack(
                [torch.sum(k_tile * diffs[a], dim=1) for a in range(m)], dim=1
            )
            out.append(ks + t_vec @ p_sym)
        return torch.cat(out, dim=0) / n_s

    q_src = torch.sum((sources @ p_matrix) * sources, dim=1)  # (n_s,)
    q_tgt = torch.sum((targets @ p_matrix) * targets, dim=1)  # (n_t,)
    src_ps = sources @ p_sym  # (n_s, m): rows s_j^T (P+P^T)
    b = torch.cat(
        [source_scores, sources,
         torch.ones((n_s, 1), dtype=sources.dtype, device=sources.device)],
        dim=1,
    )  # (n_s, 2m+1)
    for start in range(0, n_t, row_tile):
        rows = targets[start : start + row_tile]
        cross = sq_matmul(rows, src_ps.T)
        quad = q_tgt[start : start + row_tile, None] + q_src[None, :] - cross
        if psd:
            quad = torch.clamp_min(quad, 0.0)
        out.append(torch.exp(-quad) @ b)
    a = torch.cat(out, dim=0)
    ks = a[:, :m]
    kx = a[:, m : 2 * m]
    rowsum = a[:, 2 * m]
    return (ks - (kx - rowsum[:, None] * targets) @ p_sym) / n_s


def phi_rbf_blocked(
    coords: torch.Tensor,
    scores: torch.Tensor,
    p_matrix: torch.Tensor,
    row_tile: int = 1024,
    psd: bool = True,
) -> torch.Tensor:
    """Tile-streamed single-set RBF phi (see phi_rbf_cross)."""
    return phi_rbf_cross(coords, coords, scores, p_matrix, row_tile, psd=psd)


# ----------------------------------------------------------------------
# Composed kernels: signed sum of closed-form RBF terms
# ----------------------------------------------------------------------


def phi_rbf_terms_cross(
    targets: torch.Tensor,
    sources: torch.Tensor,
    source_scores: torch.Tensor,
    kernel_params,
    terms,
    row_tile: int = 1024,
    psd_flags=None,
) -> torch.Tensor:
    """phi for a composed kernel flattened to signed RBF terms
    (kernels/algebra.flatten_rbf_terms): phi is linear in k, so it is the
    signed sum of each term's closed-form RBF phi, with the term's
    effective P. ``psd_flags`` (kernels/algebra.term_psd_flags) controls
    each term's clamp of the quadratic form at zero; without it the
    positional term_is_psd rule is used."""
    from ..kernels.algebra import term_is_psd, term_precision

    if psd_flags is None:
        psd_flags = [term_is_psd(t) for t in terms]
    elif len(psd_flags) != len(terms):
        raise ValueError(
            f"psd_flags has {len(psd_flags)} entries for {len(terms)} terms"
        )
    phi = None
    for (sign, plist), t_psd in zip(terms, psd_flags):
        p = term_precision(plist, kernel_params)
        t_phi = phi_rbf_cross(
            targets, sources, source_scores, p, row_tile, psd=t_psd
        )
        t_phi = t_phi if sign > 0 else -t_phi
        phi = t_phi if phi is None else phi + t_phi
    return phi


def phi_rbf_terms(
    coords: torch.Tensor,
    scores: torch.Tensor,
    kernel_params,
    terms,
    row_tile: int = 1024,
    psd_flags=None,
) -> torch.Tensor:
    """Single-set composed-RBF phi (see phi_rbf_terms_cross)."""
    return phi_rbf_terms_cross(
        coords, coords, scores, kernel_params, terms, row_tile,
        psd_flags=psd_flags,
    )


# ----------------------------------------------------------------------
# Fused phi + median-selection counts
# ----------------------------------------------------------------------


def phi_rbf_terms_cross_fused_counts(
    targets: torch.Tensor,
    sources: torch.Tensor,
    source_scores: torch.Tensor,
    gammas,
    signs,
    thresholds_sq: torch.Tensor,
    row_tile: int = 1024,
    dot_dtype: str = "float32",
):
    """ONE O(n_t * n_s) sweep: phi of a signed sum of ISOTROPIC RBF terms
    AND the median-selection threshold counts, in cross form.

    The single implementation behind the fused entry points (the wrappers
    below). Term t's quadratic form is gamma_t * sq, so every term shares
    one squared-distance tile. Counts are int64, cumulative (sq <= edge)
    over all n_t x n_s pairs, self-zeros included (reference
    GaussianRBFKernel.hpp:66). Thresholds are taken in the targets' dtype.

    For m <= 4 the tile is built from explicit differences, summed from
    the first coordinate up, each product and sum rounded on its own: the
    CUDA kernels compute sq in the same order with the same roundings, so
    their counts equal these exactly. For a single positive term,
    phi = K S + 2 gamma sum_j K (x_i - x_j); for T terms the tile combines

        k_c = sum_t sign_t exp(-gamma_t sq)            (for K S)
        w   = sum_t sign_t gamma_t exp(-gamma_t sq)    (for the grad part)

    With no term at all, phi is zero and the sweep gives the counts alone.

    ``dot_dtype='bfloat16'`` (one positive term only, as the JAX kernels
    take it): the Gram form at every m, its operands, the weights and the
    record [S | X | 1] rounded to bf16 (:func:`round_bf16`), the norms and
    the epilogue's targets unrounded: the plain version of K1's bf16
    instance.

    Returns (phi (n_t, m) normalized by n_s, counts (E,) int64).
    """
    bf16 = dot_bf16(dot_dtype)
    center = sources.mean(dim=0)
    targets = targets - center
    sources = sources - center

    n_t, m = targets.shape
    n_s = sources.shape[0]
    dtype, device = targets.dtype, targets.device
    row_tile = auto_row_tile(n_s, row_tile)
    gammas = [torch.as_tensor(g, dtype=dtype, device=device) for g in gammas]
    signs = [float(s) for s in signs]
    thresholds_sq = torch.as_tensor(thresholds_sq, dtype=dtype, device=device)
    single = len(gammas) == 1 and signs[0] == 1.0
    if bf16 and not single:
        raise ValueError(
            "dot_dtype='bfloat16' takes one positive RBF term (as the JAX "
            f"package's fused kernels), got signs {signs}"
        )
    rnd = _rounding(bf16)
    counts = torch.zeros(thresholds_sq.shape[0], dtype=torch.int64, device=device)
    ones = torch.ones((n_s, 1), dtype=dtype, device=device)

    def tile_counts(sq):
        return torch.sum(
            sq[None, :, :] <= thresholds_sq[:, None, None], dim=(1, 2)
        )

    def combine(sq):
        k_c = None
        w = None
        for s, g in zip(signs, gammas):
            k_t = torch.exp(-g * sq)
            k_term = s * k_t
            w_term = (s * g) * k_t
            k_c = k_term if k_c is None else k_c + k_term
            w = w_term if w is None else w + w_term
        if k_c is None:  # no term
            k_c = w = torch.zeros_like(sq)
        return k_c, w

    out = []
    if m <= DIFF_FORM_MAX_M and not bf16:
        for start in range(0, n_t, row_tile):
            rows = targets[start : start + row_tile]
            diffs = [rows[:, a, None] - sources[None, :, a] for a in range(m)]
            sq = torch.zeros((rows.shape[0], n_s), dtype=dtype, device=device)
            for a in range(m):
                sq = sq + diffs[a] * diffs[a]
            if single:
                k_tile = torch.exp(-gammas[0] * sq)
                ks = k_tile @ source_scores
                t_vec = torch.stack(
                    [torch.sum(k_tile * diffs[a], dim=1) for a in range(m)],
                    dim=1,
                )
                out.append(ks + 2.0 * gammas[0] * t_vec)
            else:
                k_c, w = combine(sq)
                ks = k_c @ source_scores
                t_vec = torch.stack(
                    [torch.sum(w * diffs[a], dim=1) for a in range(m)], dim=1
                )
                out.append(ks + 2.0 * t_vec)
            counts += tile_counts(sq)
        return torch.cat(out, dim=0) / n_s, counts

    q_src = torch.sum(sources * sources, dim=1)
    q_tgt = torch.sum(targets * targets, dim=1)
    src_g = rnd(sources)
    if single:
        b = rnd(torch.cat([source_scores, sources, ones], dim=1))
    else:
        xs1 = torch.cat([sources, ones], dim=1)
    for start in range(0, n_t, row_tile):
        rows = targets[start : start + row_tile]
        gram = sq_matmul(rnd(rows), src_g.T)
        sq = torch.clamp_min(
            q_tgt[start : start + row_tile, None] + q_src[None, :] - 2.0 * gram,
            0.0,
        )
        if bf16:
            # The JAX kernel's own weight, exp2(-gamma log2(e) sq), whose
            # last bits decide the bf16 rounding of k.
            out.append(rnd(torch.exp2(-(gammas[0] * LOG2E) * sq)) @ b)
        elif single:
            out.append(torch.exp(-gammas[0] * sq) @ b)
        else:
            k_c, w = combine(sq)
            out.append(torch.cat([k_c @ source_scores, w @ xs1], dim=1))
        counts += tile_counts(sq)
    a = torch.cat(out, dim=0)
    ks = a[:, :m]
    mid = a[:, m : 2 * m]
    last = a[:, 2 * m]
    if single:
        phi = (ks - 2.0 * gammas[0] * (mid - last[:, None] * targets)) / n_s
    else:
        # mid/last already carry the gamma weights (w = sum sign*gamma*k).
        phi = (ks - 2.0 * (mid - last[:, None] * targets)) / n_s
    return phi, counts


def phi_rbf_cross_fused_counts(
    targets: torch.Tensor,
    sources: torch.Tensor,
    source_scores: torch.Tensor,
    gamma,
    thresholds_sq: torch.Tensor,
    row_tile: int = 1024,
    dot_dtype: str = "float32",
):
    """Single-term cross fused sweep (see phi_rbf_terms_cross_fused_counts)."""
    return phi_rbf_terms_cross_fused_counts(
        targets, sources, source_scores, [gamma], [1], thresholds_sq, row_tile,
        dot_dtype,
    )


def phi_rbf_terms_fused_counts(
    coords: torch.Tensor,
    scores: torch.Tensor,
    gammas,
    signs,
    thresholds_sq: torch.Tensor,
    row_tile: int = 1024,
):
    """Single-set multi-term fused sweep (see the cross form)."""
    return phi_rbf_terms_cross_fused_counts(
        coords, coords, scores, gammas, signs, thresholds_sq, row_tile
    )


def phi_rbf_fused_counts(
    coords: torch.Tensor,
    scores: torch.Tensor,
    gamma,
    thresholds_sq: torch.Tensor,
    row_tile: int = 1024,
    dot_dtype: str = "float32",
):
    """Single-set single-term fused sweep: ONE O(n^2) pass giving the RBF
    phi (P = gamma I) and the median-selection counts, the main path's
    plain sweep (see phi_rbf_terms_cross_fused_counts); under
    ``dot_dtype='bfloat16'`` the square form of K1's bf16 instance (no self
    pair pinned)."""
    return phi_rbf_terms_cross_fused_counts(
        coords, coords, scores, [gamma], [1], thresholds_sq, row_tile,
        dot_dtype,
    )


def phi_rbf_sym_fused_counts(coords, scores, gamma, thresholds_sq,
                             dot_dtype: str = "float32"):
    """One RBF's full-width triangle sweep over one particle set in plain
    torch, the plain version of K2 (``fused_phi_counts_sym``) and of its
    bf16 instance: every unordered pair once, both directions, the self
    pairs pinned to sq = 0 past the difference form and taken out once by
    :func:`sym_finish`, counts 2U - n; the single-rank chunk
    (:func:`phi_rbf_terms_sym_chunk_counts`) finished. In float32 it is
    the function of :func:`phi_rbf_fused_counts`; under bf16 the self
    pair's rounded records stay, as in the JAX triangle's epilogue
    (pallas_phi.py:701-708). Returns (phi (n, m), counts (E,) int64)."""
    n = coords.shape[0]
    acc, upper = phi_rbf_terms_sym_chunk_counts(
        coords, scores, [gamma], [1.0], thresholds_sq, 1, 0, single=True,
        dot_dtype=dot_dtype,
    )
    phi = phi_rbf_fused_sym_finish(acc, scores.to(acc.dtype), gamma, n)
    return phi, 2 * upper - n


def _pair_weights(gammas, signs, single, dtype, device, bf16=False):
    """sq -> (k_c, w): the pair weights of KS and D. One RBF (``single``):
    k = exp(-gamma sq) for both (the epilogue multiplies D by gamma; under
    ``bf16`` the JAX kernel's exp2(-gamma log2(e) sq), rounded by the
    caller); a composed kernel: k_c = sum s exp(-gamma sq),
    w = sum s gamma exp(-gamma sq)."""
    gammas = [torch.as_tensor(g, dtype=dtype, device=device) for g in gammas]
    signs = [float(s) for s in signs]
    if bf16 and not single:
        raise ValueError(
            "dot_dtype='bfloat16' takes one positive RBF term (as the JAX "
            f"package's fused kernels), got signs {signs}"
        )

    def weights(sq):
        if bf16:
            k = torch.exp2(-(gammas[0] * LOG2E) * sq)
            return k, k
        if single:
            k = torch.exp(-gammas[0] * sq)
            return k, k
        k_c = w_ = torch.zeros_like(sq)
        for s, g in zip(signs, gammas):
            k_t = torch.exp(-g * sq)
            k_c = k_c + s * k_t
            w_ = w_ + (s * g) * k_t
        return k_c, w_

    return weights


def _pair_block(coords_c, scores, q, r0, r1, c0, c1, diag, weights, thr,
                bf16=False):
    """Both directions of the pairs (i, j), i in [r0, r1), j in [c0, c1); on
    a ``diag`` block only j >= i, the self pairs included: (KS_row (r, m),
    D_row (r, m), KS_col (c, m), D_col (c, m), hits (E,) int64), as the
    triangle kernels accumulate them. Row i gains k_c s_j and w (x_i - x_j),
    column j gains k_c s_i and w (x_j - x_i); hits counts the pairs kept at
    or below each threshold. sq comes from differences up to
    DIFF_FORM_MAX_M, as in phi_rbf_terms_cross_fused_counts, else from the
    Gram identity on the squared norms ``q`` with the self pairs pinned to
    0. ``bf16`` (the opt-in): the Gram form at every m, its operands, the
    weights and the records s and x of the contractions rounded
    (:func:`round_bf16`), D's own x unrounded."""
    m = coords_c.shape[1]
    dtype, device = coords_c.dtype, coords_c.device
    rnd = _rounding(bf16)
    xr, sr = coords_c[r0:r1], scores[r0:r1]
    xc, sc = coords_c[c0:c1], scores[c0:c1]
    keep = None
    if diag:
        gi = torch.arange(r0, r1, device=device)[:, None]
        gj = torch.arange(c0, c1, device=device)[None, :]
        keep = gj >= gi
    diff_form = m <= DIFF_FORM_MAX_M and not bf16
    if diff_form:
        diffs = [xr[:, a, None] - xc[None, :, a] for a in range(m)]
        sq = torch.zeros((r1 - r0, c1 - c0), dtype=dtype, device=device)
        for a in range(m):
            sq = sq + diffs[a] * diffs[a]
    else:
        sq = torch.clamp_min(
            q[r0:r1, None] + q[None, c0:c1]
            - 2.0 * sq_matmul(rnd(xr), rnd(xc).T), 0.0,
        )
        if keep is not None:
            sq = torch.where(gj == gi, torch.zeros_like(sq), sq)
    k_c, w_ = (rnd(v) for v in weights(sq))
    if keep is not None:
        k_c = torch.where(keep, k_c, torch.zeros_like(k_c))
        w_ = torch.where(keep, w_, torch.zeros_like(w_))
        hits = torch.sum(
            (sq[None, :, :] <= thr[:, None, None]) & keep[None], dim=(1, 2)
        )
    else:
        hits = torch.sum(sq[None, :, :] <= thr[:, None, None], dim=(1, 2))
    if diff_form:
        d_row = torch.stack(
            [torch.sum(w_ * diffs[a], dim=1) for a in range(m)], dim=1
        )
        d_col = -torch.stack(
            [torch.sum(w_ * diffs[a], dim=0) for a in range(m)], dim=1
        )
    else:
        d_row = torch.sum(w_, dim=1)[:, None] * xr - w_ @ rnd(xc)
        d_col = torch.sum(w_, dim=0)[:, None] * xc - w_.T @ rnd(xr)
    return k_c @ rnd(sc), d_row, k_c.T @ rnd(sr), d_col, hits


def _sympanel_halves(coords_c, scores, gammas, signs, thresholds_sq, nb, w,
                     single, row_tile, p0=0, count=None, bf16=False):
    """The panel windows of the triangle sweep, computed as the CUDA panel
    kernels lay them out: (panels (P, 2, 2m, W), upper (E,) int64).

    Panel p is the super-block pair (I, J) = panel_pairs(nb)[p0 + p]
    (I <= J) of width W, for the ``count`` panels from ``p0`` (all of them
    by default). Half 0 holds, for each row i of super-block I, KS_i and
    D_i over the columns j of super-block J; half 1 the same for each
    column j over the rows i (pair (i, j) adds k s_i and w (x_j - x_i) to
    j). A diagonal panel (I == J) keeps the pairs j >= i, its self pairs in
    both halves. ``upper`` counts the kept pairs at or below each
    threshold. D is weighted by w = sum s gamma k for a composed kernel and
    by k alone for one RBF (``single``; the epilogue multiplies by gamma);
    the pairs are ``_pair_block``'s (``bf16``: the opt-in's roundings)."""
    n, m = coords_c.shape
    dtype, device = coords_c.dtype, coords_c.device
    thr = torch.as_tensor(thresholds_sq, dtype=dtype, device=device)
    pairs = panel_pairs(nb)
    pairs = pairs[p0:] if count is None else pairs[p0:p0 + count]
    panels = torch.zeros((len(pairs), 2, 2 * m, w), dtype=dtype, device=device)
    upper = torch.zeros(thr.shape[0], dtype=torch.int64, device=device)
    q = torch.sum(coords_c * coords_c, dim=1)
    row_tile = auto_row_tile(w, row_tile)
    weights = _pair_weights(gammas, signs, single, dtype, device, bf16)

    for p, (bi, bj) in enumerate(pairs):
        c0, c_end = bj * w, min(bj * w + w, n)
        for r0 in range(bi * w, min(bi * w + w, n), row_tile):
            r1 = min(r0 + row_tile, bi * w + w, n)
            # On a diagonal panel, the columns before the tile's first row
            # hold no pair j >= i.
            cs = max(c0, r0) if bi == bj else c0
            if cs >= c_end:
                continue
            ks_row, d_row, ks_col, d_col, hits = _pair_block(
                coords_c, scores, q, r0, r1, cs, c_end, bi == bj, weights,
                thr, bf16,
            )
            upper += hits
            li, lj = r0 - bi * w, cs - c0
            panels[p, 0, :m, li:li + r1 - r0] = ks_row.T
            panels[p, 0, m:, li:li + r1 - r0] = d_row.T
            panels[p, 1, :m, lj:lj + c_end - cs] += ks_col.T
            panels[p, 1, m:, lj:lj + c_end - cs] += d_col.T
    return panels, upper


def panel_index(nb: int, device, p0: int = 0, count=None):
    """(I, J) of each panel, in panel_pairs order, as int64 tensors: all of
    them, or the ``count`` from ``p0``."""
    pairs = panel_pairs(nb)
    pairs = pairs[p0:] if count is None else pairs[p0:p0 + count]
    return (torch.tensor([p[0] for p in pairs], dtype=torch.int64,
                         device=device),
            torch.tensor([p[1] for p in pairs], dtype=torch.int64,
                         device=device))


def sympanel_scatter(panels, index, nb: int, n: int):
    """The (2m, n) triangle accumulator [KS | D] of panel windows:
    scatter-adds each window's half 0 at super-block I and half 1 at J
    (``index`` = panel_index of the windows' panels, on their device). A
    rank's chunk of the panel list gives its share of the accumulator, to
    be summed over the ranks before the finish."""
    rows, w = panels.shape[2], panels.shape[3]
    acc = torch.zeros((rows, nb, w), dtype=panels.dtype, device=panels.device)
    acc.index_add_(1, index[0], panels[:, 0].transpose(0, 1))
    acc.index_add_(1, index[1], panels[:, 1].transpose(0, 1))
    return acc.reshape(rows, nb * w)[:, :n]


def sym_finish(acc, scores, n: int, s_total, d_scale):
    """phi (n_band, m) of a band of the summed triangle accumulator ``acc``
    (2m, n_band) = [KS | D], the full-width triangle's epilogue: the self
    pairs entered KS in both directions (k = the sum of the signs), so
    subtract ``s_total`` s_i once; their D is 0; phi = (KS + d_scale D) / n
    for the global count n. The self-pair correction runs once, on the
    accumulator summed over every rank's chunk."""
    m = acc.shape[0] // 2
    a = acc.T
    return (a[:, :m] - s_total * scores + d_scale * a[:, m:]) / n


def phi_rbf_fused_sym_finish(acc_band, scores_band, gamma, n: int):
    """One RBF's band finish (the counterpart of the JAX package's
    ``phi_rbf_fused_sym_finish``): D is weighted by k, so d_scale = 2
    gamma."""
    gamma = torch.as_tensor(gamma, dtype=acc_band.dtype,
                            device=acc_band.device)
    return sym_finish(acc_band, scores_band, n, 1.0, 2.0 * gamma)


def phi_rbf_terms_fused_sym_finish(acc_band, scores_band, signs, n: int):
    """A composed kernel's band finish (the counterpart of the JAX
    package's ``phi_rbf_terms_fused_sym_finish`` and
    ``phi_rbf_terms_fused_sym_direct_finish``): D carries the weights
    w = sum s gamma k, so d_scale = 2."""
    return sym_finish(acc_band, scores_band, n,
                      sum(float(s) for s in signs), 2.0)


def bf16_d_term(a, coords):
    """D = rowsum x - KX (n, m) of a bf16 accumulator's transpose a = [KS |
    KX | rowsum] (n, 2m + 1), with the float32 x, as the JAX epilogue forms
    it (pallas_phi.py:636-640)."""
    m = coords.shape[1]
    return a[:, 2 * m:2 * m + 1] * coords - a[:, m:2 * m]


def bf16_sym_finish(acc, coords, scores, gamma, n: int):
    """phi (n, m) of the bf16 triangle kernels' accumulator (2m + 1, n) =
    [KS | KX | rowsum] (K2's and K3's bf16 instances, the panels' windows
    scattered): D by ``bf16_d_term``; each self pair entered KS in both
    directions, so s_i comes off once; phi = (KS - s + 2 gamma D) / n."""
    m = coords.shape[1]
    a = acc.T
    return (a[:, :m] - scores + 2.0 * gamma * bf16_d_term(a, coords)) / n


def sympanel_epilogue(panels, upper, index, n, scores, s_total, d_scale):
    """(phi (n, m), counts (E,) int64) from the panel windows of the whole
    panel list: ``sympanel_scatter`` onto the (2m, n) accumulator, then
    ``sym_finish``; counts = 2U - n. ``index`` is panel_index(nb) on the
    panels' device."""
    num_p = panels.shape[0]
    nb = (math.isqrt(8 * num_p + 1) - 1) // 2  # num_p = nb (nb + 1) / 2
    acc = sympanel_scatter(panels, index, nb, n)
    return sym_finish(acc, scores, n, s_total, d_scale), 2 * upper - n


def phi_rbf_terms_sym_chunk_counts(
    coords: torch.Tensor,
    scores: torch.Tensor,
    gammas,
    signs,
    thresholds_sq: torch.Tensor,
    world: int,
    rank: int,
    single: bool = False,
    dot_dtype: str = "float32",
):
    """One rank's chunk of the full-width triangle sweep, in plain torch: the
    plain version of the CUDA chunk kernels ``fused_phi_counts_sym_chunk``
    (``single``, one RBF: K4's port) and ``fused_phi_terms_sym_chunk``
    (K10/K11's port), the counterparts of the JAX package's
    ``phi_rbf_fused_pallas_sym_sharded`` and
    ``phi_rbf_terms_fused_pallas_sym_sharded(_direct)``.

    ``coords`` and ``scores`` are the GLOBAL set; the chunk is rank's range
    of the kernel's tile list (``sym_plan.sym_tile_chunk`` with the kernel's
    tile, ``sym_plan.sym_tile``), swept one tile row at a time. Returns the
    raw accumulator (2m, n) = [KS | D] and the upper counts (E,) int64
    (diagonal included), as the kernels do: summed over the ranks, they are
    the whole triangle's, which ``sym_finish`` and 2U - n finish. Centered
    on the coordinates' mean. ``dot_dtype='bfloat16'`` (one RBF): the
    opt-in's roundings (:func:`_pair_block`), the plain version of K2's
    bf16 instance at world 1."""
    bf16 = dot_bf16(dot_dtype)
    n, m = coords.shape
    dtype, device = coords.dtype, coords.device
    tile = sym_tile(m, terms=not single)
    t0, count = sym_tile_chunk(n, world, rank, tile)
    nb = -(-n // tile)
    coords_c = coords - coords.mean(dim=0)
    scores = scores.to(dtype)
    thr = torch.as_tensor(thresholds_sq, dtype=dtype, device=device)
    acc = torch.zeros((2 * m, n), dtype=dtype, device=device)
    upper = torch.zeros(thr.shape[0], dtype=torch.int64, device=device)
    q = torch.sum(coords_c * coords_c, dim=1)
    weights = _pair_weights(gammas, signs, single, dtype, device, bf16)
    for bi, bj_first, bj_last in upper_tile_rows(nb, t0, count):
        r0, r1 = bi * tile, min(bi * tile + tile, n)
        c0, c1 = bj_first * tile, min(bj_last * tile + tile, n)
        ks_row, d_row, ks_col, d_col, hits = _pair_block(
            coords_c, scores, q, r0, r1, c0, c1, bj_first == bi, weights, thr,
            bf16,
        )
        upper += hits
        acc[:m, r0:r1] += ks_row.T
        acc[m:, r0:r1] += d_row.T
        acc[:m, c0:c1] += ks_col.T
        acc[m:, c0:c1] += d_col.T
    return acc, upper


def phi_rbf_sym_chunk_counts(coords, scores, gamma, thresholds_sq, world,
                             rank):
    """One RBF's triangle chunk in plain torch, K4's plain version (see
    :func:`phi_rbf_terms_sym_chunk_counts`)."""
    return phi_rbf_terms_sym_chunk_counts(
        coords, scores, [gamma], [1.0], thresholds_sq, world, rank,
        single=True,
    )


def phi_rbf_sympanel_chunk_counts(coords, scores, gamma, thresholds_sq,
                                  world, rank, panel_blocks=None,
                                  row_tile: int = 1024,
                                  dot_dtype: str = "float32"):
    """One rank's chunk of one RBF's panel triangle sweep in plain torch:
    the plain version of the CUDA kernel ``fused_phi_counts_sympanel_chunk``
    (K5's port), the counterpart of the JAX package's
    ``phi_rbf_fused_pallas_sympanel_sharded``. ``coords`` and ``scores`` are
    the GLOBAL set, the chunk rank's range of the card's panel list
    (``sym_plan.panel_chunk`` of the kernel's plan, ``card_panel_plan(n,
    panel_blocks, panel_tile128(m))``: a rank sweeps the kernel's panels).
    Returns the chunk's windows scattered onto the raw (2m, n) accumulator
    (``sympanel_scatter``) and its upper counts (E,) int64; summed over the
    ranks they are the whole panel sweep's. Centered on the coordinates'
    mean. ``dot_dtype`` as in :func:`phi_rbf_sympanel_fused_counts`."""
    bf16 = dot_bf16(dot_dtype)
    n, m = coords.shape
    nb, w, _ = card_panel_plan(n, panel_blocks, panel_tile128(m))
    p0, count = panel_chunk(nb, world, rank)
    coords_c = coords - coords.mean(dim=0)
    scores = scores.to(coords.dtype)
    panels, upper = _sympanel_halves(
        coords_c, scores, [gamma], [1.0], thresholds_sq, nb, w, True,
        row_tile, p0, count, bf16,
    )
    index = panel_index(nb, coords.device, p0, count)
    return sympanel_scatter(panels, index, nb, n), upper


def phi_rbf_terms_sympanel_fused_counts(
    coords: torch.Tensor,
    scores: torch.Tensor,
    gammas,
    signs,
    thresholds_sq: torch.Tensor,
    panel_blocks=None,
    row_tile: int = 1024,
):
    """The panel schedule of the composed-kernel triangle sweep in plain
    torch: the plain version of the CUDA kernel ``fused_phi_terms_sympanel``
    (ops/cuda_phi.py), the counterpart of the JAX package's panel terms
    kernels (``_phi_rbf_terms_fused_pallas_sympanel_direct_impl`` and
    ``_phi_rbf_terms_fused_pallas_sympanel_impl``).

    The same function as :func:`phi_rbf_terms_fused_counts`: phi of
    ``sum_t signs[t] exp(-gammas[t] sq)`` and the counts over all n^2
    pairs, here from each panel's windows (``_sympanel_halves``) and the
    kernel path's epilogue (:func:`sympanel_epilogue`), on the kernel's
    plan (``sym_plan.card_panel_plan`` with ``panel_tile128(m)``;
    ``panel_blocks`` forces its super-block count). Centered on the
    coordinates' mean. Returns (phi (n, m), counts (E,) int64)."""
    n, m = coords.shape
    nb, w, _ = card_panel_plan(n, panel_blocks, panel_tile128(m))
    coords_c = coords - coords.mean(dim=0)
    scores = scores.to(coords.dtype)
    panels, upper = _sympanel_halves(
        coords_c, scores, gammas, signs, thresholds_sq, nb, w, False, row_tile
    )
    return sympanel_epilogue(
        panels, upper, panel_index(nb, coords.device), n, scores,
        sum(float(s) for s in signs), 2.0,
    )


def phi_rbf_sympanel_fused_counts(
    coords: torch.Tensor,
    scores: torch.Tensor,
    gamma,
    thresholds_sq: torch.Tensor,
    panel_blocks=None,
    row_tile: int = 1024,
    dot_dtype: str = "float32",
):
    """One RBF's panel triangle sweep in plain torch: the plain version of
    the CUDA kernel ``fused_phi_counts_sympanel`` (ops/cuda_phi.py), the
    counterpart of ``_phi_rbf_fused_pallas_sympanel_impl``. The same
    function as :func:`phi_rbf_fused_counts` in float32 (see
    :func:`phi_rbf_terms_sympanel_fused_counts`), and as
    :func:`phi_rbf_sym_fused_counts` under ``dot_dtype='bfloat16'``, the
    plain version of its bf16 instance (``fused_phi_counts_sympanel_bf16``);
    each on its kernel's plan (``card_panel_plan(..., tile128=True)`` for
    the bf16 instance and the float32 wide entries, ``panel_tile128``)."""
    bf16 = dot_bf16(dot_dtype)
    n, m = coords.shape
    nb, w, _ = card_panel_plan(n, panel_blocks, panel_tile128(m, bf16))
    coords_c = coords - coords.mean(dim=0)
    scores = scores.to(coords.dtype)
    panels, upper = _sympanel_halves(
        coords_c, scores, [gamma], [1.0], thresholds_sq, nb, w, True,
        row_tile, bf16=bf16,
    )
    gamma = torch.as_tensor(gamma, dtype=coords.dtype, device=coords.device)
    return sympanel_epilogue(
        panels, upper, panel_index(nb, coords.device), n, scores, 1.0,
        2.0 * gamma,
    )


def phi_rbf_aniso_terms_fused_counts(
    coords: torch.Tensor,
    scores: torch.Tensor,
    iso_gammas,
    iso_signs,
    aniso_ps,
    aniso_signs,
    thresholds_sq: torch.Tensor,
    row_tile: int = 1024,
    lowers=None,
):
    """phi of a composed kernel with ANISOTROPIC terms and the counts of the
    Euclidean pair distances: the plain version of the CUDA kernels of
    ``fused_phi_aniso_terms_sym`` (ops/cuda_phi.py), the counterpart of
    ``svgdcpp_tpu.ops.pallas_phi.phi_rbf_aniso_terms_fused_pallas``.

    The kernel is ``sum_iso s exp(-gamma sq) + sum_t s_t exp(-d^T P_t d)``.
    phi is linear in k, so it is the isotropic terms' fused sweep
    (:func:`phi_rbf_terms_fused_counts`, which also gives the counts with
    its squared distances) plus each anisotropic term's signed closed-form
    phi (:func:`phi_rbf_cross` with P_t, its form clamped at zero: the
    route's gate proves every term positive definite), or with ``lowers``
    (the factors L_t of P_t's symmetric half, ``ops/cuda_phi.
    cholesky_factors``; ``aniso_ps`` may then be None) by
    :func:`phi_rbf_factor`, the one-pass kernel's arithmetic. All stream
    over row tiles; float32 and float64 both run. Returns (phi (n, m),
    counts (E,) int64).
    """
    phi, counts = phi_rbf_terms_fused_counts(
        coords, scores, list(iso_gammas), list(iso_signs), thresholds_sq,
        row_tile,
    )
    for t, sign in enumerate(aniso_signs):
        if lowers is not None:
            term = phi_rbf_factor(coords, scores, lowers[t], row_tile)
        else:
            p = torch.as_tensor(aniso_ps[t], dtype=coords.dtype,
                                device=coords.device)
            term = phi_rbf_cross(coords, coords, scores, p, row_tile,
                                 psd=True)
        phi = phi + float(sign) * term
    return phi, counts


def aniso_groups_plain(coords, scores, iso_gammas, iso_signs, aniso_signs,
                       thresholds_sq, lowers):
    """What K14's term groups leave in each group's slab, in plain torch,
    at every m (the micro-tile groups at m = 1-8 and 11, the wide ones
    ``fused_phi_aniso_terms_wide`` elsewhere, whose slabs are these at the
    rows' padded width): (acc (1 + n_aniso, 2m, n), upper (E,) int64 or
    None).

    Each slab [KS_g | D_g] is the full-width triangle's raw accumulator
    (:func:`phi_rbf_terms_sym_chunk_counts` at world 1: every unordered
    pair once, both directions, the self pair at sq = 0) of one group in
    that group's convention. Group 0 sweeps the centered coordinates: with
    one isotropic term the single-RBF form (k = exp(-gamma sq) for KS and
    D, neither signed nor scaled by gamma), with more the terms form (k_c =
    sum s k, w = sum s gamma k), and with none it is not swept (zeros).
    Group 1 + t sweeps z_t = x_c L_t (formed in float64, rounded to the
    coordinates' dtype) with k = exp(-|z_i - z_j|^2), unsigned. ``upper``
    counts the Euclidean pairs of the upper triangle with its diagonal,
    group 0's alone; None with no isotropic term. ``lowers``: the factors
    L_t of P_t's symmetric half (``ops/cuda_phi.cholesky_factors``).
    :func:`aniso_groups_finish` turns the slabs into phi."""
    n, m = coords.shape
    dtype, device = coords.dtype, coords.device
    x = coords - coords.mean(dim=0)
    thr = torch.as_tensor(thresholds_sq, dtype=dtype, device=device)
    upper = None
    if len(iso_signs) == 1:
        slab0, upper = phi_rbf_terms_sym_chunk_counts(
            x, scores, [iso_gammas[0]], [1.0], thr, 1, 0, single=True)
    elif iso_signs:
        slab0, upper = phi_rbf_terms_sym_chunk_counts(
            x, scores, list(iso_gammas), list(iso_signs), thr, 1, 0)
    else:
        slab0 = torch.zeros((2 * m, n), dtype=dtype, device=device)
    slabs = [slab0]
    for t in range(len(aniso_signs)):
        lower = torch.as_tensor(lowers[t], device=device).to(torch.float64)
        z = (x.to(torch.float64) @ lower).to(dtype)
        slabs.append(phi_rbf_terms_sym_chunk_counts(
            z, scores, [1.0], [1.0], thr[:0], 1, 0, single=True)[0])
    return torch.stack(slabs), upper


def aniso_groups_finish(acc, scores, gamma, iso_signs, aniso_signs, lowers,
                        n: int):
    """phi (n, m) of K14's term groups' accumulator ``acc``
    (1 + n_aniso, 2 width, n), width >= m = scores' columns (the wide
    kernels' padded rows; the micro-tile groups' and
    :func:`aniso_groups_plain`'s width m): the wrapper's one epilogue at
    every m, shared with the tests. Each group's KS and D are its
    columns [0, m) and [width, width + m), scaled by the group's
    convention:

      * group 0 with one isotropic term: KS by s, D by 2 gamma s
        (``gamma`` its device scalar: nothing is read on the host);
      * group 0 with more: KS by 1, D by 2 (its weights carry s and gamma);
        with none, nothing (not swept);
      * group 1 + t: KS and D_zt by s_t, then 2 D_zt L_t^T in float64.

    The self pairs (k = 1 for every term) entered KS in both directions,
    so (sum of all signs) s_i comes off once."""
    m = scores.shape[1]
    width = acc.shape[1] // 2
    ks, d = acc[:, :m], acc[:, width:width + m]
    phi = -sum(float(s) for s in (*iso_signs, *aniso_signs)) * scores
    if len(iso_signs) == 1:
        s0 = float(iso_signs[0])
        phi = phi + s0 * ks[0].T + (2.0 * s0) * gamma * d[0].T
    elif iso_signs:
        phi = phi + ks[0].T + 2.0 * d[0].T
    # The signs stay Python numbers: a tensor of them would be a copy from
    # the host, which waits for the sweep.
    grad = 0.0
    for t, sign in enumerate(aniso_signs):
        lower = torch.as_tensor(lowers[t], device=acc.device)
        phi = phi + float(sign) * ks[1 + t].T
        grad = grad + float(sign) * (d[1 + t].T.to(torch.float64)
                                     @ lower.to(torch.float64).T)
    return (phi + 2.0 * grad.to(acc.dtype)) / n


def phi_rbf_eigen(coords, scores, lam, v, psd: bool = True,
                  row_tile: int = 1024):
    """phi of one RBF exp(-d^T P d) over one particle set from the
    decomposition P_sym/2 = V diag(lam) V^T (any P, indefinite too): with
    z = x_c V (x_c centered; formed in float64, as the wrapper forms it),
    the form is sum_k lam_k (z_ik - z_jk)^2, clamped at 0 where ``psd``,
    and the gradient direction 2 (z_i - z_j) diag(lam) V^T, so

      n phi_i = sum_j k_ij s_j + 2 (sum_j k_ij (z_i - z_j)) diag(lam) V^T,

    the fixed-P CUDA kernel's arithmetic (phi_rbf.cu), its float64
    epilogue included; the form by the Gram identity. Streams over row
    tiles."""
    x = coords - coords.mean(dim=0)
    lam = torch.as_tensor(lam, device=x.device).to(torch.float64)
    v = torch.as_tensor(v, device=x.device).to(torch.float64)
    z = (x.to(torch.float64) @ v).to(x.dtype)
    lam_x = lam.to(x.dtype)
    zl = z * lam_x
    norms = torch.sum(zl * z, dim=1)
    n = x.shape[0]
    row_tile = auto_row_tile(n, row_tile)
    out = []
    for start in range(0, n, row_tile):
        zi = z[start : start + row_tile]
        form = (norms[start : start + row_tile, None] + norms[None, :]
                - 2.0 * sq_matmul(zl[start : start + row_tile], z.T))
        if psd:
            form = torch.clamp_min(form, 0.0)
        k = torch.exp(-form)
        d_z = torch.sum(k, dim=1, keepdim=True) * zi - sq_matmul(k, z)
        grad = (d_z.to(torch.float64) * lam) @ v.T
        out.append(sq_matmul(k, scores.to(x.dtype)) + 2.0 * grad.to(x.dtype))
    return torch.cat(out, dim=0) / n


def phi_rbf_factor(coords, scores, lower, row_tile: int = 1024):
    """phi of one anisotropic RBF exp(-d^T P d) over one particle set from
    the factor L of P_sym/2 = L L^T: with z = x_c L (x_c centered), the
    form is |z_i - z_j|^2 and the gradient direction 2 (z_i - z_j) L^T, so

      n phi_i = sum_j k_ij s_j + 2 (sum_j k_ij (z_i - z_j)) L^T,

    the one-pass CUDA kernel's arithmetic (fused_phi_aniso.cu), its
    epilogue D_z L^T included; the form by the Gram identity, clamped at 0.
    Streams over row tiles."""
    x = coords - coords.mean(dim=0)
    lower = torch.as_tensor(lower, device=x.device).to(x.dtype)
    z = sq_matmul(x, lower)
    n = x.shape[0]
    norms = torch.sum(z * z, dim=1)
    row_tile = auto_row_tile(n, row_tile)
    out = []
    for start in range(0, n, row_tile):
        zi = z[start : start + row_tile]
        form = torch.clamp_min(
            norms[start : start + row_tile, None] + norms[None, :]
            - 2.0 * sq_matmul(zi, z.T), 0.0,
        )
        k = torch.exp(-form)
        d_z = torch.sum(k, dim=1, keepdim=True) * zi - sq_matmul(k, z)
        out.append(sq_matmul(k, scores) + 2.0 * sq_matmul(d_z, lower.T))
    return torch.cat(out, dim=0) / n


def gram_operands(coords_c, half):
    """K15's wide operands (every m but 1-8 and 11), the JAX kernel's own
    (pallas_phi.py:189-190): Y = x_c H and q_i = x_i . y_i for H = P_sym/2 and centered
    coordinates x_c, both formed in float64 and returned in x_c's dtype,
    so that q_i + q_j - 2 x_i . y_j = d^T P d for d = x_i - x_j, for any P,
    indefinite too."""
    x64 = coords_c.to(torch.float64)
    y64 = x64 @ torch.as_tensor(half, device=x64.device).to(torch.float64)
    q64 = torch.sum(x64 * y64, dim=1)
    return (y64.to(coords_c.dtype).contiguous(),
            q64.to(coords_c.dtype).contiguous())


def phi_rbf_gram(coords, scores, half, psd: bool = True,
                 row_tile: int = 1024, dot_dtype: str = "float32"):
    """phi of one RBF exp(-d^T P d) over one particle set from H = P_sym/2
    itself (any P, indefinite too), in the wide fixed-P CUDA kernel's form
    (phi_rbf.cu, ``phi_rbf_wide``): with x_c centered and (Y, q) =
    ``gram_operands(x_c, H)``, the form q_i + q_j - 2 x_i . y_j, clamped at
    0 where ``psd``, the self pair pinned to 0, and

      n phi_i = sum_j k_ij s_j + 2 (sum_j k_ij (x_i - x_j)) H,

    the gradient direction in float64, as the wrapper applies it. Streams
    over row tiles.

    ``dot_dtype='bfloat16'`` (the JAX kernel's opt-in, pallas_phi.py:
    189-201): the Gram operands x and y, the weights k and the records s
    and x of the contractions rounded (:func:`round_bf16`), q and the D
    term's x_i unrounded, and the self pair's form left as it comes, as
    the JAX kernel leaves it (the rounded Gram moves it off 0): the plain
    version of ``phi_rbf_wide_bf16``."""
    bf16 = dot_bf16(dot_dtype)
    rnd = _rounding(bf16)
    x = coords - coords.mean(dim=0)
    half = torch.as_tensor(half, device=x.device).to(torch.float64)
    y, q = gram_operands(x, half)
    y_g, x_rec = rnd(y), rnd(x)
    scores = rnd(scores.to(x.dtype))
    n = x.shape[0]
    row_tile = auto_row_tile(n, row_tile)
    out = []
    for start in range(0, n, row_tile):
        xi = x[start : start + row_tile]
        rows = torch.arange(xi.shape[0], device=x.device)
        form = (q[start : start + row_tile, None] + q[None, :]
                - 2.0 * sq_matmul(rnd(xi), y_g.T))
        if psd:
            form = torch.clamp_min(form, 0.0)
        if not bf16:
            form[rows, start + rows] = 0.0
        k = rnd(torch.exp(-form))
        d = torch.sum(k, dim=1, keepdim=True) * xi - sq_matmul(k, x_rec)
        grad = d.to(torch.float64) @ half
        out.append(sq_matmul(k, scores) + 2.0 * grad.to(x.dtype))
    return torch.cat(out, dim=0) / n
