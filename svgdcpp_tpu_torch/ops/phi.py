"""Stein variational gradient phi_hat, plain torch sweeps.

    phi(x_i) = (1/n) sum_j [ k(x_j, x_i) grad_{x_j} log p(x_j)
                             + grad_{x_j} k(x_j, x_i) ]

Port of the closed-form RBF paths of ``svgdcpp_tpu.ops.phi`` (reference hot
loop SVGD.hpp:407-454):

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
                           with anisotropic (full-P) terms.
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

Index convention: K[i, j] = k(x_j, x_i), row i is the target particle.
"""

from __future__ import annotations

import math

import torch

from .pairwise import auto_row_tile, sq_matmul, weighted_quadratic_pairwise
from .sym_plan import (
    DIFF_FORM_MAX_M,
    card_panel_plan,
    panel_chunk,
    panel_pairs,
    sym_tile,
    sym_tile_chunk,
    upper_tile_rows,
)


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

    Returns (phi (n_t, m) normalized by n_s, counts (E,) int64).
    """
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
    if m <= DIFF_FORM_MAX_M:
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
    if single:
        b = torch.cat([source_scores, sources, ones], dim=1)
    else:
        xs1 = torch.cat([sources, ones], dim=1)
    for start in range(0, n_t, row_tile):
        rows = targets[start : start + row_tile]
        gram = sq_matmul(rows, sources.T)
        sq = torch.clamp_min(
            q_tgt[start : start + row_tile, None] + q_src[None, :] - 2.0 * gram,
            0.0,
        )
        if single:
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
):
    """Single-term cross fused sweep (see phi_rbf_terms_cross_fused_counts)."""
    return phi_rbf_terms_cross_fused_counts(
        targets, sources, source_scores, [gamma], [1], thresholds_sq, row_tile,
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
):
    """Single-set single-term fused sweep: ONE O(n^2) pass giving the RBF
    phi (P = gamma I) and the median-selection counts, the main path's
    plain sweep (see phi_rbf_terms_cross_fused_counts)."""
    return phi_rbf_terms_cross_fused_counts(
        coords, coords, scores, [gamma], [1], thresholds_sq, row_tile
    )


def _pair_weights(gammas, signs, single, dtype, device):
    """sq -> (k_c, w): the pair weights of KS and D. One RBF (``single``):
    k = exp(-gamma sq) for both (the epilogue multiplies D by gamma); a
    composed kernel: k_c = sum s exp(-gamma sq), w = sum s gamma exp(-gamma
    sq)."""
    gammas = [torch.as_tensor(g, dtype=dtype, device=device) for g in gammas]
    signs = [float(s) for s in signs]

    def weights(sq):
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


def _pair_block(coords_c, scores, q, r0, r1, c0, c1, diag, weights, thr):
    """Both directions of the pairs (i, j), i in [r0, r1), j in [c0, c1); on
    a ``diag`` block only j >= i, the self pairs included: (KS_row (r, m),
    D_row (r, m), KS_col (c, m), D_col (c, m), hits (E,) int64), as the
    triangle kernels accumulate them. Row i gains k_c s_j and w (x_i - x_j),
    column j gains k_c s_i and w (x_j - x_i); hits counts the pairs kept at
    or below each threshold. sq comes from differences up to
    DIFF_FORM_MAX_M, as in phi_rbf_terms_cross_fused_counts, else from the
    Gram identity on the squared norms ``q`` with the self pairs pinned to
    0."""
    m = coords_c.shape[1]
    dtype, device = coords_c.dtype, coords_c.device
    xr, sr = coords_c[r0:r1], scores[r0:r1]
    xc, sc = coords_c[c0:c1], scores[c0:c1]
    keep = None
    if diag:
        gi = torch.arange(r0, r1, device=device)[:, None]
        gj = torch.arange(c0, c1, device=device)[None, :]
        keep = gj >= gi
    if m <= DIFF_FORM_MAX_M:
        diffs = [xr[:, a, None] - xc[None, :, a] for a in range(m)]
        sq = torch.zeros((r1 - r0, c1 - c0), dtype=dtype, device=device)
        for a in range(m):
            sq = sq + diffs[a] * diffs[a]
    else:
        sq = torch.clamp_min(
            q[r0:r1, None] + q[None, c0:c1] - 2.0 * sq_matmul(xr, xc.T), 0.0,
        )
        if keep is not None:
            sq = torch.where(gj == gi, torch.zeros_like(sq), sq)
    k_c, w_ = weights(sq)
    if keep is not None:
        k_c = torch.where(keep, k_c, torch.zeros_like(k_c))
        w_ = torch.where(keep, w_, torch.zeros_like(w_))
        hits = torch.sum(
            (sq[None, :, :] <= thr[:, None, None]) & keep[None], dim=(1, 2)
        )
    else:
        hits = torch.sum(sq[None, :, :] <= thr[:, None, None], dim=(1, 2))
    if m <= DIFF_FORM_MAX_M:
        d_row = torch.stack(
            [torch.sum(w_ * diffs[a], dim=1) for a in range(m)], dim=1
        )
        d_col = -torch.stack(
            [torch.sum(w_ * diffs[a], dim=0) for a in range(m)], dim=1
        )
    else:
        d_row = torch.sum(w_, dim=1)[:, None] * xr - w_ @ xc
        d_col = torch.sum(w_, dim=0)[:, None] * xc - w_.T @ xr
    return k_c @ sc, d_row, k_c.T @ sr, d_col, hits


def _sympanel_halves(coords_c, scores, gammas, signs, thresholds_sq, nb, w,
                     single, row_tile, p0=0, count=None):
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
    the pairs are ``_pair_block``'s."""
    n, m = coords_c.shape
    dtype, device = coords_c.dtype, coords_c.device
    thr = torch.as_tensor(thresholds_sq, dtype=dtype, device=device)
    pairs = panel_pairs(nb)
    pairs = pairs[p0:] if count is None else pairs[p0:p0 + count]
    panels = torch.zeros((len(pairs), 2, 2 * m, w), dtype=dtype, device=device)
    upper = torch.zeros(thr.shape[0], dtype=torch.int64, device=device)
    q = torch.sum(coords_c * coords_c, dim=1)
    row_tile = auto_row_tile(w, row_tile)
    weights = _pair_weights(gammas, signs, single, dtype, device)

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
                thr,
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
    on the coordinates' mean."""
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
    weights = _pair_weights(gammas, signs, single, dtype, device)
    for bi, bj_first, bj_last in upper_tile_rows(nb, t0, count):
        r0, r1 = bi * tile, min(bi * tile + tile, n)
        c0, c1 = bj_first * tile, min(bj_last * tile + tile, n)
        ks_row, d_row, ks_col, d_col, hits = _pair_block(
            coords_c, scores, q, r0, r1, c0, c1, bj_first == bi, weights, thr,
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
                                  row_tile: int = 1024):
    """One rank's chunk of one RBF's panel triangle sweep in plain torch:
    the plain version of the CUDA kernel ``fused_phi_counts_sympanel_chunk``
    (K5's port), the counterpart of the JAX package's
    ``phi_rbf_fused_pallas_sympanel_sharded``. ``coords`` and ``scores`` are
    the GLOBAL set, the chunk rank's range of the card's panel list
    (``sym_plan.panel_chunk`` of ``card_panel_plan(n, panel_blocks)``).
    Returns the chunk's windows scattered onto the raw (2m, n) accumulator
    (``sympanel_scatter``) and its upper counts (E,) int64; summed over the
    ranks they are the whole panel sweep's. Centered on the coordinates'
    mean."""
    n = coords.shape[0]
    nb, w, _ = card_panel_plan(n, panel_blocks)
    p0, count = panel_chunk(nb, world, rank)
    coords_c = coords - coords.mean(dim=0)
    scores = scores.to(coords.dtype)
    panels, upper = _sympanel_halves(
        coords_c, scores, [gamma], [1.0], thresholds_sq, nb, w, True,
        row_tile, p0, count,
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
    kernel path's epilogue (:func:`sympanel_epilogue`), on the card's plan
    (``sym_plan.card_panel_plan``; ``panel_blocks`` forces its super-block
    count). Centered on the coordinates' mean. Returns (phi (n, m),
    counts (E,) int64)."""
    n = coords.shape[0]
    nb, w, _ = card_panel_plan(n, panel_blocks)
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
):
    """One RBF's panel triangle sweep in plain torch: the plain version of
    the CUDA kernel ``fused_phi_counts_sympanel`` (ops/cuda_phi.py), the
    counterpart of ``_phi_rbf_fused_pallas_sympanel_impl``. The same
    function as :func:`phi_rbf_fused_counts` (see
    :func:`phi_rbf_terms_sympanel_fused_counts`)."""
    n = coords.shape[0]
    nb, w, _ = card_panel_plan(n, panel_blocks)
    coords_c = coords - coords.mean(dim=0)
    scores = scores.to(coords.dtype)
    panels, upper = _sympanel_halves(
        coords_c, scores, [gamma], [1.0], thresholds_sq, nb, w, True, row_tile
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
):
    """phi of a composed kernel with ANISOTROPIC terms and the counts of the
    Euclidean pair distances: the plain version of the CUDA kernel
    ``fused_phi_aniso_terms_sym`` (ops/cuda_phi.py), the counterpart of
    ``svgdcpp_tpu.ops.pallas_phi.phi_rbf_aniso_terms_fused_pallas``.

    The kernel is ``sum_iso s exp(-gamma sq) + sum_t s_t exp(-d^T P_t d)``.
    phi is linear in k, so it is the isotropic terms' fused sweep
    (:func:`phi_rbf_terms_fused_counts`, which also gives the counts with
    its squared distances) plus each anisotropic term's signed closed-form
    phi (:func:`phi_rbf_cross` with P_t, its form clamped at zero: the
    route's gate proves every term positive definite). Both stream over row
    tiles; float32 and float64 both run. Returns (phi (n, m), counts (E,)
    int64).
    """
    phi, counts = phi_rbf_terms_fused_counts(
        coords, scores, list(iso_gammas), list(iso_signs), thresholds_sq,
        row_tile,
    )
    for p, sign in zip(aniso_ps, aniso_signs):
        p = torch.as_tensor(p, dtype=coords.dtype, device=coords.device)
        phi = phi + float(sign) * phi_rbf_cross(
            coords, coords, scores, p, row_tile, psd=True
        )
    return phi, counts
