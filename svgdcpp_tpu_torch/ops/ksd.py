"""Kernel Stein discrepancy (KSD): SVGD's convergence diagnostic.

Port of ``svgdcpp_tpu.ops.ksd``. The squared KSD with kernel k and score
s(x) = grad log p(x) is

    KSD^2 = (1/n^2) sum_{ij} u_p(x_i, x_j)
    u_p(x, y) = s(x)^T k s(y) + s(x)^T grad_y k + grad_x k^T s(y)
                + trace(grad_x grad_y k)

and for the Gaussian RBF k = exp(-(x-y)^T P (x-y)) every term is closed
form, with P_s = P + P^T and d = P_s (x - y):

    grad_x k = -k d,  grad_y k = +k d,  trace(grad_x grad_y k) = k (tr P_s - d^T d)

Plain torch, streamed over row tiles so the n x n matrix never exists
whole, as the JAX package's XLA code is. Each tile's sum is added in
float64, so a float32 particle set of 10^5-10^6 particles keeps its digits
through the n^2 terms; the result is returned in the coordinates' dtype.
Any other kernel takes the autodiff Stein kernel (``ksd_squared_generic``),
streamed over row tiles the same way.
"""

from __future__ import annotations

import torch
from torch.func import grad, jacfwd, vmap

from .pairwise import auto_row_tile


def ksd_squared_rbf(
    coords: torch.Tensor,
    scores: torch.Tensor,
    p_matrix: torch.Tensor,
    row_tile: int = 1024,
    ustat: bool = False,
    psd: bool = True,
) -> torch.Tensor:
    """Squared KSD for the RBF kernel with inverse scale ``p_matrix``,
    tile-streamed over rows.

    ``ustat=True`` removes the diagonal u_p(x, x) = |s(x)|^2 + tr(P_s)
    (the V-statistic's positive bias, which does not vanish at the target)
    and normalizes by n(n-1): the U-statistic for convergence checks, the
    V-statistic for theory parity. ``psd=False`` keeps a negative quadratic
    form (an indefinite P) instead of clamping it at 0.
    """
    n, m = coords.shape
    dtype, device = coords.dtype, coords.device
    p_matrix = torch.as_tensor(p_matrix, dtype=dtype, device=device)
    scores = scores.to(dtype)
    row_tile = auto_row_tile(n, row_tile)
    p_sym = p_matrix + p_matrix.T
    tr_psym = torch.trace(p_sym)
    total = torch.zeros((), dtype=torch.float64, device=device)
    for start in range(0, n, row_tile):
        x_i = coords[start : start + row_tile]
        s_i = scores[start : start + row_tile]
        diffs = [x_i[:, a, None] - coords[None, :, a] for a in range(m)]
        quad = torch.zeros((x_i.shape[0], n), dtype=dtype, device=device)
        for a in range(m):
            for b in range(a, m):
                w = p_sym[a, b] if a != b else p_matrix[a, a]
                quad = quad + w * diffs[a] * diffs[b]
        if psd:
            quad = torch.clamp_min(quad, 0.0)
        k = torch.exp(-quad)
        # s(x_i)^T s(x_j) k
        term1 = (s_i @ scores.T) * k
        # d = P_s (x_i - x_j): grad_y k = k d, grad_x k = -k d
        d = [sum(p_sym[a, b] * diffs[b] for b in range(m)) for a in range(m)]
        s_i_dot_d = sum(s_i[:, a, None] * d[a] for a in range(m))
        s_j_dot_d = sum(scores[None, :, a] * d[a] for a in range(m))
        term2 = k * (s_i_dot_d - s_j_dot_d)
        dd = sum(di * di for di in d)
        term3 = k * (tr_psym - dd)
        total = total + torch.sum(term1 + term2 + term3, dtype=torch.float64)
    if ustat:
        diag = torch.sum(scores * scores) + n * tr_psym  # sum of u_p(x_i, x_i)
        return ((total - diag) / (float(n) * float(n - 1))).to(dtype)
    return (total / (float(n) * float(n))).to(dtype)


def ksd_squared_rbf_terms(
    coords: torch.Tensor,
    scores: torch.Tensor,
    kernel_params,
    terms,
    row_tile: int = 1024,
    ustat: bool = False,
    psd_flags=None,
) -> torch.Tensor:
    """Squared KSD for a composed kernel flattened to signed RBF terms
    (kernels/algebra.flatten_rbf_terms). u_p is linear in k, so the KSD^2
    is the signed sum of each term's closed form with the term's effective
    P. ``psd_flags`` (kernels/algebra.term_psd_flags) sets each term's
    clamp; without it the positional term_is_psd rule is used."""
    from ..kernels.algebra import term_is_psd, term_precision

    if psd_flags is None:
        psd_flags = [term_is_psd(t) for t in terms]
    elif len(psd_flags) != len(terms):
        raise ValueError(
            f"psd_flags has {len(psd_flags)} entries for {len(terms)} terms"
        )
    total = None
    for (sign, plist), t_psd in zip(terms, psd_flags):
        p = term_precision(plist, kernel_params)
        t_ksd2 = ksd_squared_rbf(coords, scores, p, row_tile, ustat=ustat,
                                 psd=t_psd)
        t_ksd2 = t_ksd2 if sign > 0 else -t_ksd2
        total = t_ksd2 if total is None else total + t_ksd2
    return total


def ksd_squared_generic(
    coords: torch.Tensor,
    scores: torch.Tensor,
    kernel_fn,
    params,
    row_tile: int = 256,
    ustat: bool = False,
) -> torch.Tensor:
    """Squared KSD for an arbitrary kernel by torch.func (the diagnostic
    twin of ``ops/phi.phi_generic_cross``).

    ``kernel_fn(x, params, location) -> scalar`` is the Kernel contract.
    Both first gradients come from ``grad`` in each argument and the
    mixed-Hessian trace from ``jacfwd`` over the y-gradient (m forward
    passes a pair, so this is a diagnostic, not a hot path). Streamed over
    row tiles, each tile's sum added in float64; ``ustat`` as in
    :func:`ksd_squared_rbf`. Floating parameters take the coordinates'
    device and dtype.
    """
    from ..models.model import params_on

    n, m = coords.shape
    dtype, device = coords.dtype, coords.device
    scores = scores.to(dtype)
    row_tile = auto_row_tile(n, row_tile)
    params = params_on(tuple(torch.as_tensor(p) for p in params), device,
                       dtype)

    def k_xy(x, y):
        return torch.as_tensor(kernel_fn(x, params, y)).squeeze()

    grad_x = grad(k_xy, argnums=0)
    grad_y = grad(k_xy, argnums=1)

    def u_p(x, sx, y, sy):
        mixed = jacfwd(lambda xx: grad_y(xx, y))(x)  # (m, m)
        return (
            (sx @ sy) * k_xy(x, y)
            + sx @ grad_y(x, y)
            + grad_x(x, y) @ sy
            + torch.trace(mixed)
        )

    pair_rows = vmap(vmap(u_p, in_dims=(None, None, 0, 0)),
                     in_dims=(0, 0, None, None))
    total = torch.zeros((), dtype=torch.float64, device=device)
    for start in range(0, n, row_tile):
        contrib = pair_rows(coords[start:start + row_tile],
                            scores[start:start + row_tile], coords, scores)
        total = total + torch.sum(contrib, dtype=torch.float64)
    if ustat:
        diag = torch.sum(vmap(u_p)(coords, scores, coords, scores),
                         dtype=torch.float64)
        return ((total - diag) / (float(n) * float(n - 1))).to(dtype)
    return (total / (float(n) * float(n))).to(dtype)


def ksd_rbf(model, coords, p_matrix=None, row_tile: int = 1024,
            ustat: bool = True, kernel=None, device="cuda") -> torch.Tensor:
    """KSD of a particle set against a model's target density.

    The model's score at each particle, and when ``p_matrix`` is None the
    median bandwidth (as the SVGD run itself uses). ``kernel=<Kernel>``
    evaluates the KSD under that kernel with its own parameters: a
    `+ - * /` tree of pure RBF kernels by the closed-form signed-term sum,
    any other (custom kernel_fn leaves, trees that do not flatten) by the
    autodiff Stein kernel (:func:`ksd_squared_generic`).

    Coordinates that are a tensor keep their device; any other go to
    ``device``, the card by default, as the drivers' coordinates do
    (without a CUDA device that raises unless ``device="cpu"``).
    """
    from ..core.types import place_coords
    from ..kernels.gaussian_rbf import median_scale
    from ..models.model import params_on

    coords = place_coords(coords, device, "ksd_rbf's device")
    params = params_on(model.parameters, coords.device, coords.dtype)
    scores = vmap(lambda x: model.grad_log_density_pure(x, params))(coords)
    if kernel is not None:
        if p_matrix is not None:
            raise ValueError(
                "ksd_rbf: pass either p_matrix or kernel, not both (the "
                "composed kernel's own parameters define its bandwidths)."
            )
        from ..kernels.algebra import flatten_rbf_terms, term_psd_flags

        terms = flatten_rbf_terms(kernel)
        if terms is None:
            ksd2 = ksd_squared_generic(
                coords, scores, kernel._kernel_fn, tuple(kernel.parameters),
                row_tile, ustat=ustat,
            )
            return torch.sqrt(torch.clamp_min(ksd2, 0.0))
        kparams = tuple(
            torch.as_tensor(p).to(coords.device, coords.dtype)
            for p in kernel.parameters
        )
        ksd2 = ksd_squared_rbf_terms(
            coords, scores, kparams, terms, row_tile, ustat=ustat,
            psd_flags=term_psd_flags(
                terms, kernel.adaptive_slots(), kernel.parameters
            ),
        )
        return torch.sqrt(torch.clamp_min(ksd2, 0.0))
    if p_matrix is None:
        p_matrix = median_scale(coords)
    ksd2 = ksd_squared_rbf(coords, scores, p_matrix, row_tile, ustat=ustat)
    return torch.sqrt(torch.clamp_min(ksd2, 0.0))
