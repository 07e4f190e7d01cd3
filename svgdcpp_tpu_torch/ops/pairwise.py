"""Pairwise distance computations (Gram-matrix identity).

Port of ``svgdcpp_tpu.ops.pairwise``: the reference's squared-distance
construction ``diag + diag^T - 2 X^T X`` (GaussianRBFKernel.hpp:179-183) in
the (n, m) layout.
"""

from __future__ import annotations

import torch


def sq_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for a product whose result feeds a squared distance or a
    quadratic form that goes through exp().

    The JAX package pins ``Precision.HIGH`` on these dots. Here a float32
    product on the card runs in full float32 whatever the process-wide
    setting is: TF32 keeps about three decimal digits, which exp(-gamma*sq)
    amplifies into percent-level kernel error. The setting is restored
    after the product.
    """
    if a.is_cuda and a.dtype == torch.float32:
        prev = torch.get_float32_matmul_precision()
        if prev != "highest":
            torch.set_float32_matmul_precision("highest")
            try:
                return a @ b
            finally:
                torch.set_float32_matmul_precision(prev)
    return a @ b


def squared_pairwise_distances(coords: torch.Tensor) -> torch.Tensor:
    """All-pairs squared Euclidean distances for (n, m) coords -> (n, n).

    Gram identity ||x_i - x_j||^2 = q_i + q_j - 2 x_i.x_j on centered
    coordinates (keeps the cancellation at O(eps * spread^2) instead of
    O(eps * |x|^2) off origin), clamped at zero so a later sqrt cannot NaN.
    """
    coords = coords - coords.mean(dim=0)
    gram = sq_matmul(coords, coords.T)
    sq_norms = torch.diagonal(gram)
    sq = sq_norms[:, None] + sq_norms[None, :] - 2.0 * gram
    return torch.clamp_min(sq, 0.0)


def weighted_quadratic_pairwise(
    coords: torch.Tensor, p_matrix: torch.Tensor, psd: bool = True
) -> torch.Tensor:
    """All-pairs (x_i - x_j)^T P (x_i - x_j) for (n, m) coords -> (n, n).

    q_i + q_j - x_i^T (P + P^T) x_j. ``psd=False`` disables the
    clamp-at-zero noise guard: an indefinite P has legitimately negative
    quadratic forms.
    """
    coords = coords - coords.mean(dim=0)
    p_sym = p_matrix + p_matrix.T
    xp = coords @ p_matrix  # (n, m)
    q = torch.sum(xp * coords, dim=1)  # x_i^T P x_i
    cross = sq_matmul(coords @ p_sym, coords.T)
    quad = q[:, None] + q[None, :] - cross
    if psd:
        quad = torch.clamp_min(quad, 0.0)
    return quad


def auto_row_tile(n_cols: int, requested: int, elem_bytes: int = 4,
                  budget_bytes: int = 1 << 28) -> int:
    """Clamp a row-tile so tile x n_cols buffers stay within ``budget_bytes``
    (a multiple of 8, at least 8)."""
    cap = max(8, budget_bytes // max(1, n_cols * elem_bytes))
    tile = max(8, min(int(requested), cap))
    return (tile // 8) * 8
