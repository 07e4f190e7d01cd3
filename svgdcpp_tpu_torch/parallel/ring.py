"""The ring schedule: multi-rank SVGD without a gather of the particle set.

Port of ``svgdcpp_tpu.parallel.ring``. Gather mode (``parallel/sharded.py``)
all-gathers the (n, m) coordinates and scores once a step, so each rank
holds O(n m). Here no rank ever holds the global set: each rank's source
block travels round the ring (``ParticleGroup.rotate``, one message a
rotation) while every rank adds its local targets' share of each block,
so a rank holds O((n/D) m) plus one (row_tile, n/D) kernel tile.

``ShardedSVGD`` takes these with ``phi_mode='ring'``. The median there is a
count bisection of ring counts only: the pair-sampling bracket of gather
mode needs random access to the global set, which the ring never builds.

Every function is collective: every rank of the group calls it with its
own rows, in the same order. D blocks take D - 1 rotations (the JAX
package rotates D times and drops the last result).
"""

from __future__ import annotations

import torch

from ..kernels.algebra import term_is_psd, term_precision
from ..kernels.gaussian_rbf import scale_from_median
from ..ops.median import centered_count_env, count_le_cross, kth_smallest_bisect
from ..ops.pairwise import sq_matmul
from ..ops.phi import phi_generic_cross
from .mesh import ParticleGroup


def _global_center(coords_local, group: ParticleGroup, n_global: int):
    """The coordinates' global mean, the same on every rank."""
    return group.all_reduce_sum(torch.sum(coords_local, dim=0)) / n_global


def _blocks(block, group: ParticleGroup):
    """``block`` and then each other rank's in turn: the D source blocks
    this rank sees, one rotation between two."""
    for r in range(group.world_size):
        yield block
        if r + 1 < group.world_size:
            block = group.rotate(block)


def ring_phi_rbf(coords_local, scores_local, p_matrix, group: ParticleGroup,
                 n_global: int, psd: bool = True, row_tile: int = 256):
    """phi of this rank's targets, the sources streamed round the ring.

    The coordinates are centered on the global mean first (phi is
    translation-invariant; the Gram identity loses about eps * |x|^2
    otherwise). Each rotation carries one buffer [x P_sym | q | scores | x
    | 1] of the block; the targets go through it in ``row_tile`` bands, so
    the largest live tensor is one (row_tile, n_loc) kernel tile. The cross
    product goes through ``sq_matmul`` (no TF32 in the quadratic form).
    ``psd=False`` keeps negative quadratic forms (an indefinite effective P
    of a division term, kernels/algebra.py)."""
    n_loc, m = coords_local.shape
    x = coords_local - _global_center(coords_local, group, n_global)
    p = p_matrix.to(x.dtype)
    p_sym = p + p.T
    q = torch.sum((x @ p) * x, dim=1)
    ones = torch.ones((n_loc, 1), dtype=x.dtype, device=x.device)
    block = torch.cat([x @ p_sym, q[:, None], scores_local.to(x.dtype), x,
                       ones], dim=1)
    tile = max(1, min(int(row_tile), n_loc))
    acc = torch.zeros((n_loc, 2 * m + 1), dtype=x.dtype, device=x.device)
    for src in _blocks(block, group):
        src_ps_t = src[:, :m].T
        q_src = src[:, m]
        b = src[:, m + 1:]
        for start in range(0, n_loc, tile):
            stop = start + tile
            quad = q[start:stop, None] + q_src[None, :] - sq_matmul(
                x[start:stop], src_ps_t)
            if psd:
                quad = torch.clamp_min(quad, 0.0)
            acc[start:stop] += torch.exp(-quad) @ b
    ks = acc[:, :m]
    kx = acc[:, m:2 * m]
    rowsum = acc[:, 2 * m]
    return (ks - (kx - rowsum[:, None] * x) @ p_sym) / n_global


def ring_phi_rbf_terms(coords_local, scores_local, kernel_params, terms,
                       group: ParticleGroup, n_global: int, psd_flags=None,
                       row_tile: int = 256):
    """phi of a composed kernel flattened to signed RBF terms
    (kernels/algebra.flatten_rbf_terms): phi is linear in k, so each term
    runs its own ring sweep with its effective P and the signed results
    sum. ``psd_flags`` as in ``ops/phi.phi_rbf_terms_cross``."""
    if psd_flags is None:
        psd_flags = [term_is_psd(t) for t in terms]
    elif len(psd_flags) != len(terms):
        raise ValueError(
            f"psd_flags has {len(psd_flags)} entries for {len(terms)} terms"
        )
    phi = None
    for (sign, plist), t_psd in zip(terms, psd_flags):
        t_phi = ring_phi_rbf(
            coords_local, scores_local, term_precision(plist, kernel_params),
            group, n_global, psd=t_psd, row_tile=row_tile,
        )
        t_phi = t_phi if sign > 0 else -t_phi
        phi = t_phi if phi is None else phi + t_phi
    return phi


def ring_phi_generic(coords_local, scores_local, kernel_fn, kernel_params,
                     group: ParticleGroup, n_global: int,
                     row_tile: int = 128):
    """phi of any kernel function, the (sources, scores) blocks streamed
    round the ring: each block adds ``ops/phi.phi_generic_cross`` (which
    divides by its own source count, so it is scaled back by it) and the
    sum is divided once by n_global. A generic kernel sees absolute
    coordinates, so nothing is centered."""
    m = coords_local.shape[1]
    block = torch.cat([coords_local, scores_local.to(coords_local.dtype)],
                      dim=1)
    acc = torch.zeros_like(coords_local)
    for src in _blocks(block, group):
        acc = acc + phi_generic_cross(
            coords_local, src[:, :m], src[:, m:], kernel_fn, kernel_params,
            row_tile,
        ) * src.shape[0]
    return acc / n_global


def ring_count_le(coords_local, thresholds, group: ParticleGroup,
                  n_global: int = None, row_tile: int = 256):
    """Global int64 counts of the pairs with sq distance <= each threshold,
    the column blocks streamed round the ring.

    Each rank counts its rows against every block (its row band of the n x
    n pair matrix) through ``ops/median.count_le_cross`` (the count
    kernel, K16's port, on CUDA tensors; the plain pass on the CPU), and
    the bands are summed over the group. The coordinates are centered on
    the global mean first. The counts are int64 at any n (the JAX package
    counts in float32, exact below 2^24 pairs)."""
    if n_global is None:
        n_global = coords_local.shape[0] * group.world_size
    x = coords_local - _global_center(coords_local, group, n_global)
    counts = None
    for cols in _blocks(x, group):
        c = count_le_cross(x, cols, thresholds, row_tile=row_tile)
        counts = c if counts is None else counts + c
    return group.all_reduce_sum(counts)


def ring_pairwise_median(coords_local, group: ParticleGroup, n_global: int,
                         *, bins: int = 16, passes: int = 6,
                         row_tile: int = 256):
    """The median of all n^2 pairwise distances by count bisection of ring
    counts, the same on every rank. hi0 comes from the centered norms
    (``ops/median.centered_count_env``); an even count averages the two
    middle order statistics (GaussianRBFKernel.hpp:224-245)."""
    total = n_global * n_global
    _, hi0 = centered_count_env(coords_local, None, group=group,
                                n_global=n_global)

    def count_fn(thr):
        return ring_count_le(coords_local, thr, group, n_global,
                             row_tile=row_tile)

    ks = (total // 2, total // 2 + 1) if total % 2 == 0 else ((total + 1) // 2,)
    mids = kth_smallest_bisect(count_fn, ks, 0.0, hi0, bins=bins,
                               passes=passes)
    return torch.mean(torch.sqrt(mids))


def ring_median_scale(coords_local, group: ParticleGroup, n_global: int,
                      **kwargs):
    """P = log(n)/median^2 * I with the ring median."""
    med = ring_pairwise_median(coords_local, group, n_global, **kwargs)
    return scale_from_median(med, n_global, coords_local.shape[1],
                             coords_local.dtype)
