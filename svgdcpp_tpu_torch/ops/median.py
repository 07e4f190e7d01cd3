"""Median / order-statistic selection for the RBF bandwidth heuristic.

Port of ``svgdcpp_tpu.ops.median``. The reference takes the median of all
n^2 pairwise distances, INCLUDING the n zero self-distances
(GaussianRBFKernel.hpp:66), averaging the two middle values for even counts
(GaussianRBFKernel.hpp:222-254). Selectors:

  * exact  -- full sort of the n^2 values (small n).
  * bisect -- threshold-count bisection over [0, hi0].
  * hybrid -- a deterministic pair sample brackets the median, count
              passes refine and VERIFY the bracket, bisection on failure.
  * warm   -- last step's per-rank brackets, padded by the movement bound.
  * fused  -- the post-processing half of a warm pass whose counts came
              out of the phi sweep (fused_lag1_plan/fused_median_from_counts).

Deviations from the JAX package, both deliberate:

  * Counts are int64 and ranks are exact Python integers. The JAX code
    compares float32 counts with float32 ranks (median.py:761-765), which
    round above 2^24; here the comparison is exact at any n. At the sizes
    the tests use both sides are exact, so they agree.
  * The bracket checks that JAX runs inside ``lax.cond`` are a Python
    ``if`` on one boolean read from the device. That read is once per
    SVGD step on the fused path; the fallback itself always runs when
    the check fails.

The selection state (brackets, edges, medians) is float64 on every device:
it is a handful of scalars, and float64 keeps it identical to the JAX
package under x64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .pairwise import auto_row_tile, sq_matmul, squared_pairwise_distances

#: dtype of the selection state (brackets, edges, selected values).
SELECT_DTYPE = torch.float64

# ----------------------------------------------------------------------
# Exact path
# ----------------------------------------------------------------------


def median_exact(values: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D array with the reference's even/odd semantics
    (GaussianRBFKernel.hpp:224-253)."""
    values = values.reshape(-1)
    n = values.shape[0]
    s = torch.sort(values).values
    if n % 2 == 0:
        return 0.5 * (s[n // 2 - 1] + s[n // 2])
    return s[n // 2]


def pairwise_distance_median_exact(coords: torch.Tensor) -> torch.Tensor:
    """Exact median of all n^2 pairwise distances (self-zeros included)."""
    sq = squared_pairwise_distances(coords)
    return median_exact(torch.sqrt(sq))


# ----------------------------------------------------------------------
# Count-bisection selection
# ----------------------------------------------------------------------


def count_le_cross(rows_coords, cols_coords, thresholds, *, row_tile: int = 2048):
    """For each threshold t: int64 count of ||r_i - c_j||^2 <= t over all
    pairs, both sets centered on the column mean.

    CPU tensors run the plain pass (:func:`count_le_plain`); CUDA tensors
    the count kernel (``ops/cuda_phi.count_le_cuda``, K16's port) at any m,
    which compares in float32 and builds sq from differences up to m = 4."""
    if rows_coords.device.type == "cpu":
        return count_le_plain(rows_coords, cols_coords, thresholds,
                              row_tile=row_tile)
    from .cuda_phi import count_le_cuda

    return count_le_cuda(rows_coords, cols_coords, thresholds)


def count_le_plain(rows_coords, cols_coords, thresholds, *,
                   row_tile: int = 2048):
    """count_le_cross in plain torch: the count kernel's plain version.

    Tile-streamed over row blocks (memory O(row_tile * n_cols)). Both inputs
    are shifted by the COLUMN mean (distances are translation-invariant):
    the Gram-identity squared distances lose ~eps * |x|^2 otherwise, so an
    off-origin cluster would produce garbage counts.

    One pass over each tile serves every threshold: each squared distance
    is binned between the sorted thresholds (``torch.bucketize``), the bins
    are counted, and their running sum is each threshold's count. The
    thresholds are compared in the coordinates' dtype, as ``sq <= t`` with
    a 0-d threshold tensor compares them.
    """
    center = cols_coords.mean(dim=0)
    rows_coords = rows_coords - center
    cols_coords = cols_coords - center
    n_r = rows_coords.shape[0]
    n_c = cols_coords.shape[0]
    row_tile = auto_row_tile(n_c, row_tile)
    row_norms = torch.sum(rows_coords * rows_coords, dim=1)
    col_norms = torch.sum(cols_coords * cols_coords, dim=1)
    num_t = thresholds.shape[0]
    thr = torch.as_tensor(thresholds, device=rows_coords.device).to(
        rows_coords.dtype
    )
    thr_sorted, order = torch.sort(thr)
    hist = torch.zeros(num_t + 1, dtype=torch.int64, device=rows_coords.device)
    for start in range(0, n_r, row_tile):
        rows = rows_coords[start : start + row_tile]
        gram = sq_matmul(rows, cols_coords.T)
        sq = torch.clamp_min(
            row_norms[start : start + row_tile, None] + col_norms[None, :]
            - 2.0 * gram,
            0.0,
        )
        # bin b holds thr_sorted[b-1] < sq <= thr_sorted[b]
        bins = torch.bucketize(sq, thr_sorted, out_int32=True)
        hist += torch.bincount(bins.reshape(-1), minlength=num_t + 1)
    counts = torch.empty(num_t, dtype=torch.int64, device=rows_coords.device)
    counts[order] = torch.cumsum(hist[:num_t], dim=0)
    return counts


def _first_true(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 when none is), like
    ``jnp.argmax`` of a boolean array."""
    return torch.argmax(mask.to(torch.int32), dim=dim)


def kth_smallest_bisect(count_le_fn, ks, lo, hi, *, bins: int = 16,
                        passes: int = 6):
    """Localize the k-th smallest value(s) by threshold-count bisection;
    returns the final interval midpoints, shape (R,). See
    :func:`kth_smallest_bisect_intervals`."""
    mids, _, _ = kth_smallest_bisect_intervals(
        count_le_fn, ks, lo, hi, bins=bins, passes=passes
    )
    return mids


def _device_of(*values):
    for v in values:
        if torch.is_tensor(v):
            return v.device
    return None


def kth_smallest_bisect_intervals(count_le_fn, ks, lo, hi, *, bins: int = 16,
                                  passes: int = 6):
    """Joint bisection of R (1-indexed) ranks with PER-RANK intervals.

    Every pass issues one flattened (R * bins,) threshold batch to
    ``count_le_fn(thresholds) -> (E,) int64`` (GLOBAL cumulative counts).
    Returns (midpoints (R,), lo (R,), hi (R,)); each rank's value lies in
    its own [lo_r, hi_r].
    """
    fdt = SELECT_DTYPE
    device = _device_of(hi, lo)
    ks = torch.as_tensor(ks, dtype=torch.int64, device=device).reshape(-1)
    r = ks.shape[0]
    lo = torch.as_tensor(lo, dtype=fdt, device=device).reshape(()).expand(r)
    hi = torch.as_tensor(hi, dtype=fdt, device=device).reshape(()).expand(r)
    edges = torch.arange(1, bins + 1, dtype=fdt, device=device)
    for _ in range(passes):
        width = (hi - lo) / bins  # (R,)
        thresholds = lo[:, None] + width[:, None] * edges[None, :]  # (R, bins)
        cum = count_le_fn(thresholds.reshape(-1)).reshape(r, bins)
        b = _first_true(cum >= ks[:, None], dim=1)  # first edge with rank >= k
        lo = lo + b.to(fdt) * width
        hi = lo + width
    return 0.5 * (lo + hi), lo, hi


# ----------------------------------------------------------------------
# Two-rank bracket tracking (the median's k1 = total//2 and k2 = k1 + 1)
# ----------------------------------------------------------------------
#
# The two middle order statistics are adjacent ranks whose VALUES can
# straddle a wide distance gap (two balanced clusters), so every selector
# tracks one bracket PER RANK (see svgdcpp_tpu.ops.median for the full
# argument).


def two_rank_edges(lo1, hi1, lo2, hi2, num_edges: int, dtype):
    """Monotone squared-distance edge vector covering both rank brackets.

    Returns (edges (num_edges,), upd1, upd2); upd_r says whether bracket r
    is updated from this round's first-crossing selection:

    * overlapping brackets: uniform edges over the hull [lo1, hi2], both
      updated;
    * disjoint, num_edges >= 7: the edge budget splits between the two
      brackets, both updated;
    * disjoint, small budget: all refinement edges go to the WIDER bracket;
      the far end of the kept bracket still gets one edge so the global
      containment check holds.

    Requires num_edges >= 3.
    """
    e = num_edges
    idx = torch.arange(e, dtype=dtype, device=lo1.device)
    hull = lo1 + (hi2 - lo1) * idx / (e - 1)
    merged = lo2 <= hi1
    if e >= 7:
        h = (e + 1) // 2
        e_1 = lo1 + (hi1 - lo1) * idx / (h - 1)
        e_2 = lo2 + (hi2 - lo2) * (idx - h) / (e - 1 - h)
        split_edges = torch.where(idx < h, e_1, e_2)
        edges = torch.where(merged, hull, split_edges)
        always = torch.ones((), dtype=torch.bool, device=lo1.device)
        return edges, always, always
    width1 = hi1 - lo1
    width2 = hi2 - lo2
    refine1 = width1 >= width2
    # refine bracket 1: [lo1 .. hi1] uniformly, last edge at hi2
    e_a = torch.where(idx <= e - 2, lo1 + (hi1 - lo1) * idx / (e - 2), hi2)
    # refine bracket 2: first edge at lo1, [lo2 .. hi2] uniformly
    e_b = torch.where(idx == 0, lo1, lo2 + (hi2 - lo2) * (idx - 1) / (e - 2))
    split_edges = torch.where(refine1, e_a, e_b)
    edges = torch.where(merged, hull, split_edges)
    return edges, merged | refine1, merged | ~refine1


def _rank_interval(edges, cum, k):
    """First-crossing interval (edges[i-1], edges[i]] containing rank k.
    Only valid when cum[0] < k <= cum[-1] (checked by the caller)."""
    i = _first_true(cum >= k)
    lo = edges[torch.clamp_min(i - 1, 0)]
    return lo, edges[i]


def _select_two_ranks(edges, cum, k1, k2, upd1, upd2, lo1, hi1, lo2, hi2):
    """Per-rank interval update from one count pass over ``edges``; a
    bracket with upd_r False keeps its current interval."""
    s1_lo, s1_hi = _rank_interval(edges, cum, k1)
    s2_lo, s2_hi = _rank_interval(edges, cum, k2)
    return (
        torch.where(upd1, s1_lo, lo1),
        torch.where(upd1, s1_hi, hi1),
        torch.where(upd2, s2_lo, lo2),
        torch.where(upd2, s2_hi, hi2),
    )


def _refine_two_ranks(count_fn, k1, k2, lo1, hi1, lo2, hi2, *, bins: int,
                      passes: int):
    """Localize ranks k1 <= k2 with per-rank intervals (squared space).

    Returns (v1, v2, valid, (lo1, hi1, lo2, hi2)): v_r the final interval
    midpoints; ``valid`` (a device boolean) confirms both ranks were inside
    the initial brackets.
    """
    fdt = lo1.dtype
    valid = (hi1 > lo1) & (hi2 >= lo2) & (lo2 >= lo1)
    for p in range(passes):
        edges, upd1, upd2 = two_rank_edges(lo1, hi1, lo2, hi2, bins + 1, fdt)
        cum = count_fn(edges)
        if p == 0:
            # containment: k-th values must lie inside (edges[0], edges[-1]]
            valid = valid & (cum[0] < k1) & (cum[-1] >= k2)
        lo1, hi1, lo2, hi2 = _select_two_ranks(
            edges, cum, k1, k2, upd1, upd2, lo1, hi1, lo2, hi2
        )
    v1 = 0.5 * (lo1 + hi1)
    v2 = 0.5 * (lo2 + hi2)
    return v1, v2, valid, (lo1, hi1, lo2, hi2)


def _middle_ranks(total: int):
    """The reference's even/odd median ranks (GaussianRBFKernel.hpp:224-253):
    (total//2, total//2 + 1) averaged for even counts, the single middle
    rank twice for odd ones."""
    k1 = total // 2 if total % 2 == 0 else (total + 1) // 2
    k2 = total // 2 + 1 if total % 2 == 0 else k1
    return k1, k2


def pairwise_distance_median_bisect(
    coords: torch.Tensor,
    *,
    bins: int = 16,
    passes: int = 6,
    row_tile: int = 2048,
) -> torch.Tensor:
    """Near-exact median of all n^2 pairwise distances by count bisection
    of squared distances (each order statistic localized to bins**-passes
    of the range); even counts average both sqrt'ed middle ranks."""
    n = coords.shape[0]
    total = n * n
    count_fn, hi0 = centered_count_env(coords, row_tile=row_tile)
    ks = (total // 2, total // 2 + 1) if total % 2 == 0 else ((total + 1) // 2,)
    mids = kth_smallest_bisect(count_fn, ks, 0.0, hi0, bins=bins, passes=passes)
    return torch.mean(torch.sqrt(mids))


# ----------------------------------------------------------------------
# Hybrid sample-bracket + count-verify selection
# ----------------------------------------------------------------------


def _sampled_pair_sq_dists(coords: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Squared distances of a deterministic low-discrepancy pair subsample:
    two odd golden-ratio strides mod n, built in uint64 on the host,
    bit for bit the JAX package's indices."""
    n = coords.shape[0]
    ks = np.arange(num_samples, dtype=np.uint64)
    stride_i = np.uint64(int(n * 0.6180339887498949) | 1)
    stride_j = np.uint64(int(n * 0.7548776662466927) | 1)
    i_np = ((ks * stride_i) % np.uint64(n)).astype(np.int64)
    j_np = ((ks * stride_j + ks // np.uint64(max(n, 1))) % np.uint64(n)).astype(
        np.int64
    )
    i = torch.from_numpy(i_np).to(coords.device)
    j = torch.from_numpy(j_np).to(coords.device)
    diff = coords[i] - coords[j]
    return torch.sum(diff * diff, dim=1)


def median_sq_bracket_from_sample(coords: torch.Tensor, num_samples: int,
                                  margin_sigmas: float = 8.0):
    """[lo, hi] squared-distance bracket believed to contain the median:
    the global median's sample rank is Binomial(M, 1/2), bracketed at
    +/- margin_sigmas * sqrt(M)/2 sample ranks."""
    sq = _sampled_pair_sq_dists(coords, num_samples)
    s = torch.sort(sq).values
    half_width = int(margin_sigmas * (num_samples ** 0.5) / 2.0) + 1
    r_lo = max(num_samples // 2 - half_width, 0)
    r_hi = min(num_samples // 2 + half_width, num_samples - 1)
    return s[r_lo], s[r_hi]


def _full_bisect_two_ranks(count_fn, total: int, hi0, *, bins: int,
                           passes: int):
    """Cold-start fallback: full-range per-rank bisection of both middle
    order statistics. Returns (median_distance, (lo1, hi1, lo2, hi2)) with
    the brackets in DISTANCE space, slack-expanded so they contain the
    order statistics."""
    k1, k2 = _middle_ranks(total)
    ks = (k1, k2) if k2 != k1 else (k1,)
    mids, lo_sq, hi_sq = kth_smallest_bisect_intervals(
        count_fn, ks, 0.0, hi0, bins=bins, passes=passes
    )
    med = torch.mean(torch.sqrt(mids))
    slack = hi0 / (float(bins) ** passes)
    lo_d = torch.sqrt(torch.clamp_min(lo_sq - slack, 0.0))
    hi_d = torch.sqrt(hi_sq + slack)
    return med, (lo_d[0], hi_d[0], lo_d[-1], hi_d[-1])


def pairwise_distance_median_hybrid(
    coords: torch.Tensor,
    *,
    num_samples: int = 1 << 16,
    bins: int = 16,
    passes: int = 2,
    row_tile: int = 2048,
    fallback_bins: int = 16,
    fallback_passes: int = 6,
) -> torch.Tensor:
    """Near-exact scalable median: sample bracket + count-verified refine,
    falling back to the full-range bisection when the check fails."""
    n = coords.shape[0]
    total = n * n
    k1, k2 = _middle_ranks(total)
    count_fn, hi0, centered = centered_count_env(
        coords, row_tile=row_tile, return_centered=True
    )
    lo_s, hi_s = median_sq_bracket_from_sample(centered, min(num_samples, total))
    fdt = SELECT_DTYPE
    lo_s = lo_s.to(fdt)
    hi_s = torch.maximum(hi_s.to(fdt), lo_s * (1 + 1e-6) + 1e-30)

    v1, v2, valid, (r1l, r1h, r2l, r2h) = _refine_two_ranks(
        count_fn, k1, k2, lo_s, hi_s, lo_s, hi_s, bins=bins, passes=passes
    )
    # Resolution gate: a median straddling a distance gap can leave one
    # rank's interval coarse; take the exact bisection then.
    valid = valid & ((r1h - r1l) <= 2e-3 * v1 + 1e-30)
    valid = valid & ((r2h - r2l) <= 2e-3 * v2 + 1e-30)
    if bool(valid):
        return 0.5 * (torch.sqrt(v1) + torch.sqrt(v2))
    med, _ = _full_bisect_two_ranks(
        count_fn, total, hi0, bins=fallback_bins, passes=fallback_passes
    )
    return med


# ----------------------------------------------------------------------
# Warm-started selection (temporal coherence across SVGD steps)
# ----------------------------------------------------------------------


def warm_median_select(
    count_fn,
    total: int,
    hi0,
    lo1_d,
    hi1_d,
    lo2_d,
    hi2_d,
    max_disp,
    *,
    sample_bracket_fn=None,
    bins: int = 16,
    passes: int = 2,
    warm_bins: int = 8,
    warm_passes: int = 1,
    fallback_bins: int = 16,
    fallback_passes: int = 6,
):
    """count_fn-generic warm-started median selection.

    Every particle moved at most ``max_disp``, so every pairwise distance
    (and every order statistic) moved at most 2 * max_disp: the previous
    PER-RANK intervals padded by that bound bracket the new ones. The count
    pass verifies containment; on failure the sample bracket (when
    ``sample_bracket_fn`` is given) and then the full [0, hi0] bisection
    take over. Pass empty brackets (hi < lo) on the first step.

    Returns (median_distance, lo1, hi1, lo2, hi2), brackets in DISTANCE
    space.
    """
    k1, k2 = _middle_ranks(total)
    fdt = SELECT_DTYPE

    # Sentinel check BEFORE any arithmetic: squaring a negative hi would
    # manufacture a plausible-looking bracket.
    bracket_initialized = (hi1_d >= lo1_d) & (hi2_d >= lo2_d)
    pad = 2.0 * max_disp + 1e-12
    lo1 = torch.clamp_min(lo1_d - pad, 0.0).to(fdt)
    hi1 = torch.clamp_min(hi1_d + pad, 0.0).to(fdt)
    lo2 = torch.clamp_min(lo2_d - pad, 0.0).to(fdt)
    hi2 = torch.clamp_min(hi2_d + pad, 0.0).to(fdt)
    v1, v2, warm_valid, (f1l, f1h, f2l, f2h) = _refine_two_ranks(
        count_fn, k1, k2, lo1 * lo1, hi1 * hi1, lo2 * lo2, hi2 * hi2,
        bins=warm_bins, passes=warm_passes,
    )
    warm_valid = warm_valid & bracket_initialized

    if bool(warm_valid):
        med = 0.5 * (torch.sqrt(v1) + torch.sqrt(v2))
        return (
            med,
            torch.sqrt(torch.clamp_min(f1l, 0.0)), torch.sqrt(f1h),
            torch.sqrt(torch.clamp_min(f2l, 0.0)), torch.sqrt(f2h),
        )

    if sample_bracket_fn is not None:
        lo_s, hi_s = sample_bracket_fn()
        lo_s = lo_s.to(fdt)
        hi_s = torch.maximum(hi_s.to(fdt), lo_s * (1 + 1e-6) + 1e-30)
        c_v1, c_v2, c_valid, (c1l, c1h, c2l, c2h) = _refine_two_ranks(
            count_fn, k1, k2, lo_s, hi_s, lo_s, hi_s, bins=bins, passes=passes,
        )
        # Same resolution gate as the hybrid one-shot.
        c_valid = c_valid & ((c1h - c1l) <= 2e-3 * c_v1 + 1e-30)
        c_valid = c_valid & ((c2h - c2l) <= 2e-3 * c_v2 + 1e-30)
        if bool(c_valid):
            med = 0.5 * (torch.sqrt(c_v1) + torch.sqrt(c_v2))
            return (
                med,
                torch.sqrt(torch.clamp_min(c1l, 0.0)), torch.sqrt(c1h),
                torch.sqrt(torch.clamp_min(c2l, 0.0)), torch.sqrt(c2h),
            )

    med, (b1l, b1h, b2l, b2h) = _full_bisect_two_ranks(
        count_fn, total, hi0, bins=fallback_bins, passes=fallback_passes
    )
    return med, b1l, b1h, b2l, b2h


def pairwise_distance_median_warm(
    coords: torch.Tensor,
    lo1_d: torch.Tensor,
    hi1_d: torch.Tensor,
    lo2_d: torch.Tensor,
    hi2_d: torch.Tensor,
    max_disp: torch.Tensor,
    *,
    num_samples: int = 1 << 16,
    bins: int = 16,
    passes: int = 2,
    warm_passes: int = 1,
    warm_bins: int = 8,
    row_tile: int = 2048,
):
    """Single-device warm-started pairwise-distance median (see
    :func:`warm_median_select`)."""
    n = coords.shape[0]
    total = n * n
    count_fn, hi0, centered = centered_count_env(
        coords, row_tile=row_tile, return_centered=True
    )

    def sample_bracket_fn():
        return median_sq_bracket_from_sample(centered, min(num_samples, total))

    return warm_median_select(
        count_fn, total, hi0, lo1_d, hi1_d, lo2_d, hi2_d, max_disp,
        sample_bracket_fn=sample_bracket_fn,
        bins=bins, passes=passes, warm_bins=warm_bins, warm_passes=warm_passes,
    )


def fused_median_from_counts(
    counts,
    sel,
    total: int,
    count_env,
    *,
    initialized,
    fallback_bins: int = 16,
    fallback_passes: int = 6,
):
    """Median update from the counts a fused phi sweep already produced.

    ``counts`` are cumulative int64 pair counts at the squared-distance
    edges of a :func:`fused_lag1_plan` (``sel``): what ONE warm refinement
    pass would have measured. If the brackets did not contain both middle
    order statistics, a full count-bisection on the current coordinates
    recovers exactly. ``count_env`` is a callable returning its
    ``(count_fn, hi0)``: :func:`centered_count_env` of the coordinates, or
    of this rank's rows and the group on the sharded engine. The JAX
    package takes the env's ``(count_fn, hi0)`` itself; here the check is
    read on the host, so the env is built only when the fallback runs.

    Returns (median_distance, lo1, hi1, lo2, hi2, fell_back): the JAX
    package's five values in DISTANCE space, and whether the bisection
    fallback ran (the check is read on the host anyway, so the caller can
    count fallbacks for free).
    """
    k1, k2 = _middle_ranks(total)
    fdt = SELECT_DTYPE
    cum = counts
    edges = sel["edges"]
    valid = (
        torch.as_tensor(initialized)
        & (edges[-1] > edges[0])
        & (cum[0] < k1)
        & (cum[-1] >= k2)
    )
    if bool(valid):
        lo1, hi1, lo2, hi2 = _select_two_ranks(
            edges, cum, k1, k2, sel["upd1"], sel["upd2"],
            sel["lo1_sq"], sel["hi1_sq"], sel["lo2_sq"], sel["hi2_sq"],
        )
        med = 0.5 * (torch.sqrt(0.5 * (lo1 + hi1)) + torch.sqrt(0.5 * (lo2 + hi2)))
        return (
            med.to(fdt),
            torch.sqrt(torch.clamp_min(lo1, 0.0)).to(fdt),
            torch.sqrt(hi1).to(fdt),
            torch.sqrt(torch.clamp_min(lo2, 0.0)).to(fdt),
            torch.sqrt(hi2).to(fdt),
            False,
        )
    count_fn, hi0 = count_env()
    med, (b1l, b1h, b2l, b2h) = _full_bisect_two_ranks(
        count_fn, total, hi0, bins=fallback_bins, passes=fallback_passes
    )
    return (
        med.to(fdt), b1l.to(fdt), b1h.to(fdt), b2l.to(fdt), b2h.to(fdt), True
    )


# ----------------------------------------------------------------------
# Dispatch
# ----------------------------------------------------------------------

#: Above this particle count the exact full-sort median switches to the
#: hybrid selector. The JAX package's crossover, kept so that both packages
#: pick the same selector at the same n; not yet measured on the card.
#: Force ``median_method='exact'`` for strict reference parity at any n.
EXACT_MEDIAN_MAX_PARTICLES = 512


def pairwise_distance_median(coords: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """Median pairwise distance with automatic exact/hybrid dispatch.

    'warm' behaves like 'auto' for one-shot calls: the warm bracket only
    exists inside the SVGD step loop.
    """
    if method == "warm":
        method = "auto"
    n = coords.shape[0]
    if method == "exact" or (method == "auto" and n <= EXACT_MEDIAN_MAX_PARTICLES):
        return pairwise_distance_median_exact(coords)
    if method in ("hybrid", "auto"):
        return pairwise_distance_median_hybrid(coords)
    if method == "bisect":
        return pairwise_distance_median_bisect(coords)
    if method == "histogram":
        raise NotImplementedError(
            "median_method='histogram' is not ported yet (ROADMAP.md, "
            "slice 6, item 12: the parity-only histogram selector)."
        )
    raise ValueError(f"unknown median method: {method!r}")


def fused_median_seed(coords: torch.Tensor, method: str = "auto",
                      med=None) -> dict:
    """{med, lo1, hi1, lo2, hi2, disp} seed for the fused phi+median sweep:
    the INITIAL positions' median with tight per-rank brackets that the
    per-step movement bound then expands. ``med`` is that median where the
    caller already took it on these coordinates with this method."""
    if med is None:
        med = pairwise_distance_median(coords, method)
    med = torch.as_tensor(med, dtype=SELECT_DTYPE)
    return {
        "med": med,
        "lo1": med * (1.0 - 1e-3),
        "hi1": med * (1.0 + 1e-3),
        "lo2": med * (1.0 - 1e-3),
        "hi2": med * (1.0 + 1e-3),
        "disp": torch.zeros((), dtype=SELECT_DTYPE, device=med.device),
    }


def fused_lag1_plan(aux, n_total, fused_bins, compute_dtype):
    """Lag-1 scale + selection-edge plan for the fused phi+median sweep.

    ``aux`` carries {med, lo1, hi1, lo2, hi2, disp}: the previous step's
    verified median (this step's bandwidth, gamma = log(n)/med^2) and the
    per-rank distance brackets. Each bracket is expanded by the movement
    bound 2*disp and ``fused_bins + 1`` squared-distance edges are laid over
    them by :func:`two_rank_edges`. Returns ``(gamma, sel)``: gamma a 0-d
    device tensor in ``compute_dtype`` (never a host float, so the sweep
    reads it without a sync) and ``sel["edges"]`` the sweep's thresholds.
    """
    med = aux["med"]
    fdt = med.dtype
    gamma = (math.log(float(n_total)) / (med * med)).to(compute_dtype)
    pad_d = 2.0 * aux["disp"] + 1e-12
    lo1 = torch.clamp_min(aux["lo1"] - pad_d, 0.0)
    hi1 = torch.clamp_min(aux["hi1"] + pad_d, 0.0)
    lo2 = torch.clamp_min(aux["lo2"] - pad_d, 0.0)
    hi2 = torch.clamp_min(aux["hi2"] + pad_d, 0.0)
    lo1_sq, hi1_sq = lo1 * lo1, hi1 * hi1
    lo2_sq, hi2_sq = lo2 * lo2, hi2 * hi2
    edges, upd1, upd2 = two_rank_edges(
        lo1_sq, hi1_sq, lo2_sq, hi2_sq, fused_bins + 1, fdt
    )
    sel = {
        "edges": edges,
        "upd1": upd1,
        "upd2": upd2,
        "lo1_sq": lo1_sq,
        "hi1_sq": hi1_sq,
        "lo2_sq": lo2_sq,
        "hi2_sq": hi2_sq,
    }
    return gamma, sel


def centered_count_env(coords, sources_global=None, *, group=None,
                       n_global=None, row_tile: int = 2048,
                       return_centered: bool = False):
    """(count_fn, hi0) for pairwise-distance selection on ``coords``.

    Single definition of two float32 guards: global-mean centering of the
    Gram identity, and the full-range squared-distance bound
    ``hi0 = 4 * max||x - mean||^2 * (1 + 1e-6) + 1e-30`` on the CENTERED
    norms.

    Single-device (``group`` None): ``coords`` is the full set. Sharded:
    ``coords`` is this rank's rows, ``sources_global`` the gathered global
    set and ``group`` the particle group (``parallel/mesh.ParticleGroup``):
    the center is the global mean (summed over the group), hi0 takes the
    group's max of the local centered norms, and count_fn counts the local
    rows against the centered sources and sums the int64 counts over the
    group, so every rank gets the same global counts.
    """
    if group is None:
        centered = coords - coords.mean(dim=0)
        hi0 = (
            4.0 * torch.max(torch.sum(centered * centered, dim=1))
            * (1.0 + 1e-6) + 1e-30
        )

        def count_fn(thr):
            return count_le_cross(centered, centered, thr, row_tile=row_tile)

        if return_centered:
            return count_fn, hi0, centered
        return count_fn, hi0
    center = group.all_reduce_sum(torch.sum(coords, dim=0)) / n_global
    centered_local = coords - center
    local_max = torch.max(torch.sum(centered_local * centered_local, dim=1))
    hi0 = 4.0 * group.all_reduce_max(local_max) * (1.0 + 1e-6) + 1e-30
    sources_centered = sources_global - center

    def count_fn(thr):
        return group.all_reduce_sum(count_le_cross(
            centered_local, sources_centered, thr, row_tile=row_tile
        ))

    return count_fn, hi0
