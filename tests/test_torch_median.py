"""svgdcpp_tpu_torch median selection against svgdcpp_tpu.

Data (numpy, seeded): unimodal, a balanced bimodal set whose two middle
order statistics straddle a distance gap (the hybrid's resolution gate
fails there and the bisection fallback runs), and an off-origin cluster at
+1e4. float64 on both sides. Medians and brackets: rtol 1e-12. Counts:
exactly equal (the JAX package's float32 counts are exact at these sizes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgdcpp_tpu.ops import median as mj
from svgdcpp_tpu_torch.ops import median as mt

# The suite runs several xdist workers on one CPU: torch's default of an
# OpenMP thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

RTOL = 1e-12


def assert_close(got, want, rtol=RTOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-300)


def make(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "unimodal":
        return rng.normal(size=(n, 2))
    if kind == "bimodal":
        half = n // 2
        return np.concatenate(
            [rng.normal(size=(half, 2)),
             rng.normal(size=(n - half, 2)) + np.array([25.0, 0.0])]
        )
    return rng.normal(size=(n, 2)) * 0.5 + 1e4  # off-origin


KINDS = ["unimodal", "bimodal", "offset"]


def both(x):
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("n", [7, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_exact_median(kind, n):
    xj, xt = both(make(kind, n))
    assert_close(
        mt.pairwise_distance_median_exact(xt),
        mj.pairwise_distance_median_exact(xj),
        rtol=1e-9 if kind == "offset" else RTOL,
    )
    v = make("unimodal", n, seed=3)[:, 0]
    assert_close(mt.median_exact(torch.from_numpy(v)), mj.median_exact(jnp.asarray(v)))
    assert_close(
        mt.median_exact(torch.from_numpy(v[:-1])), mj.median_exact(jnp.asarray(v[:-1]))
    )


@pytest.mark.parametrize("n", [64, 600])
@pytest.mark.parametrize("kind", KINDS)
def test_bisect_median(kind, n):
    xj, xt = both(make(kind, n))
    assert_close(
        mt.pairwise_distance_median_bisect(xt),
        mj.pairwise_distance_median_bisect(xj),
    )


@pytest.mark.parametrize("n", [600, 1500])
@pytest.mark.parametrize("kind", KINDS)
def test_hybrid_median(kind, n):
    xj, xt = both(make(kind, n))
    assert_close(
        mt.pairwise_distance_median_hybrid(xt),
        mj.pairwise_distance_median_hybrid(xj),
    )
    assert_close(mt.pairwise_distance_median(xt), mj.pairwise_distance_median(xj))


@pytest.mark.parametrize("kind", KINDS)
def test_warm_median_cold_and_warm(kind):
    x = make(kind, 600)
    moved = x + np.random.default_rng(7).normal(size=x.shape) * 1e-3
    xj, xt = both(moved)
    cold = (0.0, -1.0, 0.0, -1.0, 0.0)
    med = float(mj.pairwise_distance_median_exact(jnp.asarray(x)))
    warm = (med * 0.999, med * 1.001, med * 0.999, med * 1.001, 2e-3)
    for lo1, hi1, lo2, hi2, disp in (cold, warm):
        args = [np.asarray(v, np.float64) for v in (lo1, hi1, lo2, hi2, disp)]
        out_j = mj.pairwise_distance_median_warm(xj, *map(jnp.asarray, args))
        out_t = mt.pairwise_distance_median_warm(xt, *map(torch.from_numpy, args))
        for a, b in zip(out_t, out_j):
            assert_close(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_count_le_cross(kind):
    x = make(kind, 300)
    y = make(kind, 170, seed=1)
    thr = np.quantile(np.sum((x[:40, None] - y[None, :40]) ** 2, -1), [0.1, 0.5, 0.9])
    thr = np.concatenate([[0.0], thr, [1e9]])
    got = mt.count_le_cross(torch.from_numpy(x), torch.from_numpy(y),
                            torch.from_numpy(thr), row_tile=64)
    want = mj.count_le_cross(jnp.asarray(x), jnp.asarray(y), jnp.asarray(thr),
                             row_tile=64)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def _seed_pair(x):
    seed_j = mj.fused_median_seed(jnp.asarray(x))
    seed_t = mt.fused_median_seed(torch.from_numpy(x))
    for key in seed_j:
        assert_close(seed_t[key], seed_j[key])
    return seed_j, seed_t


@pytest.mark.parametrize("fused_bins", [2, 3, 7])
@pytest.mark.parametrize("disjoint", [False, True])
def test_fused_lag1_plan(fused_bins, disjoint):
    x = make("unimodal", 64)
    seed_j, seed_t = _seed_pair(x)
    if disjoint:  # per-rank brackets that do not overlap (a distance gap)
        for seed in (seed_j, seed_t):
            seed["hi1"] = seed["med"] * 0.9
            seed["lo2"] = seed["med"] * 1.1
            seed["hi2"] = seed["med"] * 1.5
    for seed in (seed_j, seed_t):
        seed["disp"] = seed["disp"] + 1e-3
    gj, sel_j = mj.fused_lag1_plan(seed_j, 64, fused_bins, jnp.float64)
    gt, sel_t = mt.fused_lag1_plan(seed_t, 64, fused_bins, torch.float64)
    assert_close(gt, gj)
    for key in sel_j:
        if key.startswith("upd"):
            assert bool(sel_t[key]) == bool(sel_j[key])
        else:
            assert_close(sel_t[key], sel_j[key])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("initialized", [True, False])
def test_fused_median_from_counts(kind, initialized):
    """Bracket valid: the median comes from the counts. Forced invalid
    (``initialized=False``): the bisection fallback runs, and the port
    reports that it did."""
    n = 600
    x = make(kind, n)
    moved = x + np.random.default_rng(5).normal(size=x.shape) * 1e-3
    seed_j, seed_t = _seed_pair(x)
    for seed in (seed_j, seed_t):
        seed["disp"] = seed["disp"] + 2e-3
    _, sel_j = mj.fused_lag1_plan(seed_j, n, 2, jnp.float64)
    _, sel_t = mt.fused_lag1_plan(seed_t, n, 2, torch.float64)
    xj, xt = both(moved)
    fn_j, hi0_j = mj.centered_count_env(xj)
    fn_t, hi0_t = mt.centered_count_env(xt)
    assert_close(hi0_t, hi0_j)
    counts_j = fn_j(sel_j["edges"])
    counts_t = fn_t(sel_t["edges"])
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j).astype(np.int64))
    out_j = mj.fused_median_from_counts(
        counts_j, sel_j, n * n, fn_j, hi0_j, initialized=initialized
    )
    *out_t, fell_back = mt.fused_median_from_counts(
        counts_t, sel_t, n * n, lambda: mt.centered_count_env(xt),
        initialized=initialized,
    )
    for a, b in zip(out_t, out_j):
        assert_close(a, b)
    if not initialized:
        assert fell_back
    elif kind != "bimodal":
        assert not fell_back


def test_dispatch_and_unported_methods():
    x = torch.from_numpy(make("unimodal", 64))
    assert_close(mt.pairwise_distance_median(x, "warm"),
                 mt.pairwise_distance_median(x, "exact"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mt.pairwise_distance_median(x, "histogram")
    with pytest.raises(ValueError, match="unknown median method"):
        mt.pairwise_distance_median(x, "nope")
