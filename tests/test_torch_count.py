"""The count pass of svgdcpp_tpu_torch (K16's port) against svgdcpp_tpu.

* ``ops/median.count_le_cross`` on CPU tensors (the plain pass) against the
  JAX package's ``count_le_pallas`` in interpret mode and its
  ``count_le_cross``: square and cross forms, m in {2, 5, 11}, float32
  inputs on a 1/8 grid with thresholds halfway between multiples of 1/64,
  where the Gram and the difference forms are both exact: counts equal.
  On continuous float64 inputs against the JAX ``count_le_cross``: equal.
* The kernel's wrapper ``cuda_phi.count_le_cuda`` on CPU tensors is the
  plain pass and leaves the launch counter untouched; on a tensor that is
  neither on the CPU nor on a CUDA device it raises: no fallback.
* More thresholds than one kernel launch takes (COUNT_MAX_T) and unsorted
  ones count as the plain pass does.
* One set as rows and columns (the single-device median's every pass):
  the wrapper's CPU branch, the plain pass, against the brute-force
  2U + diag and ``count_le_pallas`` on ragged n with awkward thresholds;
  the wrapper's dispatch to the kernel's self and cross entries through a
  stand-in library; the sorted launches (``count_batches``) and the bin
  ending (``counts_from_bins``) giving counts in the caller's order.
"""

from contextlib import nullcontext
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgdcpp_tpu.ops import median as mdj
from svgdcpp_tpu.ops import pallas_phi as pj
from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.ops import median as mdt

# The suite runs several xdist workers on one CPU: torch's default of an
# OpenMP thread per core in each of them oversubscribes it.
torch.set_num_threads(1)


def grid_points(n, m, seed, offset=0.0):
    """float32 points on a 1/8 grid, symmetric about ``offset`` (each row's
    mirror image is a row too, so the mean is the offset exactly)."""
    rng = np.random.default_rng(seed)
    half = np.round(rng.normal(size=(n // 2, m)) * 8.0) / 8.0
    rows = [half, -half] + ([np.zeros((1, m))] if n % 2 else [])
    x = np.concatenate(rows)[rng.permutation(n)] + offset
    return x.astype(np.float32)


def grid_thresholds(x, y, count, seed):
    """Thresholds halfway between multiples of 1/64 at pair-distance
    quantiles, so no squared distance on the grid lies at one."""
    rng = np.random.default_rng(seed)
    i = rng.integers(0, x.shape[0], 2048)
    j = rng.integers(0, y.shape[0], 2048)
    sq = np.sum((x[i].astype(np.float64) - y[j]) ** 2, axis=1)
    q = np.quantile(sq, np.linspace(0.05, 0.95, count))
    return ((np.floor(q * 64.0) + 0.5) / 64.0).astype(np.float32)


@pytest.mark.parametrize("n_r,n_c,m,offset", [
    (300, 300, 2, 0.0), (257, 300, 2, 4.0), (300, 300, 5, 0.0),
    (200, 333, 11, 2.0),
])
def test_count_le_cross_vs_count_le_pallas_interpret(n_r, n_c, m, offset):
    x = grid_points(n_r, m, 10 + m, offset)
    y = x if n_r == n_c else grid_points(n_c, m, 20 + m, offset)
    thr = grid_thresholds(x, y, 5, 30 + m)
    want = np.asarray(pj.count_le_pallas(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(thr), num_thresholds=5,
        tile_i=64, tile_j=128, interpret=True,
    )).astype(np.int64)
    want_xla = np.asarray(mdj.count_le_cross(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(thr), row_tile=64
    )).astype(np.int64)
    cuda_phi.reset_launch_counts()
    got = mdt.count_le_cross(torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(thr), row_tile=64)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want_xla)
    assert cuda_phi.launch_counts[cuda_phi.COUNT_KERNEL] == 0


@pytest.mark.parametrize("m", [2, 7])
def test_count_le_cross_f64_vs_jax(m):
    rng = np.random.default_rng(40 + m)
    x = rng.normal(size=(211, m)) * 3.0 + 10.0
    y = rng.normal(size=(150, m)) * 2.0 + 9.0
    thr = np.asarray([0.5, 4.0, 2.0 * m, 30.0, 1e3])
    want = np.asarray(mdj.count_le_cross(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(thr), row_tile=50
    )).astype(np.int64)
    got = mdt.count_le_cross(torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(thr), row_tile=50)
    np.testing.assert_array_equal(got.numpy(), want)


def test_count_wrapper_on_cpu_is_the_plain_pass():
    x = torch.from_numpy(grid_points(120, 3, 1))
    y = torch.from_numpy(grid_points(90, 3, 2))
    # unsorted, and more than one launch takes
    thr = torch.linspace(0.1, 20.0, cuda_phi.COUNT_MAX_T + 7).flip(0)
    cuda_phi.reset_launch_counts()
    got = cuda_phi.count_le_cuda(x, y, thr)
    np.testing.assert_array_equal(got.numpy(),
                                  mdt.count_le_plain(x, y, thr).numpy())
    sq = torch.cdist(x.double(), y.double()) ** 2
    want = torch.stack([(sq <= t).sum() for t in thr.double()])
    assert int((got - want).abs().max()) <= 2  # ties within float32 rounding
    assert not any(cuda_phi.launch_counts.values())
    assert not cuda_phi.library_loaded()


def test_count_le_cross_never_falls_back():
    x = torch.empty((8, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        mdt.count_le_cross(x, x, torch.empty(3, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_phi.count_le_cuda(x, x, torch.empty(3, device="meta"))
    assert not cuda_phi.library_loaded()


def test_median_selectors_count_through_count_le_cross(monkeypatch):
    """The hybrid median, the warm median and the fused fallback count
    through ``count_le_cross`` (so through K16 on the card)."""
    calls = []
    real = mdt.count_le_cross

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(mdt, "count_le_cross", spy)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(700, 2)))
    med = mdt.pairwise_distance_median(x, "hybrid")
    exact = mdt.pairwise_distance_median_exact(x)
    assert abs(float(med) - float(exact)) <= 1e-3 * float(exact)
    assert calls


# ----------------------------------------------------------------------
# One set as rows and columns, and the sorted launches
# ----------------------------------------------------------------------


def brute_counts(x, y, thr):
    """Counts of |x_i - y_j|^2 <= t in float64 by broadcasting, in the
    order of ``thr``."""
    sq = ((x[:, None, :].double() - y[None, :, :].double()) ** 2).sum(-1)
    return torch.stack([(sq <= t).sum() for t in thr.double()])


def awkward_thresholds(x, count, seed):
    """Grid thresholds at pair quantiles, then shuffled, with duplicates,
    one below 0 and one above the largest sq."""
    t = grid_thresholds(x, x, count, seed)
    rng = np.random.default_rng(seed)
    largest = 4.0 * float(np.max(np.sum((x - x.mean(0)) ** 2, axis=1)))
    t = np.concatenate([t, t[::3], [-1.5, largest + 1.0]])
    return torch.from_numpy(rng.permutation(t).astype(np.float32))


@pytest.mark.parametrize("n,m,offset,row_tile", [
    (1, 2, 0.0, 8), (97, 1, 3.0, 16), (301, 2, 5.0, 64), (257, 4, -2.0, 40),
    (203, 5, 1.0, 32), (150, 11, 2.0, 64),
])
def test_one_set_counts_two_upper_plus_diagonal(n, m, offset, row_tile):
    """One set as rows and columns, through the wrapper's CPU branch (the
    plain pass, over row tiles of ``row_tile``) on ragged n off origin:
    the brute-force 2U + diag, which the kernel's self entry forms, and
    the JAX count_le_pallas in interpret mode, with unsorted, duplicate,
    negative and past-the-largest thresholds."""
    x = grid_points(n, m, 50 + m, offset)
    thr = awkward_thresholds(x, 7, 60 + m)
    xt = torch.from_numpy(x)
    got = cuda_phi.count_le_cuda(xt, xt, thr)
    np.testing.assert_array_equal(
        got.numpy(), mdt.count_le_plain(xt, xt, thr, row_tile=row_tile).numpy())
    sq = ((xt[:, None, :].double() - xt[None, :, :].double()) ** 2).sum(-1)
    upper = torch.triu(torch.ones(n, n, dtype=torch.bool), diagonal=1)
    diag = torch.eye(n, dtype=torch.bool)
    want = torch.stack([2 * ((sq <= t) & upper).sum() + ((sq <= t) & diag).sum()
                        for t in thr.double()])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jax_counts = np.asarray(pj.count_le_pallas(
        jnp.asarray(x), jnp.asarray(x), jnp.asarray(thr.numpy()),
        num_thresholds=thr.shape[0], tile_i=64, tile_j=128, interpret=True,
    )).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), jax_counts)


@pytest.mark.parametrize("count", [1, 3, 17, 32, 33, 70])
def test_count_batches_return_the_callers_order(count):
    """count_batches: COUNT_MAX_T thresholds a launch, each launch's sorted
    ascending with its int32 order; a launch that adds the count of its
    t-th threshold at t0 + order[t] (as the kernel does, from per-threshold
    counters or from a bin histogram, counts_from_bins) gives every count
    in the caller's order, duplicates and unsorted batches included."""
    x = torch.from_numpy(grid_points(90, 2, 7, 1.0))
    rng = np.random.default_rng(count)
    base = rng.uniform(-0.5, 12.0, size=(count + 1) // 2)
    thr = torch.from_numpy(rng.permutation(
        np.concatenate([base, base])[:count]).astype(np.float32))
    want = brute_counts(x, x, thr)
    by_counter = torch.zeros(count, dtype=torch.int64)
    by_bins = torch.zeros(count, dtype=torch.int64)
    launches = list(cuda_phi.count_batches(thr))
    assert [t0 for t0, _, _ in launches] == list(
        range(0, count, cuda_phi.COUNT_MAX_T))
    sq = ((x[:, None, :].double() - x[None, :, :].double()) ** 2).sum(-1)
    for t0, part, order in launches:
        assert order.dtype == torch.int32
        assert bool((part[1:] >= part[:-1]).all())
        np.testing.assert_array_equal(
            part.numpy(), thr[t0:t0 + cuda_phi.COUNT_MAX_T][order.long()])
        for t in range(part.shape[0]):
            by_counter[t0 + order[t]] += int((sq <= part[t].double()).sum())
        bins = torch.bucketize(sq.float(), part)
        hist = torch.bincount(bins.reshape(-1), minlength=part.shape[0] + 1)
        by_bins[t0:t0 + part.shape[0]] = mdt.counts_from_bins(hist,
                                                              order.long())
    np.testing.assert_array_equal(by_counter.numpy(), want.numpy())
    np.testing.assert_array_equal(by_bins.numpy(), want.numpy())


def _standin_library(monkeypatch):
    """A library that records which count entry each launch takes (meta
    tensors stand in for the card)."""
    launched = []

    class Library:
        def svgd_count_le_self(self, x, thr, order, n, m, t, counts, stream):
            launched.append(("self", n, m, t))
            return 0

        def svgd_count_le_cross(self, rows, cols, thr, order, n_r, n_c, m,
                                t, counts, stream):
            launched.append(("cross", n_r, n_c, m, t))
            return 0

    monkeypatch.setattr(cuda_phi, "_require_cuda", lambda tensor: None)
    monkeypatch.setattr(cuda_phi, "load_library", Library)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    cuda_phi.reset_launch_counts()
    return launched


@pytest.mark.parametrize("m", [2, 11, 65])
def test_count_wrapper_takes_the_self_entry_for_one_set(monkeypatch, m):
    """The same tensor as rows and columns takes svgd_count_le_self (the
    triangle; the C side keeps the cross form past MAX_M), a clone of it
    svgd_count_le_cross; 33 thresholds take two launches of 32 and 1."""
    launched = _standin_library(monkeypatch)
    x = torch.empty((300, m), device="meta")
    thr = torch.empty((cuda_phi.COUNT_MAX_T + 1,), device="meta")
    cuda_phi.count_le_cuda(x, x, thr)
    cuda_phi.count_le_cuda(x, x.clone(), thr[:5])
    assert launched == [("self", 300, m, 32), ("self", 300, m, 1),
                        ("cross", 300, 300, m, 5)]
    assert cuda_phi.launch_counts[cuda_phi.COUNT_KERNEL] == 3
    cuda_phi.reset_launch_counts()


def test_the_medians_count_envs_pick_their_entries(monkeypatch):
    """The single-device median's count env passes its centered set as both
    rows and columns (the self entry); the sharded engine's env counts the
    local rows against the gathered sources (the cross entry)."""
    launched = _standin_library(monkeypatch)
    x = torch.empty((400, 2), device="meta")
    thr = torch.empty((17,), device="meta")
    count_fn, _ = mdt.centered_count_env(x)
    count_fn(thr)
    group = SimpleNamespace(all_reduce_sum=lambda v: v,
                            all_reduce_max=lambda v: v)
    local = torch.empty((200, 2), device="meta")
    count_fn, _ = mdt.centered_count_env(local, x, group=group, n_global=400)
    count_fn(thr)
    assert launched == [("self", 400, 2, 17), ("cross", 200, 400, 2, 17)]
    cuda_phi.reset_launch_counts()


@pytest.mark.parametrize("m", [11, 64, 65])
def test_count_wrapper_on_cpu_takes_the_plain_pass(monkeypatch, m):
    """On CPU tensors the wrapper runs the plain pass for one set and for
    two alike, at any m; one set counts as its clone does."""
    calls = []
    real = mdt.count_le_plain
    monkeypatch.setattr(cuda_phi, "count_le_plain",
                        lambda *a, **k: calls.append(m) or real(*a, **k))
    x = torch.from_numpy(grid_points(130, m, 3, 2.0))
    thr = awkward_thresholds(x.numpy(), 9, 4)
    got = cuda_phi.count_le_cuda(x, x, thr)
    cross = cuda_phi.count_le_cuda(x, x.clone(), thr)
    assert calls == [m, m]
    np.testing.assert_array_equal(got.numpy(), cross.numpy())
    np.testing.assert_array_equal(got.numpy(), brute_counts(x, x, thr).numpy())
