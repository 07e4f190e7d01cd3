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
"""

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
