"""svgdcpp_tpu_torch phi sweeps against svgdcpp_tpu.

* The plain sweeps (phi_rbf, phi_rbf_blocked, phi_rbf_fused_counts, the
  multi-term phi_rbf_terms_fused_counts and the cross forms) against the
  JAX package's XLA twins in float64: rtol 1e-10 (the same arithmetic,
  summed in another order), counts exactly equal.
* phi_rbf_terms (the composed-kernel rbf_terms route) against the JAX
  package's in float64, with and without PSD flags: rtol 1e-10.
* The CUDA kernels' wrappers on CPU tensors (which run the plain version)
  against the Pallas kernels in interpret mode, float32, at a ragged n=300
  off origin (+50): phi rtol 2e-4, atol 2e-5 (the tolerance the JAX
  package's own interpret tests use); counts exactly equal at m <= 4, where
  both sides build sq from differences, and within n at m > 4, where the
  Pallas kernel uses a bf16x3-split Gram identity and the plain version a
  float32 one.
* The composed-kernel wrappers on CPU tensors against
  phi_rbf_terms_fused_pallas(_cross) in interpret mode, float32: (n=700,
  m=3, signs (1, -1)) square, (n=600, m=11) triangle and a cross case:
  phi rtol 2e-4, atol 2e-6 (tests/test_pallas.py's bound for that kernel);
  counts as above.
* K15's wrapper phi_rbf_cuda on CPU tensors (the eigen form phi_rbf_eigen,
  the kernel's arithmetic, with the decomposition's plain version) and the
  dense phi_rbf against phi_rbf_pallas in interpret mode, float32, on
  tests/test_pallas.py's cases: n = 100 and 517, ragged n = 73, and an
  indefinite P with psd=False: rtol 2e-4, atol 2e-5 (5e-4, 5e-6 for the
  indefinite P); off origin (+200) against the f64 dense phi: 2e-3
  relative. The JAX package's own tolerances for those cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgdcpp_tpu.ops import pallas_phi as pj
from svgdcpp_tpu.ops import phi as phj
from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.ops import phi as pht

# The suite runs several xdist workers on one CPU: torch's default of an
# OpenMP thread per core in each of them oversubscribes it.
torch.set_num_threads(1)


def assert_close(got, want, rtol, atol=0.0):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def inputs(n, m, offset=0.0, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, m)) + offset).astype(dtype)
    s = rng.normal(size=(n, m)).astype(dtype)
    return x, s


@pytest.mark.parametrize("m", [2, 6])
def test_phi_rbf_dense_and_blocked_f64(m):
    x, s = inputs(150, m, offset=3.0)
    a = np.random.default_rng(1).normal(size=(m, m))
    p = 0.2 * (a @ a.T / m + np.eye(m))
    want = phj.phi_rbf(jnp.asarray(x), jnp.asarray(s), jnp.asarray(p))
    assert_close(pht.phi_rbf(*map(torch.from_numpy, (x, s, p))), want, 1e-10)
    want_b = phj.phi_rbf_blocked(jnp.asarray(x), jnp.asarray(s), jnp.asarray(p), 64)
    got_b = pht.phi_rbf_blocked(*map(torch.from_numpy, (x, s, p)), 64)
    assert_close(got_b, want_b, 1e-10)
    assert_close(got_b, want, 1e-10)


@pytest.mark.parametrize("m", [2, 6])
def test_phi_rbf_fused_counts_f64(m):
    x, s = inputs(250, m, offset=-7.0)
    gamma = 0.45
    thr = np.array([0.5, 2.0, 6.0, 30.0])
    want_phi, want_cnt = phj.phi_rbf_fused_counts(
        jnp.asarray(x), jnp.asarray(s), gamma, jnp.asarray(thr), 64
    )
    got_phi, got_cnt = pht.phi_rbf_fused_counts(
        torch.from_numpy(x), torch.from_numpy(s), gamma, torch.from_numpy(thr), 64
    )
    assert_close(got_phi, want_phi, 1e-10)
    assert got_cnt.dtype == torch.int64
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt).astype(np.int64))
    # the cross form, n_t != n_s
    xt = x[:70] + 0.3
    want_phi, want_cnt = phj.phi_rbf_cross_fused_counts(
        jnp.asarray(xt), jnp.asarray(x), jnp.asarray(s), gamma, jnp.asarray(thr), 32
    )
    got_phi, got_cnt = pht.phi_rbf_cross_fused_counts(
        torch.from_numpy(xt), torch.from_numpy(x), torch.from_numpy(s), gamma,
        torch.from_numpy(thr), 32,
    )
    assert_close(got_phi, want_phi, 1e-10)
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt).astype(np.int64))


@pytest.mark.parametrize("m", [2, 6])
def test_phi_rbf_terms_fused_counts_f64(m):
    """Two signed isotropic terms: the k_c/w combination in the difference
    form (m=2) and the Gram form (m=6), single-set and cross."""
    x, s = inputs(230, m, offset=4.0, seed=m)
    gammas, signs = [0.3, 1.1], [1.0, -0.5]
    thr = np.array([0.25, 3.0, 12.0])
    want_phi, want_cnt = phj.phi_rbf_terms_fused_counts(
        jnp.asarray(x), jnp.asarray(s), gammas, signs, jnp.asarray(thr), 64
    )
    got_phi, got_cnt = pht.phi_rbf_terms_fused_counts(
        torch.from_numpy(x), torch.from_numpy(s), gammas, signs,
        torch.from_numpy(thr), 64,
    )
    assert_close(got_phi, want_phi, 1e-10)
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt).astype(np.int64))
    xt = x[:50] - 0.4
    want_phi, want_cnt = phj.phi_rbf_terms_cross_fused_counts(
        jnp.asarray(xt), jnp.asarray(x), jnp.asarray(s), gammas, signs,
        jnp.asarray(thr), 32,
    )
    got_phi, got_cnt = pht.phi_rbf_terms_cross_fused_counts(
        torch.from_numpy(xt), torch.from_numpy(x), torch.from_numpy(s), gammas,
        signs, torch.from_numpy(thr), 32,
    )
    assert_close(got_phi, want_phi, 1e-10)
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt).astype(np.int64))


@pytest.mark.parametrize("m", [2, 6])
def test_phi_rbf_terms_f64(m):
    """Three terms (sum, difference, a product's summed precision) with
    anisotropic constant slots, single-set and cross, PSD flags given and
    defaulted."""
    x, s = inputs(140, m, offset=2.0, seed=10 + m)
    rng = np.random.default_rng(20 + m)
    params = []
    for scale in (0.3, 0.1, 0.05):
        a = rng.normal(size=(m, m))
        params.append(scale * (a @ a.T / m + np.eye(m)))
    terms = [(1, ((0, 1),)), (-1, ((1, 1),)), (1, ((0, 1), (2, 1)))]
    flags = [True, True, False]
    for psd_flags in (None, flags):
        want = phj.phi_rbf_terms(
            jnp.asarray(x), jnp.asarray(s), [jnp.asarray(p) for p in params],
            terms, 64, psd_flags=psd_flags,
        )
        got = pht.phi_rbf_terms(
            torch.from_numpy(x), torch.from_numpy(s),
            [torch.from_numpy(p) for p in params], terms, 64,
            psd_flags=psd_flags,
        )
        assert_close(got, want, 1e-10)
    xt = x[:40] + 0.25
    want = phj.phi_rbf_terms_cross(
        jnp.asarray(xt), jnp.asarray(x), jnp.asarray(s),
        [jnp.asarray(p) for p in params], terms, 32,
    )
    got = pht.phi_rbf_terms_cross(
        torch.from_numpy(xt), torch.from_numpy(x), torch.from_numpy(s),
        [torch.from_numpy(p) for p in params], terms, 32,
    )
    assert_close(got, want, 1e-10)
    with pytest.raises(ValueError, match="psd_flags"):
        pht.phi_rbf_terms(
            torch.from_numpy(x), torch.from_numpy(s),
            [torch.from_numpy(p) for p in params], terms, psd_flags=[True],
        )


def _check_kernel_pair(got, want, n, m, atol=2e-5):
    phi_t, cnt_t = got
    phi_j, cnt_j = want
    assert_close(phi_t, phi_j, rtol=2e-4, atol=atol)
    cnt_t = cnt_t.numpy()
    cnt_j = np.asarray(cnt_j).astype(np.int64)
    if m <= 4:
        np.testing.assert_array_equal(cnt_t, cnt_j)
    else:
        assert np.abs(cnt_t - cnt_j).max() <= n


@pytest.mark.parametrize("m", [2, 3, 6])
@pytest.mark.parametrize("sym", [False, True])
def test_fused_cuda_wrapper_on_cpu_vs_pallas_interpret(m, sym):
    n = 300
    x, s = inputs(n, m, offset=50.0, seed=m, dtype=np.float32)
    gamma = np.float32(0.6)
    thr = np.linspace(0.0, 20.0, 5).astype(np.float32)
    want = pj.phi_rbf_fused_pallas(
        jnp.asarray(x), jnp.asarray(s), gamma, jnp.asarray(thr),
        tile_i=64, tile_j=128, sym=sym, interpret=True,
    )
    got = cuda_phi.phi_rbf_fused_cuda(
        torch.from_numpy(x), torch.from_numpy(s), torch.tensor(gamma),
        torch.from_numpy(thr), sym=sym,
    )
    assert got[0].dtype == torch.float32
    _check_kernel_pair(got, want, n, m)


def test_fused_cuda_cross_on_cpu_vs_pallas_interpret():
    xs, s = inputs(300, 2, offset=50.0, seed=4, dtype=np.float32)
    xt, _ = inputs(130, 2, offset=50.5, seed=5, dtype=np.float32)
    gamma = np.float32(0.6)
    thr = np.linspace(0.0, 20.0, 5).astype(np.float32)
    want = pj.phi_rbf_fused_pallas_cross(
        jnp.asarray(xt), jnp.asarray(xs), jnp.asarray(s), gamma,
        jnp.asarray(thr), tile_i=64, tile_j=128, interpret=True,
    )
    got = cuda_phi.phi_rbf_fused_cuda_cross(
        torch.from_numpy(xt), torch.from_numpy(xs), torch.from_numpy(s),
        torch.tensor(gamma), torch.from_numpy(thr),
    )
    _check_kernel_pair(got, want, 300, 2)


@pytest.mark.parametrize("n,m,signs,sym", [
    (700, 3, (1, -1), False),
    (600, 11, (1, 1), True),
])
def test_terms_cuda_wrapper_on_cpu_vs_pallas_interpret(n, m, signs, sym):
    x, s = inputs(n, m, offset=2.0, seed=30 + m, dtype=np.float32)
    gammas = [np.float32(0.6 / m), np.float32(0.08)]
    thr = np.linspace(0.5, 8.0 * m, 4).astype(np.float32)
    want = pj.phi_rbf_terms_fused_pallas(
        jnp.asarray(x), jnp.asarray(s), [jnp.float32(g) for g in gammas],
        list(signs), jnp.asarray(thr), interpret=True, sym=sym,
    )
    got = cuda_phi.phi_rbf_terms_fused_cuda(
        torch.from_numpy(x), torch.from_numpy(s),
        [torch.tensor(g) for g in gammas], signs, torch.from_numpy(thr),
        sym=sym,
    )
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    _check_kernel_pair(got, want, n, m, atol=2e-6)


def test_terms_cuda_cross_on_cpu_vs_pallas_interpret():
    xs, s = inputs(500, 11, offset=1.0, seed=40, dtype=np.float32)
    xt, _ = inputs(130, 11, offset=1.2, seed=41, dtype=np.float32)
    gammas = [np.float32(0.05), np.float32(0.1)]
    thr = np.linspace(2.0, 60.0, 3).astype(np.float32)
    want = pj.phi_rbf_terms_fused_pallas_cross(
        jnp.asarray(xt), jnp.asarray(xs), jnp.asarray(s),
        [jnp.float32(g) for g in gammas], [1, 1], jnp.asarray(thr),
        interpret=True,
    )
    got = cuda_phi.phi_rbf_terms_fused_cuda_cross(
        torch.from_numpy(xt), torch.from_numpy(xs), torch.from_numpy(s),
        [torch.tensor(g) for g in gammas], (1, 1), torch.from_numpy(thr),
    )
    _check_kernel_pair(got, want, 500, 11, atol=2e-6)


K15_P = np.array([[0.7, 0.1], [0.1, 0.5]])


@pytest.mark.parametrize("n,p,tiles,psd,rtol,atol", [
    (100, K15_P, (64, 128), True, 2e-4, 2e-5),
    (517, K15_P, (64, 128), True, 2e-4, 2e-5),
    (73, 0.4 * np.eye(2), (32, 32), True, 2e-4, 2e-5),
    (64, np.array([[0.4, 0.0], [0.0, -0.3]]), (512, 1024), False, 5e-4,
     5e-6),
])
def test_phi_rbf_cuda_on_cpu_vs_phi_rbf_pallas(n, p, tiles, psd, rtol, atol):
    x, s = inputs(n, 2, seed=n, dtype=np.float32)
    p = p.astype(np.float32)
    want = pj.phi_rbf_pallas(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(p), tile_i=tiles[0],
        tile_j=tiles[1], psd=psd, interpret=True,
    )
    args = (torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(p))
    for got in (cuda_phi.phi_rbf_cuda(*args, psd=psd),
                pht.phi_rbf(*args, psd=psd)):
        assert got.dtype == torch.float32
        assert_close(got, want, rtol=rtol, atol=atol)


def test_phi_rbf_cuda_on_cpu_off_origin():
    x, s = inputs(96, 2, offset=200.0, seed=96, dtype=np.float32)
    p = np.float32(np.log(96) / 2.0) * np.eye(2, dtype=np.float32)
    want = np.asarray(phj.phi_rbf(
        jnp.asarray(x, jnp.float64), jnp.asarray(s, jnp.float64),
        jnp.asarray(p, jnp.float64),
    ))
    for got in (
        pj.phi_rbf_pallas(jnp.asarray(x), jnp.asarray(s), jnp.asarray(p),
                          tile_i=32, tile_j=32, interpret=True),
        cuda_phi.phi_rbf_cuda(*map(torch.from_numpy, (x, s, p))),
    ):
        rel = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
        assert rel < 2e-3, rel


def test_dimension_limit_names_the_roadmap():
    """Every sweep takes any m >= 1; sym_eigen (``eigen``) alone stops at
    MAX_M = 64, naming its own reason (one block's shared memory) and
    that the fixed-P sweep takes P itself past it; no message names a
    ROADMAP item any more."""
    for m in (1, 11, 50, cuda_phi.MAX_M):
        cuda_phi.check_dimension(m, eigen=True)
    for m in (1, 64, 65, 123, 512, 4096):
        cuda_phi.check_dimension(m)
    assert cuda_phi.MAX_M == 64
    for eigen in (False, True):
        with pytest.raises(ValueError, match="m >= 1"):
            cuda_phi.check_dimension(0, eigen=eigen)
    with pytest.raises(ValueError, match="shared memory.*P itself") as err:
        cuda_phi.check_dimension(cuda_phi.MAX_M + 1, eigen=True)
    assert "ROADMAP" not in str(err.value)


def test_resolve_sym_and_launch_counts_on_cpu():
    assert cuda_phi.resolve_sym(None, cuda_phi.SYM_MIN_N - 1, 2) is False
    assert cuda_phi.resolve_sym(None, cuda_phi.SYM_MIN_N, 2) is True
    assert cuda_phi.resolve_sym(None, cuda_phi.SYM_MIN_N, 11, 2) is True
    assert cuda_phi.resolve_sym(True, 10, 2) is True
    assert cuda_phi.resolve_sym(False, 10**6, 2) is False
    assert cuda_phi.resolve_sym(None, 10**6, 2) == "panel"
    # the plain version on a CPU tensor launches nothing
    cuda_phi.reset_launch_counts()
    x, s = inputs(40, 2)
    cuda_phi.phi_rbf_fused_cuda(
        torch.from_numpy(x), torch.from_numpy(s), 0.5, torch.tensor([1.0, 2.0])
    )
    for sym in (False, True):
        cuda_phi.phi_rbf_terms_fused_cuda(
            torch.from_numpy(x), torch.from_numpy(s), [0.5, 0.1], (1, -1),
            torch.tensor([1.0, 2.0]), sym=sym,
        )
    cuda_phi.phi_rbf_terms_fused_cuda_cross(
        torch.from_numpy(x[:5]), torch.from_numpy(x), torch.from_numpy(s),
        [0.5], (1,), torch.tensor([1.0]),
    )
    p = torch.eye(2, dtype=torch.float64)
    cuda_phi.phi_rbf_aniso_terms_fused_cuda(
        torch.from_numpy(x), torch.from_numpy(s), [0.5], (1,), [p], (1,),
        torch.tensor([1.0]),
    )
    cuda_phi.phi_rbf_cuda(torch.from_numpy(x), torch.from_numpy(s), p)
    cuda_phi.phi_rbf_fused_cuda(
        torch.from_numpy(x), torch.from_numpy(s), 0.5, torch.tensor([1.0]),
        sym="panel",
    )
    cuda_phi.phi_rbf_terms_fused_cuda(
        torch.from_numpy(x), torch.from_numpy(s), [0.5, 0.1], (1, -1),
        torch.tensor([1.0, 2.0]), sym="panel", panel_blocks=2,
    )
    cuda_phi.phi_rbf_fused_sym_chunk_cuda(
        torch.from_numpy(x), torch.from_numpy(s), 0.5, torch.tensor([1.0]),
        2, 1,
    )
    cuda_phi.phi_rbf_terms_fused_sym_chunk_cuda(
        torch.from_numpy(x), torch.from_numpy(s), [0.5, 0.1], (1, -1),
        torch.tensor([1.0]), 2, 0,
    )
    cuda_phi.phi_rbf_sympanel_chunk_cuda(
        torch.from_numpy(x), torch.from_numpy(s), 0.5, torch.tensor([1.0]),
        3, 2,
    )
    cuda_phi.count_le_cuda(torch.from_numpy(x), torch.from_numpy(x),
                           torch.tensor([1.0, 2.0]))
    cuda_phi.symmetric_eigen(p)
    assert set(cuda_phi.launch_counts) == {
        cuda_phi.SQUARE_KERNEL, cuda_phi.SYM_KERNEL,
        cuda_phi.TERMS_SQUARE_KERNEL, cuda_phi.TERMS_SYM_KERNEL,
        cuda_phi.ANISO_KERNEL, cuda_phi.ANISO_WIDE_KERNEL,
        cuda_phi.PHI_RBF_KERNEL, cuda_phi.PHI_RBF_WIDE_KERNEL,
        cuda_phi.SYM_EIGEN_KERNEL,
        cuda_phi.SYMPANEL_KERNEL, cuda_phi.TERMS_SYMPANEL_KERNEL,
        cuda_phi.SYM_CHUNK_KERNEL, cuda_phi.TERMS_SYM_CHUNK_KERNEL,
        cuda_phi.SYMPANEL_CHUNK_KERNEL, cuda_phi.COUNT_KERNEL,
        cuda_phi.SQUARE_BF16_KERNEL, cuda_phi.SYM_BF16_KERNEL,
        cuda_phi.SYMPANEL_BF16_KERNEL, cuda_phi.PHI_RBF_WIDE_BF16_KERNEL,
    }
    assert all(v == 0 for v in cuda_phi.launch_counts.values())
