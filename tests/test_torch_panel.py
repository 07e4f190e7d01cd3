"""The panel triangle sweeps of svgdcpp_tpu_torch against svgdcpp_tpu.

* The form rule: ``cuda_phi.resolve_sym(None, n, m, T)`` against the JAX
  package's ``_resolve_sym`` at the default tiles of its entry points
  (``phi_rbf_fused_pallas`` for one RBF, ``phi_rbf_terms_fused_pallas`` for
  T terms) on a grid of n from 1,024 to 2,097,152, m in {2, 4, 7, 11, 16,
  25, 50} and T in {one RBF, 1, 2, 3}: equal. The "K12 or K13" helper
  against ``_sym_panel_terms_direct_plan is None``. The forced forms.
* K3's port: the wrapper on CPU tensors with sym="panel" (the plain panel
  schedule) against ``_phi_rbf_fused_pallas_sympanel_impl`` in interpret
  mode (panel_blocks=4), float32, ragged n, m in {2, 11}: phi within 1e-4
  of max |phi|; counts equal at m <= 4, where both build sq from
  differences, and within n above (the Pallas kernel's Gram branch splits
  its dot into bf16 parts).
* K12 and K13's port: the terms wrapper against
  ``_phi_rbf_terms_fused_pallas_sympanel_direct_impl`` and
  ``_phi_rbf_terms_fused_pallas_sympanel_impl`` in interpret mode, the same
  tolerances, at m in {2, 5, 11} with one to three terms, negative signs
  and ragged n.
* The plain panel schedules against the JAX package's plain sweeps
  (``phi_rbf_fused_counts``, ``phi_rbf_terms_fused_counts``) in float64
  for several super-block counts, empty and ragged super-blocks included:
  phi within 1e-10 relative, counts equal.
* The driver with fused_sym="panel": against the JAX driver's
  ``fused_pallas`` route with fused_sym="panel" (interpret mode) for 5
  AdaGrad steps at n=600 in float32, rtol 2e-3, atol 2e-4 (the bound of
  tests/test_torch_svgd.py for that pair: AdaGrad divides phi by its own
  running norm, so float32 rounding moves a particle by more than phi's
  own error); against the JAX driver's plain 'fused' route in float64,
  rtol 1e-9; the hierarchical BLR's 'fused_terms_cuda' with
  fused_sym="panel" against the bench's JAX driver ('fused_terms') at
  n=1100 in float64, rtol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.ops import pallas_phi as pj
from svgdcpp_tpu.ops import phi as phj
from svgdcpp_tpu_torch.ops import cuda_phi, sym_plan
from svgdcpp_tpu_torch.ops import phi as pht
from svgdcpp_tpu_torch.utils.workloads import blr_workload, build_blr_svgd

# The suite runs several xdist workers on one CPU: torch's default of an
# OpenMP thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

RESOLVER_N = (1024, 2047, 2048, 4096, 10000, 12288, 12289, 20000, 45056,
              45057, 65536, 100000, 131072, 131073, 208896, 208897, 262144,
              524288, 1048576, 2097152)


def jax_decision(n, m, num_terms):
    """The JAX entry points' decision, from their own functions."""
    tile_i, tile_j = 512, 2048
    if num_terms is None:
        if m > pj._DIFF_FORM_MAX_M and n <= 12288:
            tile_j = 1024
        return pj._resolve_sym(None, n, m, tile_i, tile_j,
                               pj._sym_panel_eligible)
    if n <= 12288:
        tile_j = 1024
    return pj._resolve_sym(
        None, n, m, tile_i, tile_j,
        lambda nn, mm, tj: pj._sym_panel_terms_eligible(nn, mm, tj, num_terms),
    )


@pytest.mark.parametrize("num_terms", [None, 1, 2, 3])
@pytest.mark.parametrize("m", [2, 4, 7, 11, 16, 25, 50])
def test_resolve_sym_none_is_the_jax_decision(m, num_terms):
    for n in RESOLVER_N:
        want = jax_decision(n, m, num_terms)
        got = cuda_phi.resolve_sym(None, n, m, num_terms)
        assert got == want and type(got) is type(want), (n, m, num_terms)


def test_resolve_sym_paths_a_and_b():
    """The two large-N paths take the panel form, the N=10k ones the
    full-width triangle."""
    assert cuda_phi.resolve_sym(None, 262144, 2) == "panel"
    assert cuda_phi.resolve_sym(None, 1048576, 2) == "panel"
    assert cuda_phi.resolve_sym(None, 131072, 11, 2) == "panel"
    assert cuda_phi.resolve_sym(None, 10000, 2) is True
    assert cuda_phi.resolve_sym(None, 10000, 11, 2) is True
    assert sym_plan.tpu_terms_panel_kernel(131072, 11, 2) == "K12"
    assert sym_plan.tpu_terms_panel_kernel(65536, 11, 3) == "K13"
    assert sym_plan.tpu_terms_panel_kernel(262144, 2, 2) == "K12"


@pytest.mark.parametrize("num_terms", [1, 2, 3])
def test_tpu_terms_panel_kernel_names_the_direct_plan(num_terms):
    for m in (2, 4, 5, 7, 11, 16, 25):
        for n in RESOLVER_N:
            tile_j = 1024 if n <= 12288 else 2048
            direct = pj._sym_panel_terms_direct_plan(n, m, num_terms, 512,
                                                     tile_j)
            want = "K13" if direct is None else "K12"
            assert sym_plan.tpu_terms_panel_kernel(n, m, num_terms) == want


def test_resolve_sym_forced_forms():
    for n in (10, 2048, 262144, 10**7):
        assert cuda_phi.resolve_sym(True, n, 2) is True
        assert cuda_phi.resolve_sym(True, n, 11, 2) is True
        assert cuda_phi.resolve_sym(False, n, 2) is False
        assert cuda_phi.resolve_sym("panel", n, 11, 3) == "panel"
    with pytest.raises(ValueError, match="panel"):
        cuda_phi.resolve_sym("triangle", 4096, 2)
    # the JAX package's True is advisory past its budget
    assert pj._resolve_sym(True, 262144, 2, 512, 2048,
                           pj._sym_panel_eligible) == "panel"


def test_card_panel_plan():
    assert sym_plan.card_panel_plan(262144) == (8, 32768, 262144)
    assert sym_plan.card_panel_plan(1048576) == (16, 65536, 1048576)
    assert sym_plan.card_panel_plan(131072) == (8, 16384, 131072)
    assert sym_plan.card_panel_plan(10007, 3) == (3, 3392, 10176)
    assert sym_plan.card_panel_plan(100, 8) == (8, 64, 512)
    pairs = sym_plan.panel_pairs(4)
    assert pairs[:6] == [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    assert pairs[6:] == [(0, 0), (1, 1), (2, 2), (3, 3)]
    with pytest.raises(ValueError):
        sym_plan.card_panel_plan(100, 0)


def inputs(n, m, offset, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, m)) * 2.0 + offset).astype(dtype)
    s = rng.normal(size=(n, m)).astype(dtype)
    return x, s


def check_pair(got, want, n, m):
    phi_t, cnt_t = got
    phi_j, cnt_j = (np.asarray(a) for a in want)
    rel = np.abs(phi_t.numpy() - phi_j).max() / np.abs(phi_j).max()
    assert rel <= 1e-4, rel
    cnt_t = cnt_t.numpy()
    cnt_j = cnt_j.astype(np.int64)
    if m <= 4:
        np.testing.assert_array_equal(cnt_t, cnt_j)
    else:
        assert np.abs(cnt_t - cnt_j).max() <= n


@pytest.mark.parametrize("n,m,blocks", [(517, 2, 3), (517, 2, 8),
                                        (300, 11, 4)])
def test_k3_wrapper_on_cpu_vs_sympanel_interpret(n, m, blocks):
    x, s = inputs(n, m, 1.0, 10 + n + m)
    gamma = np.float32(0.5 / m)
    thr = np.asarray([1.0, 4.0, 3.0 * m], np.float32)
    want = pj._phi_rbf_fused_pallas_sympanel_impl(
        jnp.asarray(x), jnp.asarray(s), jnp.float32(gamma), jnp.asarray(thr),
        3, 32, 64, True, panel_blocks=4,
    )
    cuda_phi.reset_launch_counts()
    got = cuda_phi.phi_rbf_fused_cuda(
        torch.from_numpy(x), torch.from_numpy(s), torch.tensor(gamma),
        torch.from_numpy(thr), sym="panel", panel_blocks=blocks,
    )
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    check_pair(got, want, n, m)
    assert not any(cuda_phi.launch_counts.values())  # the plain version


@pytest.mark.parametrize("impl,n,m,signs", [
    ("direct", 900, 2, (1.0, 1.0)),
    ("direct", 600, 11, (1.0, -0.5)),
    ("legacy", 900, 2, (1.0, 1.0)),
    ("legacy", 613, 11, (1.0, 1.0, -0.3)),
    # the shapes the CUDA terms body's other instances serve: one term at
    # m = 11 (a runtime term count), m = 5 (the runtime-m instance), and
    # three terms with a negative sign, each at a ragged n
    ("direct", 613, 11, (1.0,)),
    ("direct", 707, 5, (1.0, 1.0)),
    ("legacy", 677, 11, (1.0, -0.5, 0.3)),
])
def test_k12_k13_terms_wrapper_on_cpu_vs_interpret(impl, n, m, signs):
    x, s = inputs(n, m, 1.0, 20 + n + m)
    gs = [np.float32(g) for g in (0.6 / m, 0.08, 0.3 / m)[:len(signs)]]
    thr = np.asarray([1.0, 5.0, 4.0 * m], np.float32)
    args = (jnp.asarray(x), jnp.asarray(s), tuple(jnp.float32(g) for g in gs),
            signs, jnp.asarray(thr), 3)
    if impl == "direct":
        want = pj._phi_rbf_terms_fused_pallas_sympanel_direct_impl(
            *args, 64, 128, True, panel_blocks=4)
    else:
        want = pj._phi_rbf_terms_fused_pallas_sympanel_impl(
            *args, 64, 128, True, panel_blocks=5)
    got = cuda_phi.phi_rbf_terms_fused_cuda(
        torch.from_numpy(x), torch.from_numpy(s),
        [torch.tensor(g) for g in gs], signs, torch.from_numpy(thr),
        sym="panel", panel_blocks=3,
    )
    check_pair(got, want, n, m)


@pytest.mark.parametrize("blocks", [1, 2, 3, 8, None])
@pytest.mark.parametrize("m", [2, 6])
def test_plain_panel_schedules_f64(m, blocks):
    n = 301 if blocks != 8 else 100  # 8 blocks of 64: empty super-blocks
    x, s = inputs(n, m, 5.0, 30 + m, np.float64)
    thr = np.asarray([0.5, 3.0, 2.0 * m, 40.0])
    want_phi, want_cnt = phj.phi_rbf_fused_counts(
        jnp.asarray(x), jnp.asarray(s), 0.35, jnp.asarray(thr))
    got_phi, got_cnt = pht.phi_rbf_sympanel_fused_counts(
        torch.from_numpy(x), torch.from_numpy(s), 0.35, torch.from_numpy(thr),
        panel_blocks=blocks, row_tile=40,
    )
    np.testing.assert_allclose(got_phi.numpy(), np.asarray(want_phi),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(got_cnt.numpy(),
                                  np.asarray(want_cnt).astype(np.int64))
    gammas, signs = [0.35, 0.05], [1.0, -0.4]
    want_phi, want_cnt = phj.phi_rbf_terms_fused_counts(
        jnp.asarray(x), jnp.asarray(s), gammas, signs, jnp.asarray(thr))
    got_phi, got_cnt = pht.phi_rbf_terms_sympanel_fused_counts(
        torch.from_numpy(x), torch.from_numpy(s), gammas, signs,
        torch.from_numpy(thr), panel_blocks=blocks, row_tile=40,
    )
    np.testing.assert_allclose(got_phi.numpy(), np.asarray(want_phi),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(got_cnt.numpy(),
                                  np.asarray(want_cnt).astype(np.int64))


MEAN = np.array([-0.6871, 0.8010])
COV = 5.0 * np.array([[0.2260, 0.1652], [0.1652, 0.6779]])


def mvn_driver(pkg, x0, impl, iters=5, **kw):
    n, dim = x0.shape
    model = pkg.MultivariateNormal(MEAN.astype(x0.dtype), COV.astype(x0.dtype))
    kernel = pkg.GaussianRBFKernel(x0.copy(), pkg.ScaleMethod.MEDIAN, model)
    extra = {"device": "cpu"} if pkg is st else {}
    return pkg.SVGD(pkg.SVGDOptions(
        dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model, optimizer=pkg.AdaGrad(dim, n, 0.1),
        phi_impl=impl, **kw, **extra,
    )).initialize()


def test_panel_driver_vs_jax_fused_pallas_panel_interpret():
    x0 = (np.random.default_rng(42).normal(size=(600, 2)) * 2).astype(
        np.float32)
    s_t = mvn_driver(st, x0, "fused_cuda", fused_sym="panel")
    assert s_t.fused_sym_form == "panel"
    want = np.asarray(mvn_driver(sv, x0, "fused_pallas",
                                 fused_sym="panel").run())
    np.testing.assert_allclose(s_t.run().numpy(), want, rtol=2e-3, atol=2e-4)
    assert s_t.median_fallbacks == 0


def test_panel_driver_f64_vs_jax_fused():
    x0 = np.random.default_rng(7).normal(size=(600, 2)) * 2.0
    s_t = mvn_driver(st, x0, "fused_cuda", fused_sym="panel")
    want = np.asarray(mvn_driver(sv, x0, "fused").run())
    np.testing.assert_allclose(s_t.run().numpy(), want, rtol=1e-9, atol=1e-12)
    # the default form at this n is the square sweep, and True forces the
    # full-width triangle
    assert mvn_driver(st, x0, "fused_cuda").fused_sym_form is False
    assert mvn_driver(st, x0, "fused_cuda", fused_sym=True).fused_sym_form
    assert mvn_driver(st, x0, "fused").fused_sym_form is None


def test_hier_panel_driver_f64_vs_jax_fused_terms():
    feats, labels, x0 = blr_workload(1100, 5, hierarchical=True)
    x0 = x0.astype(np.float64)
    s_t = build_blr_svgd(x0, feats, labels, hierarchical=True,
                         phi_impl="fused_terms_cuda", num_iterations=5,
                         device="cpu", fused_sym="panel")
    assert s_t.fused_sym_form == "panel"
    s_j = bench.build_blr_svgd(x0, feats, labels, hierarchical=True,
                               steps_per_call=5)
    assert s_j._phi_impl == "fused_terms"
    np.testing.assert_allclose(s_t.run().numpy(), np.asarray(s_j.run()),
                               rtol=1e-9, atol=1e-12)


def test_wrappers_count_the_panel_kernels():
    assert cuda_phi.SYMPANEL_KERNEL in cuda_phi.launch_counts
    assert cuda_phi.TERMS_SYMPANEL_KERNEL in cuda_phi.launch_counts
    assert "fused_phi_panel.cu" in {src.name for src in cuda_phi.SOURCES}
