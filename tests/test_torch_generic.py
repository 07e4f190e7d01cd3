"""svgdcpp_tpu_torch's generic (autodiff) route against svgdcpp_tpu's.

* ``phi_generic`` / ``phi_generic_cross`` (torch.func VJP per target,
  streamed over row tiles) against the JAX functions on a composed kernel
  and on an asymmetric one (k(x, y) != k(y, x): a non-symmetric P in a
  bilinear term), at row tiles 8 and the default: rtol 1e-10; the result
  does not move with the row tile (rtol 1e-12).
* ``kernel_matrix_and_grad(_cross)``: atol 1e-12 against JAX.
* ``ksd_squared_generic``, U and V statistics, and ``ksd_rbf`` with a
  custom kernel: rtol 1e-9 against JAX.
* The driver's ``generic`` route on a small hierarchical BLR, 10 Adam
  steps, against the JAX driver: rtol 1e-9, atol 1e-12; ``auto`` takes
  ``generic`` for a custom kernel exactly where JAX's ``_phi_impl`` does.
All in float64 on the CPU, from numpy-seeded inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.ops import ksd as ksd_j
from svgdcpp_tpu.ops import phi as phi_j
from svgdcpp_tpu_torch.ops import ksd as ksd_t
from svgdcpp_tpu_torch.ops import phi as phi_t
from svgdcpp_tpu_torch.utils.workloads import blr_workload, build_blr_svgd

torch.set_num_threads(1)

P1 = np.array([[0.7, 0.1, 0.0], [0.1, 0.5, 0.2], [0.0, 0.2, 0.9]])
P2 = np.array([[0.3, 0.2, -0.1], [-0.2, 0.4, 0.05], [0.1, 0.0, 0.2]])


def composed_fn(lib):
    """RBF + 0.5 RBF with distinct inverse scales."""
    def fn(x, params, loc):
        d = x - loc
        return lib.exp(-(d @ params[0] @ d)) + 0.5 * lib.exp(
            -(d @ params[1] @ d))
    return fn


def asymmetric_fn(lib):
    """exp(-d^T P1 d - 0.1 x^T P2 y): P2 is not symmetric, so swapping x
    and y changes the value, and a transposed grad stack would show."""
    def fn(x, params, loc):
        d = x - loc
        return lib.exp(-(d @ params[0] @ d) - 0.1 * (x @ params[1] @ loc))
    return fn


KERNELS = {"composed": composed_fn, "asymmetric": asymmetric_fn}


def inputs(n, m=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, m)), rng.normal(size=(n, m))


@pytest.mark.parametrize("kind", sorted(KERNELS))
@pytest.mark.parametrize("row_tile", [8, 128])
def test_phi_generic_matches_jax(kind, row_tile):
    x, s = inputs(37)
    params = (P1, P2)
    want = phi_j.phi_generic(jnp.asarray(x), jnp.asarray(s),
                             KERNELS[kind](jnp),
                             tuple(jnp.asarray(p) for p in params),
                             row_tile=row_tile)
    got = phi_t.phi_generic(torch.from_numpy(x), torch.from_numpy(s),
                            KERNELS[kind](torch),
                            tuple(torch.from_numpy(p) for p in params),
                            row_tile=row_tile)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-13)


@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_phi_generic_cross_matches_jax_and_ignores_the_row_tile(kind):
    x, s = inputs(50, seed=1)
    params = tuple(torch.from_numpy(p) for p in (P1, P2))
    fn = KERNELS[kind](torch)
    xt, stt = torch.from_numpy(x), torch.from_numpy(s)
    full = phi_t.phi_generic(xt, stt, fn, params, row_tile=64)
    for tile in (8, 16, 24):
        np.testing.assert_allclose(
            phi_t.phi_generic(xt, stt, fn, params, row_tile=tile).numpy(),
            full.numpy(), rtol=1e-12, atol=1e-15)
    part = phi_t.phi_generic_cross(xt[10:22], xt, stt, fn, params,
                                   row_tile=8)
    want = phi_j.phi_generic_cross(
        jnp.asarray(x[10:22]), jnp.asarray(x), jnp.asarray(s),
        KERNELS[kind](jnp), (jnp.asarray(P1), jnp.asarray(P2)), row_tile=8)
    np.testing.assert_allclose(part.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-13)
    np.testing.assert_allclose(part.numpy(), full.numpy()[10:22],
                               rtol=1e-12, atol=1e-15)


def test_phi_generic_equals_the_closed_form_rbf():
    x, s = inputs(40, seed=2)
    p = torch.from_numpy(P1)
    closed = phi_t.phi_rbf(torch.from_numpy(x), torch.from_numpy(s), p)
    got = phi_t.phi_generic(torch.from_numpy(x), torch.from_numpy(s),
                            st.kernels.gaussian_rbf.rbf_kernel_fn, (p,),
                            row_tile=16)
    np.testing.assert_allclose(got.numpy(), closed.numpy(), rtol=1e-9)


@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_kernel_matrix_and_grad_match_jax(kind):
    x, _ = inputs(13, seed=3)
    pj = (jnp.asarray(P1), jnp.asarray(P2))
    pt = tuple(torch.from_numpy(p) for p in (P1, P2))
    kj, gj = phi_j.kernel_matrix_and_grad(jnp.asarray(x), KERNELS[kind](jnp),
                                          pj)
    kt, gt = phi_t.kernel_matrix_and_grad(torch.from_numpy(x),
                                          KERNELS[kind](torch), pt)
    assert tuple(gt.shape) == (13, 13, 3)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-12)
    kj, gj = phi_j.kernel_matrix_and_grad_cross(
        jnp.asarray(x[:5]), jnp.asarray(x), KERNELS[kind](jnp), pj)
    kt, gt = phi_t.kernel_matrix_and_grad_cross(
        torch.from_numpy(x[:5]), torch.from_numpy(x), KERNELS[kind](torch),
        pt)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", sorted(KERNELS))
@pytest.mark.parametrize("ustat", [False, True])
def test_ksd_squared_generic_matches_jax(kind, ustat):
    x, s = inputs(24, seed=4)
    want = ksd_j.ksd_squared_generic(
        jnp.asarray(x), jnp.asarray(s), KERNELS[kind](jnp),
        (jnp.asarray(P1), jnp.asarray(P2)), row_tile=8, ustat=ustat)
    got = ksd_t.ksd_squared_generic(
        torch.from_numpy(x), torch.from_numpy(s), KERNELS[kind](torch),
        (P1, P2), row_tile=8, ustat=ustat)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-9)


def test_ksd_squared_generic_equals_the_closed_form():
    x, s = inputs(24, seed=5)
    xt, stt = torch.from_numpy(x), torch.from_numpy(s)

    def rbf(a, params, b):
        d = a - b
        return torch.exp(-(d @ params[0] @ d))

    for ustat in (False, True):
        g = ksd_t.ksd_squared_generic(xt, stt, rbf, (P1,), row_tile=8,
                                      ustat=ustat)
        c = ksd_t.ksd_squared_rbf(xt, stt, torch.from_numpy(P1), row_tile=8,
                                  ustat=ustat)
        np.testing.assert_allclose(float(g), float(c), rtol=1e-9)


# ----------------------------------------------------------------------
# The driver
# ----------------------------------------------------------------------


def test_generic_route_on_hier_blr_matches_jax():
    feats, labels, x0 = blr_workload(64, 5, hierarchical=True)
    x0 = x0.astype(np.float64)
    sj = bench.build_blr_svgd(x0, feats, labels, hierarchical=True,
                              phi_impl="generic", steps_per_call=10)
    s_t = build_blr_svgd(x0, feats, labels, hierarchical=True,
                         phi_impl="generic", num_iterations=10, device="cpu")
    assert sj._phi_impl == s_t._phi_impl == "generic"
    np.testing.assert_allclose(s_t.run().numpy(), np.asarray(sj.run()),
                               rtol=1e-9, atol=1e-12)
    # the same run through the closed-form terms route
    s_r = build_blr_svgd(x0, feats, labels, hierarchical=True,
                         phi_impl="rbf_terms", num_iterations=10,
                         device="cpu")
    np.testing.assert_allclose(s_r.run().numpy(), s_t.store.value.numpy(),
                               rtol=1e-9, atol=1e-12)


def imq_kernel(pkg, x0, model):
    """RBF(median) + an inverse-multiquadric leaf given as a plain
    kernel_fn, which flatten_rbf_terms cannot flatten."""
    lib = torch if pkg is st else jnp

    def imq(x, params, loc):
        d = x - loc
        return 1.0 / lib.sqrt(1.0 + params[0] * (d @ d))

    leaf = pkg.Kernel(x0.shape[1], imq, (np.asarray(0.5),))
    return pkg.GaussianRBFKernel(x0.copy(), pkg.ScaleMethod.MEDIAN,
                                 model) + leaf


@pytest.mark.parametrize("n", [40, 1100])
def test_auto_takes_generic_for_a_custom_kernel_as_jax(n):
    x0 = np.random.default_rng(6).normal(size=(n, 2))
    runs = {}
    for pkg in (sv, st):
        model = pkg.MultivariateNormal(np.zeros(2), np.eye(2))
        kernel = imq_kernel(pkg, x0, model)
        kw = {"device": "cpu"} if pkg is st else {}
        drv = pkg.SVGD(pkg.SVGDOptions(
            dimension=2, num_iterations=3, coordinate_matrix=x0.copy(),
            kernel=kernel, model=model, optimizer=pkg.AdaGrad(2, n, 0.1),
            **kw)).initialize()
        runs[pkg] = drv
    assert runs[sv]._phi_impl == runs[st]._phi_impl == "generic"
    assert runs[st]._auto_impl(on_cuda=True) == "generic"
    if n <= 64:
        np.testing.assert_allclose(runs[st].run().numpy(),
                                   np.asarray(runs[sv].run()),
                                   rtol=1e-9, atol=1e-12)
