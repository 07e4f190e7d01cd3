"""K15's port (``phi_rbf_cuda``) and its decomposition of P on the CPU,
against svgdcpp_tpu.

* The wrapper's CPU branch -- the decomposition's plain version
  (``symmetric_eigen`` on the CPU, ``torch.linalg.eigh``) and the kernel's
  arithmetic in the eigen basis (``ops/phi.phi_rbf_eigen``, its float64
  epilogue included) -- against ``_phi_rbf_pallas_impl`` in interpret mode,
  float32, n = 200, m = 2, 3, 11 and 50, a positive definite P with
  psd=True and an indefinite one with psd=False: max |dphi| within 2e-4 of
  max |phi| (the Pallas kernel takes the Gram identity in float32, the
  plain version the eigen basis; tests/test_pallas.py holds K15 to 2e-4).
* ``symmetric_eigen`` on the CPU at the kernel's widths (m = 2, 3, 11, 50
  and 64, positive definite and indefinite): V diag(lam) V^T = P_sym/2 and
  V^T V = I within 1e-12, float64; the CUDA kernel's plain version.
* ``SVGD._fixed_p_eigen``: a CONSTANT P decomposed once and kept while the
  step carries the same tensor, renewed after a hot-swap; MEDIAN's gamma I
  as (its diagonal, I); None for a HESSIAN scale, which the wrapper
  decomposes each call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svgdcpp_tpu_torch as st
from svgdcpp_tpu.ops import pallas_phi as pj
from svgdcpp_tpu_torch.ops import cuda_phi

torch.set_num_threads(1)


def precision(m, kind, seed):
    """A positive definite or an indefinite (m, m) P whose forms at the
    inputs' spread are of order one."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, m))
    if kind == "pd":
        p = 0.5 * np.eye(m) + a @ a.T / m
    else:
        p = np.diag(np.linspace(1.0, -0.3, m)) + 0.05 * (a + a.T)
    return (p / m).astype(np.float32)


@pytest.mark.parametrize("kind", ["pd", "indefinite"])
@pytest.mark.parametrize("m", [2, 3, 11, 50])
def test_k15_cpu_branch_vs_phi_rbf_pallas_interpret(m, kind):
    n = 200
    rng = np.random.default_rng(10 * m + (kind == "pd"))
    x = (rng.normal(size=(n, m)) + 3.0).astype(np.float32)
    s = rng.normal(size=(n, m)).astype(np.float32)
    p = precision(m, kind, m)
    psd = kind == "pd"
    want = np.asarray(pj._phi_rbf_pallas_impl(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(p), tile_i=64,
        tile_j=128, interpret=True, psd=psd,
    ))
    got = cuda_phi.phi_rbf_cuda(
        torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(p),
        psd=psd,
    )
    assert got.dtype == torch.float32 and got.shape == (n, m)
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel < 2e-4, rel


@pytest.mark.parametrize("m", [2, 3, 11, 50, 64])
def test_symmetric_eigen_plain_version(m):
    for kind in ("pd", "indefinite"):
        p = torch.from_numpy(precision(m, kind, 100 + m).astype(np.float64))
        lam, v = cuda_phi.symmetric_eigen(p)
        assert lam.dtype == v.dtype == torch.float64
        np.testing.assert_allclose(
            ((v * lam) @ v.T).numpy(), (0.5 * (p + p.T)).numpy(), atol=1e-12
        )
        np.testing.assert_allclose((v.T @ v).numpy(), np.eye(m), atol=1e-12)
        if kind == "indefinite" and m > 2:
            assert (lam < 0).any() and (lam > 0).any()


def _fixed_p_driver(scale, p_const=None):
    n, dim = 40, 3
    rng = np.random.default_rng(70)
    x0 = rng.normal(size=(n, dim)) * 1.5
    model = st.MultivariateNormal(np.zeros(dim), np.eye(dim))
    kernel = st.GaussianRBFKernel(
        x0.copy(), getattr(st.ScaleMethod, scale), model,
        constant_scale=p_const,
    )
    return st.SVGD(st.SVGDOptions(
        dimension=dim, num_iterations=2, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model, optimizer=st.AdaGrad(dim, n, 0.1),
        phi_impl="cuda", device="cpu",
    )).initialize()


def test_fixed_p_eigen_constant_kept_then_renewed():
    """A CONSTANT P is decomposed once and its decomposition kept while
    the step carries that tensor; a hot-swap brings a new tensor, which is
    decomposed once more."""
    p_const = np.array([[0.4, 0.1, 0.0], [0.05, 0.3, -0.1],
                        [0.0, 0.1, -0.2]])
    svgd = _fixed_p_driver("CONSTANT", p_const)
    svgd.run()
    p = svgd.kernel.parameters[0]
    first = svgd._fixed_p_eigen(p)
    assert svgd._fixed_p_eigen(p) is first
    lam, v = first
    np.testing.assert_allclose(((v * lam) @ v.T).numpy(),
                               (0.5 * (p + p.T)).double().numpy(), atol=1e-12)
    svgd.update_kernel_parameters((0.5 * p,))
    svgd.run()
    p2 = svgd.kernel.parameters[0]
    second = svgd._fixed_p_eigen(p2)
    assert second is not first and svgd._fixed_p_eigen(p2) is second
    lam2, v2 = second
    np.testing.assert_allclose(((v2 * lam2) @ v2.T).numpy(),
                               (0.5 * (p2 + p2.T)).double().numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(np.sort(lam2.numpy()),
                               np.sort(0.5 * lam.numpy()), atol=1e-12)


def test_fixed_p_eigen_median_and_hessian():
    median = _fixed_p_driver("MEDIAN")
    p = median.kernel.parameters[0]
    lam, v = median._fixed_p_eigen(p)
    assert torch.equal(lam, p.diagonal())
    assert torch.equal(v, torch.eye(p.shape[0], dtype=p.dtype))
    hessian = _fixed_p_driver("HESSIAN")
    assert hessian._fixed_p_eigen(hessian.kernel.parameters[0]) is None
