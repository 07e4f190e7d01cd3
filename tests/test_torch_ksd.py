"""svgdcpp_tpu_torch's kernel Stein discrepancy against svgdcpp_tpu's.

``ksd_squared_rbf``, ``ksd_squared_rbf_terms`` and ``ksd_rbf`` against the
JAX package's functions on the same inputs in float64, on the flagship MVN
and on the hierarchical BLR of ``bench.py --config hier``: U- and
V-statistics, a row tile that does not divide n, an indefinite P without
the clamp, the hierarchical composed kernel (median RBF + 0.1 I) and a
signed composition. rtol 1e-10: the same arithmetic, summed in another
order (the port adds each tile's sum in float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.kernels.algebra import flatten_rbf_terms as flatten_j
from svgdcpp_tpu.ops import ksd as ksd_j
from svgdcpp_tpu_torch.kernels.algebra import flatten_rbf_terms as flatten_t
from svgdcpp_tpu_torch.ops import ksd as ksd_t
from svgdcpp_tpu_torch.utils.workloads import MVN_COV, MVN_MEAN, blr_workload

# The suite runs several xdist workers on one CPU: torch's default of an
# OpenMP thread per core in each of them oversubscribes it.
torch.set_num_threads(1)


def close(got, want, rtol=1e-10):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)


def mvn_case(n, seed):
    x = np.random.default_rng(seed).uniform(-3.0, 3.0, (n, 2))
    cov_inv = np.linalg.inv(MVN_COV)
    s = -(x - MVN_MEAN) @ cov_inv.T
    return x, s


def hier_case(n):
    feats, labels, x0 = blr_workload(n, 4, n_data=64, hierarchical=True)
    x0 = x0.astype(np.float64)
    model_t = st.HierarchicalBayesianLogisticRegression(feats, labels)
    model_j = sv.HierarchicalBayesianLogisticRegression(feats, labels)
    return x0, model_t, model_j


@pytest.mark.parametrize("ustat", [False, True])
@pytest.mark.parametrize("case", ["mvn_median", "mvn_full_p", "indefinite"])
def test_ksd_squared_rbf_f64(case, ustat):
    x, s = mvn_case(137, 1)
    if case == "mvn_median":
        p = 0.4 * np.eye(2)
    elif case == "mvn_full_p":
        p = np.array([[0.7, 0.1], [0.3, 0.5]])
    else:
        p = np.array([[0.4, 0.0], [0.0, -0.05]])
    psd = case != "indefinite"
    want = ksd_j.ksd_squared_rbf(jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(p), 40, ustat=ustat, psd=psd)
    got = ksd_t.ksd_squared_rbf(torch.from_numpy(x), torch.from_numpy(s),
                                torch.from_numpy(p), 40, ustat=ustat, psd=psd)
    assert got.dtype == torch.float64
    close(got, want)


@pytest.mark.parametrize("ustat", [False, True])
def test_ksd_squared_rbf_terms_f64(ustat):
    """A signed composition of three RBF terms (one a product)."""
    x, s = mvn_case(90, 2)
    params = [0.3 * np.eye(2), np.array([[0.2, 0.05], [0.05, 0.1]]),
              0.05 * np.eye(2)]
    terms = [(1, ((0, 1),)), (-1, ((1, 1),)), (1, ((0, 1), (2, 1)))]
    want = ksd_j.ksd_squared_rbf_terms(
        jnp.asarray(x), jnp.asarray(s), [jnp.asarray(p) for p in params],
        terms, 32, ustat=ustat,
    )
    got = ksd_t.ksd_squared_rbf_terms(
        torch.from_numpy(x), torch.from_numpy(s),
        [torch.from_numpy(p) for p in params], terms, 32, ustat=ustat,
    )
    close(got, want)
    with pytest.raises(ValueError, match="psd_flags"):
        ksd_t.ksd_squared_rbf_terms(
            torch.from_numpy(x), torch.from_numpy(s),
            [torch.from_numpy(p) for p in params], terms, psd_flags=[True],
        )


@pytest.mark.parametrize("ustat", [False, True])
@pytest.mark.parametrize("n", [300, 700])
def test_ksd_rbf_mvn_median_bandwidth(n, ustat):
    """The flagship target with the median bandwidth (exact median at
    n=300, the hybrid selector at n=700)."""
    x = np.random.default_rng(n).uniform(-3.0, 3.0, (n, 2))
    want = ksd_j.ksd_rbf(sv.MultivariateNormal(MVN_MEAN, MVN_COV),
                         jnp.asarray(x), ustat=ustat)
    got = ksd_t.ksd_rbf(st.MultivariateNormal(MVN_MEAN, MVN_COV),
                        torch.from_numpy(x), ustat=ustat)
    close(got, want)


@pytest.mark.parametrize("with_kernel", [False, True])
def test_ksd_rbf_hierarchical_blr(with_kernel):
    """The hierarchical BLR's scores, with the median RBF or with the
    bench's composed kernel (median RBF + 0.1 I)."""
    x0, model_t, model_j = hier_case(200)
    kw_t, kw_j = {}, {}
    if with_kernel:
        kernel_j = sv.GaussianRBFKernel(
            x0, sv.ScaleMethod.MEDIAN, model_j
        ) + sv.GaussianRBFKernel(
            x0, sv.ScaleMethod.CONSTANT, constant_scale=0.1 * np.eye(5)
        )
        kernel_t = st.GaussianRBFKernel(
            x0, st.ScaleMethod.MEDIAN, model_t
        ) + st.GaussianRBFKernel(
            x0, st.ScaleMethod.CONSTANT, constant_scale=0.1 * np.eye(5)
        )
        assert flatten_j(kernel_j) == flatten_t(kernel_t)
        kw_j, kw_t = {"kernel": kernel_j}, {"kernel": kernel_t}
    want = ksd_j.ksd_rbf(model_j, jnp.asarray(x0), row_tile=64, **kw_j)
    got = ksd_t.ksd_rbf(model_t, torch.from_numpy(x0), row_tile=64, **kw_t)
    close(got, want)


def test_ksd_rbf_rejects_what_needs_the_generic_route():
    x, _ = mvn_case(20, 3)
    model = st.MultivariateNormal(MVN_MEAN, MVN_COV)
    kernel = st.GaussianRBFKernel(x, st.ScaleMethod.MEDIAN, model)
    with pytest.raises(ValueError, match="not both"):
        ksd_t.ksd_rbf(model, torch.from_numpy(x), p_matrix=np.eye(2),
                      kernel=kernel)
    custom = st.Kernel(
        2, lambda a, params, b: torch.exp(-torch.sum((a - b) ** 2)),
        (np.eye(2),),
    )
    with pytest.raises(NotImplementedError, match="9a"):
        ksd_t.ksd_rbf(model, torch.from_numpy(x), kernel=custom)


def test_ksd_rbf_places_numpy_coords_on_its_device(monkeypatch):
    """Numpy coordinates go to ``device``, the card by default: without a
    CUDA device that raises, naming device="cpu"; with device="cpu" the
    value is the CPU tensor's."""
    x, _ = mvn_case(120, 4)
    model = st.MultivariateNormal(MVN_MEAN, MVN_COV)
    want = ksd_t.ksd_rbf(model, torch.from_numpy(x))
    assert float(ksd_t.ksd_rbf(model, x, device="cpu")) == float(want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ksd_t.ksd_rbf(model, x)
    assert float(ksd_t.ksd_rbf(model, torch.from_numpy(x))) == float(want)


def test_ksd_drops_along_a_panel_run():
    """KSD, as chip_smoke.py's path A reads it, falls along a run of the
    'fused_cuda' route with the panel schedule (CPU, the plain version)."""
    n = 400
    x0 = np.random.default_rng(5).uniform(-3.0, 3.0, (n, 2))
    model = st.MultivariateNormal(MVN_MEAN, MVN_COV)
    kernel = st.GaussianRBFKernel(x0, st.ScaleMethod.MEDIAN, model)
    svgd = st.SVGD(st.SVGDOptions(
        dimension=2, num_iterations=60, coordinate_matrix=x0,
        kernel=kernel, model=model, optimizer=st.AdaGrad(2, n, 0.1),
        phi_impl="fused_cuda", fused_sym="panel", device="cpu",
    )).initialize()
    before = float(ksd_t.ksd_rbf(model, torch.from_numpy(x0)))
    after = float(ksd_t.ksd_rbf(model, svgd.run()))
    assert after < 0.5 * before, (before, after)
