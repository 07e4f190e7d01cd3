"""K14 (the anisotropic composed sweep) and K15 (one RBF with a full,
fixed P) past m = 64, on the CPU.

* The plain versions through the CUDA wrappers on CPU tensors against the
  JAX package's Pallas kernels in interpret mode at m = 65, 100 and 123,
  n = 300, at the origin and at +100: K14 (``phi_rbf_aniso_terms_fused_
  pallas``) for one and two anisotropic terms, with and without an
  isotropic term; K15 (``_phi_rbf_pallas_impl``) with a positive definite
  and an indefinite P (``psd=False``), through the wrapper's CPU branch
  (``torch.linalg.eigh`` and ``phi_rbf_eigen``) and through the plain
  version of the wide kernel's own form (``phi_rbf_gram``). phi rtol 2e-4,
  atol 2e-5 (the JAX package's interpret tolerance); K14's counts equal
  the float64 plain version's and lie within COUNT_SLACK of the Pallas
  kernel's (a bf16x3-split Gram identity there).
* The wide K15's operands: q_i + q_j - 2 x_i . y_j from ``gram_operands``
  is d^T P d in float64 (1e-12 relative), for an indefinite P too.
* The wrappers on a stand-in library (meta tensors stand in for the card)
  at m = 65, 123 and 512: K14's hands the padded width
  ``wide_row_width(m)`` to ``svgd_fused_phi_aniso_terms_groups`` (whose
  wide kernels take it past 64), allocates its (1 + n_aniso, 2 width, n)
  accumulator and counts one launch of the wide instance (and, with no
  isotropic term, one of the count kernel's self form); K15's hands the
  same padded width to ``svgd_phi_rbf_wide`` with P, or with a caller's
  (lam, V), allocates (2 width, n) and counts one launch, and never
  calls ``svgd_sym_eigen``, which still refuses past 64 with its own
  reason (one block's shared memory).
* The driver with the card stood in at m = 123: auto on an anisotropic
  composition takes fused_aniso_terms_cuda; the 'cuda' route runs with a
  MEDIAN, CONSTANT or HESSIAN scale, and keeps no decomposition of a
  CONSTANT P past 64.
* The slice as a whole, float64, 5 steps at d = 123, rtol 1e-9: the
  anisotropic MVN (``aniso_mvn_workload(..., dim=123)``, the driver of
  ``build_aniso_svgd`` with the workload's float64 target and P) on
  fused_aniso_terms_cuda against the JAX driver on
  fused_aniso_terms_pallas with its sweep in the JAX package's own float64
  plain functions (``phi_rbf_terms_fused_counts`` and ``phi_rbf_cross`` a
  term), since the Pallas kernel computes in float32 and 'rbf_terms'
  takes a same-step median where the fused routes take the lag-1 one
  (the first step equals 'rbf_terms', checked too); and the 'cuda' route
  with a HESSIAN scale against the JAX 'dense' driver.
* MultivariateNormal's closed-form Hessian against the Jacobian of its score
  and the JAX model's (float64, 1e-12).
* The bounds (``utils/profiling``): the wide K15's Y operand and Gram
  form, K14's wide groups on the tensor cores.

The whole file takes about 90 s in one process.
"""

from contextlib import nullcontext
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.ops import pallas_phi as pj
from svgdcpp_tpu.ops import phi as phj
from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.ops import phi as pht
from svgdcpp_tpu_torch.ops.sym_plan import wide_row_width
from svgdcpp_tpu_torch.utils.workloads import (
    ANISO_ADAGRAD_LR,
    aniso_mvn_workload,
    build_aniso_svgd,
)

torch.set_num_threads(1)

#: The widths past 64: just past it, a round one and a9a's 123 features.
WIDE = (65, 100, 123)

#: The most the Pallas kernel's counts may differ from the plain version's
#: (one pair, both orders, on the other side of a threshold, twice over),
#: as in test_torch_wide.py.
COUNT_SLACK = 4

#: (isotropic signs, anisotropic signs) of the K14 cases.
TERMS = {"iso+1": ((1.0,), (0.8,)), "iso+2": ((1.0,), (1.0, -0.4)),
         "0+1": ((), (1.0,)), "0+2": ((), (0.8, 0.5))}


def _inputs(n, m, offset, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, m)) + offset).astype(np.float32)
    s = rng.normal(size=(n, m)).astype(np.float32)
    return x, s


def _pd(m, gamma, seed):
    """gamma (0.5 I + A A^T / m), A ~ N(0, 1): d^T P d of order one for
    unit-variance points at gamma ~ 1/m."""
    a = np.random.default_rng(seed).normal(size=(m, m))
    return (gamma * (0.5 * np.eye(m) + a @ a.T / m)).astype(np.float32)


def _indefinite(m, gamma, seed, low=-0.3):
    """gamma (diag(1 .. low) + 0.05 A): eigenvalues of both signs."""
    a = np.random.default_rng(seed).normal(size=(m, m))
    return (gamma * (np.diag(np.linspace(1.0, low, m)) + 0.05 * a)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ----------------------------------------------------------------------
# The plain versions against the Pallas kernels
# ----------------------------------------------------------------------


@pytest.mark.parametrize("terms", sorted(TERMS))
@pytest.mark.parametrize("offset", [0.0, 100.0])
@pytest.mark.parametrize("m", WIDE)
def test_k14_wide_vs_pallas_interpret(m, offset, terms):
    iso_s, an_s = TERMS[terms]
    x, s = _inputs(300, m, offset, 800 + m)
    gamma = np.float32(0.6 / m)
    iso_g = [gamma, np.float32(2.0 * gamma)][:len(iso_s)]
    ps = [_pd(m, gamma, 810 + t) for t in range(len(an_s))]
    thr = np.linspace(0.5, 4.0 * m, 4).astype(np.float32)
    want = pj.phi_rbf_aniso_terms_fused_pallas(
        jnp.asarray(x), jnp.asarray(s), [jnp.float32(g) for g in iso_g],
        iso_s, [jnp.asarray(p) for p in ps], an_s, jnp.asarray(thr),
        interpret=True)
    cuda_phi.reset_launch_counts()
    got = cuda_phi.phi_rbf_aniso_terms_fused_cuda(
        _t(x), _t(s), [torch.tensor(g) for g in iso_g], iso_s,
        [_t(p) for p in ps], an_s, _t(thr))
    assert not any(cuda_phi.launch_counts.values())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-4, atol=2e-5)
    exact = pht.phi_rbf_aniso_terms_fused_counts(
        _t(x).double(), _t(s).double(),
        [torch.tensor(float(g), dtype=torch.float64) for g in iso_g], iso_s,
        [_t(p).double() for p in ps], an_s, _t(thr).double())[1]
    np.testing.assert_array_equal(got[1].numpy(), exact.numpy())
    cnt = np.asarray(want[1]).astype(np.int64)
    assert np.abs(got[1].numpy() - cnt).max() <= COUNT_SLACK


@pytest.mark.parametrize("psd", [True, False])
@pytest.mark.parametrize("m", WIDE)
def test_k15_wide_vs_pallas_interpret(m, psd):
    """The wrapper's CPU branch (the eigen form) and the wide kernel's own
    form (phi_rbf_gram) against _phi_rbf_pallas_impl, off origin."""
    x, s = _inputs(300, m, 100.0 if m == 123 else 2.0, 820 + m)
    gamma = 0.6 / m
    p = _pd(m, gamma, 830) if psd else _indefinite(m, gamma, 831)
    want = np.asarray(pj._phi_rbf_pallas_impl(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(p), 64, 128, True, psd))
    cuda_phi.reset_launch_counts()
    got = cuda_phi.phi_rbf_cuda(_t(x), _t(s), _t(p), psd=psd)
    assert not any(cuda_phi.launch_counts.values())
    half = 0.5 * (_t(p).double() + _t(p).double().T)
    gram = pht.phi_rbf_gram(_t(x), _t(s), half, psd=psd)
    for phi in (got, gram):
        np.testing.assert_allclose(phi.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("psd", [True, False])
def test_gram_operands_reproduce_the_form(psd):
    """q_i + q_j - 2 x_i . y_j = d^T P d in float64 for the wide K15's
    operands, P positive definite or indefinite."""
    m = 123
    x = torch.from_numpy(_inputs(40, m, 0.0, 840)[0]).double()
    x = x - x.mean(dim=0)
    p = torch.from_numpy(_pd(m, 1.0, 841) if psd
                         else _indefinite(m, 1.0, 841, low=-3.0)).double()
    y, q = pht.gram_operands(x, 0.5 * (p + p.T))
    assert y.dtype == q.dtype == torch.float64
    form = q[:, None] + q[None, :] - 2.0 * x @ y.T
    d = x[:, None, :] - x[None, :, :]
    want = torch.einsum("ija,ab,ijb->ij", d, p, d)
    scale = float(want.abs().max())
    assert float((form - want).abs().max()) <= 1e-12 * scale
    if not psd:
        assert float(want.min()) < 0.0


# ----------------------------------------------------------------------
# The wrappers on a stand-in library
# ----------------------------------------------------------------------


def _stand_in(monkeypatch, calls, shapes):
    """A library that records each launch, the card's context managers
    stood in, and the shapes of the buffers the wrappers allocate."""

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 0
            return entry

    monkeypatch.setattr(cuda_phi, "_require_cuda", lambda tensor: None)
    monkeypatch.setattr(cuda_phi, "load_library", Library)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    for name in ("empty", "zeros"):
        real = getattr(torch, name)

        def spy(*size, real=real, **kw):
            one = size[0] if len(size) == 1 else size
            shapes.append(tuple(one) if isinstance(one, (tuple, list))
                          else (one,))
            return real(*size, **kw)
        monkeypatch.setattr(torch, name, spy)


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("m", [65, 123, 512])
def test_k14_wide_wrapper_launches_past_64(monkeypatch, m):
    """One and two anisotropic terms, with and without an isotropic term:
    the groups' entry gets the rows' padded width (wide_row_width(m)), the
    wrapper allocates (1 + n_aniso, 2 width, n) and counts one launch of
    the wide instance, none of the narrow one; with no isotropic term one
    launch of the count kernel's self form follows, for the counts."""
    calls, shapes = [], []
    _stand_in(monkeypatch, calls, shapes)
    n, thr, g = 300, _meta(3), _meta()
    x = _meta(n, m)
    width = wide_row_width(m)
    for iso_s, an_s in TERMS.values():
        del calls[:], shapes[:]
        cuda_phi.reset_launch_counts()
        phi, counts = cuda_phi.phi_rbf_aniso_terms_fused_cuda(
            x, x, [g] * len(iso_s), iso_s, None, an_s, thr,
            lowers=_meta(len(an_s), m, m).double())
        entries = ["svgd_fused_phi_aniso_terms_groups"]
        if not iso_s:
            entries.append("svgd_count_le_self")
        assert [c[0] for c in calls] == entries
        args = calls[0][1]
        assert args[5] == len(iso_s) and args[7] == len(an_s)
        assert (args[9], args[10], args[11]) == (n, width, 3)
        assert (1 + len(an_s), 2 * width, n) in shapes
        assert (len(an_s), width, width) in shapes
        assert tuple(phi.shape) == (n, m) and tuple(counts.shape) == (3,)
        assert cuda_phi.launch_counts[cuda_phi.ANISO_WIDE_KERNEL] == 1
        assert cuda_phi.launch_counts[cuda_phi.COUNT_KERNEL] == (
            0 if iso_s else 1)
        assert sum(cuda_phi.launch_counts.values()) == 1 + (not iso_s)
    cuda_phi.reset_launch_counts()


@pytest.mark.parametrize("m", [65, 123, 512])
def test_k15_wide_wrapper_launches_past_64(monkeypatch, m):
    """With P (a HESSIAN scale, each call) and with a caller's (lam, V) (a
    MEDIAN's gamma I): one launch of svgd_phi_rbf_wide with the padded
    width ``wide_row_width(m)`` (the float32 triangle body's 16-byte
    copies) and psd, the (2 width, n) accumulator, and no svgd_sym_eigen,
    which still refuses past 64, naming its one block's shared memory."""
    calls, shapes = [], []
    _stand_in(monkeypatch, calls, shapes)
    n = 300
    x = _meta(n, m)
    width = wide_row_width(m)
    for psd, p, eig in ((False, _meta(m, m), None),
                        (True, None, (_meta(m), _meta(m, m)))):
        del calls[:], shapes[:]
        cuda_phi.reset_launch_counts()
        phi = cuda_phi.phi_rbf_cuda(x, x, p, psd=psd, eig=eig)
        assert [c[0] for c in calls] == ["svgd_phi_rbf_wide"]
        assert calls[0][1][4:7] == (n, width, int(psd))
        assert (2 * width, n) in shapes
        assert tuple(phi.shape) == (n, m)
        assert cuda_phi.launch_counts[cuda_phi.PHI_RBF_WIDE_KERNEL] == 1
        assert sum(cuda_phi.launch_counts.values()) == 1
    with pytest.raises(ValueError,
                       match=r"m <= 64.*shared memory.*P itself"):
        cuda_phi.symmetric_eigen(_meta(m, m))
    cuda_phi.reset_launch_counts()


# ----------------------------------------------------------------------
# The driver with the card stood in
# ----------------------------------------------------------------------


def _on_card(svgd):
    """Re-run the driver's route selection as if its coordinates lay on a
    CUDA device."""
    svgd.store = SimpleNamespace(
        value=SimpleNamespace(device=SimpleNamespace(type="cuda")))
    svgd._select_impl()
    return svgd


def test_auto_takes_the_aniso_kernel_route_past_64():
    """auto on the anisotropic MVN at d = 123 and 2100 particles: the CPU
    rule's rbf_terms, and with the card stood in fused_aniso_terms_cuda
    without a dimension error."""
    mean, cov, x0, p = aniso_mvn_workload(2100, dim=123)
    svgd = build_aniso_svgd(x0, mean, cov, p, num_iterations=1,
                            device="cpu")
    assert svgd._phi_impl == "rbf_terms"
    assert _on_card(svgd)._phi_impl == "fused_aniso_terms_cuda"


@pytest.mark.parametrize("scale", ["MEDIAN", "CONSTANT", "HESSIAN"])
def test_cuda_route_past_64_keeps_no_decomposition(scale):
    """The 'cuda' route at m = 123 with the card stood in raises no
    dimension error; past 64 the step hands K15 the MEDIAN's (diagonal,
    I) and nothing for a CONSTANT or HESSIAN P (K15 takes P itself), while
    at m = 11 it keeps a CONSTANT P's decomposition."""
    for dim in (123, 11):
        rng = np.random.default_rng(850)
        x0 = rng.normal(size=(64, dim))
        model = st.MultivariateNormal(np.zeros(dim), np.eye(dim))
        kernel = st.GaussianRBFKernel(
            x0, getattr(st.ScaleMethod, scale), model,
            constant_scale=(0.1 * np.eye(dim) if scale == "CONSTANT"
                            else None))
        svgd = st.SVGD(st.SVGDOptions(
            dimension=dim, num_iterations=1, coordinate_matrix=x0,
            kernel=kernel, model=model, optimizer=st.AdaGrad(dim, 64, 0.1),
            phi_impl="cuda", device="cpu")).initialize()
        p = svgd.kernel.parameters[0]
        eig = svgd._fixed_p_eigen(torch.as_tensor(p))
        if scale == "MEDIAN":
            assert eig is not None
        else:
            assert (eig is None) is (dim > 64 or scale == "HESSIAN")
        assert _on_card(svgd)._phi_impl == "cuda"


# ----------------------------------------------------------------------
# The slice as a whole
# ----------------------------------------------------------------------


def _jax_f64_aniso_sweep(coords, scores, iso_gammas, iso_signs, aniso_ps,
                         aniso_signs, thresholds_sq, **_):
    """The JAX package's anisotropic fused sweep computed by its own
    float64 plain functions: the isotropic terms' fused sweep (phi and the
    Euclidean counts) plus each anisotropic term's closed form."""
    phi, counts = phj.phi_rbf_terms_fused_counts(
        coords, scores, list(iso_gammas), list(iso_signs), thresholds_sq)
    for p, sign in zip(aniso_ps, aniso_signs):
        phi = phi + sign * phj.phi_rbf_cross(coords, coords, scores, p,
                                             psd=True)
    return phi, counts


def _aniso_driver(pkg, x0, mean, cov, p_aniso, impl, iters, scale=None):
    """build_aniso_svgd's driver (median RBF + RBF(P), or one RBF of
    ``scale``; AdaGrad at ANISO_ADAGRAD_LR) in either package, with the
    workload's float64 target and P: build_aniso_svgd casts them to float32,
    and the JAX package forms a float32 target's HESSIAN scale in float32,
    which alone moves the first step by 2e-8."""
    n, dim = x0.shape
    model = pkg.MultivariateNormal(mean, cov)
    if scale is None:
        kernel = pkg.GaussianRBFKernel(
            x0.copy(), pkg.ScaleMethod.MEDIAN, model) + pkg.GaussianRBFKernel(
            x0.copy(), pkg.ScaleMethod.CONSTANT, constant_scale=p_aniso)
    else:
        kernel = pkg.GaussianRBFKernel(x0.copy(), scale(pkg), model)
    kw = {"device": "cpu"} if pkg is st else {}
    return pkg.SVGD(pkg.SVGDOptions(
        dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model,
        optimizer=pkg.AdaGrad(dim, n, ANISO_ADAGRAD_LR), phi_impl=impl,
        **kw)).initialize()


def test_aniso_driver_d123_matches_jax(monkeypatch):
    """The anisotropic MVN at d = 123, n = 300, float64: the port's
    fused_aniso_terms_cuda (its plain version on the CPU) for 5 steps
    against the JAX driver's fused_aniso_terms_pallas with its sweep in
    float64 plain functions, and its first step against JAX's rbf_terms."""
    mean, cov, x0, p = aniso_mvn_workload(300, dim=123)
    x0 = x0.astype(np.float64)
    monkeypatch.setattr(pj, "phi_rbf_aniso_terms_fused_pallas",
                        _jax_f64_aniso_sweep)
    for iters, impl_j in ((5, "fused_aniso_terms_pallas"),
                          (1, "rbf_terms")):
        port = _aniso_driver(st, x0, mean, cov, p, "fused_aniso_terms_cuda",
                             iters)
        ref = _aniso_driver(sv, x0, mean, cov, p, impl_j, iters)
        assert port._phi_impl == "fused_aniso_terms_cuda"
        assert ref._phi_impl == impl_j
        np.testing.assert_allclose(port.run().numpy(), np.asarray(ref.run()),
                                   rtol=1e-9, atol=1e-12)
        assert port.median_fallbacks == 0


def test_hessian_cuda_route_d123_matches_jax_dense():
    """Phase 18's HESSIAN target at d = 123, n = 300, float64: the 'cuda'
    route (on the CPU the eigen form with torch.linalg.eigh) for 5 steps
    against the JAX 'dense' driver."""
    mean, cov, x0, p = aniso_mvn_workload(300, dim=123)
    x0 = x0.astype(np.float64)

    def hessian(pkg):
        return pkg.ScaleMethod.HESSIAN
    port = _aniso_driver(st, x0, mean, cov, p, "cuda", 5, hessian)
    ref = _aniso_driver(sv, x0, mean, cov, p, "dense", 5, hessian)
    assert port._rbf_psd is False and port._phi_impl == "cuda"
    np.testing.assert_allclose(port.run().numpy(), np.asarray(ref.run()),
                               rtol=1e-9, atol=1e-12)


def test_wide_bounds_count_the_groups_and_y():
    """utils/profiling: the wide K15 reads Y and q besides P, its Gram
    form costs 2m + 3 a pair for the form; K14's wide groups put a Gram
    product and both contractions a group on the tensor cores, group 0's
    contraction only with an isotropic term."""
    from svgdcpp_tpu_torch.utils import profiling as pf

    n, m = 10240, 123
    sq_flops, sq_bytes = pf.sweep_work("phi_rbf_square", n, m)
    wide_flops, wide_bytes = pf.sweep_work("phi_rbf_wide", n, m)
    tri = n * (n + 1) / 2
    assert wide_bytes == sq_bytes + 4 * (n * m + n)
    assert sq_flops - wide_flops == tri * (4 * m + 2 - (2 * m + 5))
    assert (pf.sweep_work("fused_phi_aniso_terms_wide", n, m, n_aniso=2)
            == pf.sweep_work("fused_phi_aniso_terms_sym", n, m, n_aniso=2))
    for n_iso, n_aniso in ((1, 1), (1, 2), (0, 1)):
        ms, by = pf.tri_tensor_bound(n, m, n_terms=n_iso, n_aniso=n_aniso)
        tensor = 2 * m + (8 * m if n_iso else 0) + n_aniso * 10 * m
        assert by == "tensor operations"
        assert ms == pytest.approx(tri * tensor / pf.PEAK_TF32_FLOPS * 1e3)
    ms, by = pf.tri_tensor_bound(n, m, fixed_p=True)
    assert ms == pytest.approx(pf.tri_tensor_bound(n, m)[0])


def test_mvn_closed_form_hessian():
    """MultivariateNormal's Hessian (-Sigma^{-1} in closed form, which a
    HESSIAN scale at d = 123 and 10,240 particles needs) equals the
    Jacobian of its score and the JAX model's, in float64; a subclass that
    overrides the score keeps the Jacobian of its own score."""
    from svgdcpp_tpu_torch.models.model import Model

    mean, cov, x0, _ = aniso_mvn_workload(6, dim=123)
    x = torch.from_numpy(x0).double()
    model = st.MultivariateNormal(mean, cov)
    params = tuple(torch.as_tensor(p) for p in model.parameters)
    got = model.evaluate_log_model_hessian(x)
    jac = torch.stack([Model.hessian_log_density_pure(model, xi, params)
                       for xi in x])
    want = np.asarray(sv.MultivariateNormal(mean, cov)
                      .evaluate_log_model_hessian(np.asarray(x0, np.float64)))
    scale = float(jac.abs().max())
    assert float((got - jac).abs().max()) <= 1e-12 * scale
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * scale)

    class Doubled(st.MultivariateNormal):
        def grad_log_density_pure(self, xi, p):
            return 2.0 * super().grad_log_density_pure(xi, p)

    doubled = Doubled(mean, cov).evaluate_log_model_hessian(x[:2])
    np.testing.assert_allclose(doubled.numpy(), 2.0 * got[:2].numpy(),
                               rtol=1e-10, atol=1e-12 * scale)
