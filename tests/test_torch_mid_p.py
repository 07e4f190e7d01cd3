"""K14's term groups and K15 at the mid widths (m = 9, 10 and 12-64), where
both run csrc/wide_tri_sm90.cuh's body in float32, on the CPU.

* The width rules (``ops/sym_plan``): ``k15_wide``, ``aniso_groups_wide``
  and ``aniso_one_pass`` at m = 1-130 against the table they stand for,
  and against the C side's copies in csrc/sweep_common.cuh (the one-pass
  kernel's kOnePassMaxM and the predicates' definitions) and the
  one-pass instances csrc/fused_phi_aniso.cu builds.
* K15's wide form's plain version ``phi_rbf_gram`` against
  ``phi_rbf_pallas`` in interpret mode at m = 9, 10, 12, 33, 54 and 64, P
  positive definite (psd) and indefinite; rtol 2e-4, atol 2e-5 (the JAX
  package's interpret tolerance, as tests/test_torch_wide_p.py).
* K14's wide groups' plain slabs ``aniso_groups_plain`` through the
  wrapper's epilogue ``aniso_groups_finish`` against
  ``phi_rbf_aniso_terms_fused_pallas`` in interpret mode at the same
  widths, for iso + 1, iso + 2 with a negative sign, 0 + 1 and two
  isotropic terms + 1, on grid inputs (multiples of 1/8, thresholds off
  the grid), where every pair distance is exact in both and the counts
  must be equal.
* The wrappers on a stand-in library (meta tensors stand in for the card):
  each mid width launches ``svgd_phi_rbf_wide`` (K15, with P and with a
  caller's (lam, V)) or the term-group entry (K14, every term set) once,
  with the rows' padded width, and never ``svgd_sym_eigen`` or
  ``svgd_phi_rbf_square``; m = 2, 8 and 11 launch what they launched
  before: the decomposition and the micro-tile triangle for K15, the
  groups at width m for K14.
* The driver's kept decomposition: ``SVGD._fixed_p_eigen`` keeps none of a
  CONSTANT P at m = 9-64 and keeps one at m = 2, 8 and 11.
* The bounds (``utils/profiling``) price K15's Gram form and K14's wide
  groups at m = 54 as past 64.
* The slice as a whole at Covertype's width (d = 54), float64, 5 steps,
  rtol 1e-9: the anisotropic MVN on fused_aniso_terms_cuda against the JAX
  driver on fused_aniso_terms_pallas with its sweep in the JAX package's
  float64 plain functions, and the HESSIAN 'cuda' route against the JAX
  'dense' driver (tests/test_torch_wide_p.py's construction at d = 123).

About 60 s in one process.
"""

import re
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
from svgdcpp_tpu_torch.ops import cuda_phi, sym_plan
from svgdcpp_tpu_torch.ops import phi as pht
from svgdcpp_tpu_torch.ops.median import count_le_plain
from svgdcpp_tpu_torch.utils.cuda_build import CSRC_DIR
from svgdcpp_tpu_torch.utils.workloads import (
    ANISO_ADAGRAD_LR,
    aniso_mvn_workload,
)

torch.set_num_threads(1)

#: The mid widths held against the Pallas kernels: the two padded to 12,
#: the first multiple of 4, the first of two 32-column slices, Covertype's
#: 54 and the last below the wide instances past 64.
MID = (9, 10, 12, 33, 54, 64)

#: The micro widths, where both kernels keep their micro-tile bodies.
MICRO = (1, 2, 3, 4, 5, 6, 7, 8, 11)

#: (isotropic signs, anisotropic signs) of the K14 cases (chip_smoke.py's
#: WIDE_P_TERMS).
TERMS = {"iso+1": ((1.0,), (1.0,)), "iso+2": ((1.0,), (1.0, -0.5)),
         "0+1": ((), (1.0,)), "2iso+1": ((1.0, -0.5), (1.0,))}


def _grid(n, m, seed):
    """float32 (x, s, thresholds) on a grid: coordinates multiples of 1/8,
    symmetric about 0 (each row's mirror image is a row), thresholds
    halfway between multiples of 1/64 at pair-distance quantiles; every
    pair's squared distance is exact in float32, by differences or by
    the Gram identity, so no pair lies within rounding of a threshold."""
    rng = np.random.default_rng(seed)
    half = np.round(rng.normal(size=(n // 2, m)) * 8.0) / 8.0
    x = np.concatenate([half, -half])[rng.permutation(2 * (n // 2))]
    s = rng.normal(size=x.shape)
    d = x[:, None, :] - x[None, :, :]
    sq = np.sum(d * d, axis=-1)
    q = (np.floor(np.quantile(sq, [0.25, 0.5, 0.75]) * 64.0) + 0.5) / 64.0
    return (x.astype(np.float32), s.astype(np.float32),
            q.astype(np.float32))


def _pd(m, gamma, seed):
    """gamma (0.5 I + A A^T / m), A ~ N(0, 1)."""
    a = np.random.default_rng(seed).normal(size=(m, m))
    return (gamma * (0.5 * np.eye(m) + a @ a.T / m)).astype(np.float32)


def _indefinite(m, gamma, seed):
    """gamma (diag(1 .. -0.3) + 0.05 A): eigenvalues of both signs."""
    a = np.random.default_rng(seed).normal(size=(m, m))
    return (gamma * (np.diag(np.linspace(1.0, -0.3, m)) + 0.05 * a)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ----------------------------------------------------------------------
# The width rules
# ----------------------------------------------------------------------


def test_width_rules_table():
    """m = 1-130: K15 and K14's groups on the wide body at every m but the
    micro widths (K15's bf16 instance at every m); the one-pass kernel for
    one anisotropic term at the micro widths and up to ONE_PASS_MAX_M,
    never for two or more terms, never at m < 1."""
    for m in range(1, 131):
        micro = m in MICRO
        assert sym_plan.k15_wide(m) is (not micro)
        assert sym_plan.k15_wide(m, bf16=True) is True
        assert sym_plan.aniso_groups_wide(m) is (not micro)
        assert sym_plan.aniso_one_pass(m, 1) is (
            micro or m <= sym_plan.ONE_PASS_MAX_M)
        for n_aniso in (2, 3, 8):
            assert sym_plan.aniso_one_pass(m, n_aniso) is False
    assert not sym_plan.aniso_one_pass(0, 1)
    assert sym_plan.ONE_PASS_MAX_M in (8, 16, 32)


def test_width_rules_match_the_c_side():
    """csrc/sweep_common.cuh defines the C predicates as sym_plan does
    (k15_wide and aniso_groups_wide as tri_wide, the one-pass rule over
    kOnePassMaxM = ONE_PASS_MAX_M), and csrc/fused_phi_aniso.cu builds
    the one-pass kernel's runtime-m instances up to that width and no
    further. chip_smoke.py phase 49d holds the built library's exports
    (svgd_k15_wide, svgd_aniso_groups_wide, svgd_aniso_one_pass) to
    sym_plan at m = 1-130 on the card."""
    common = (CSRC_DIR / "sweep_common.cuh").read_text()
    assert "inline bool k15_wide(int m) { return tri_wide(m); }" in common
    assert ("inline bool aniso_groups_wide(int m) { return tri_wide(m); }"
            in common)
    assert "return n_aniso == 1 && m >= 1 && (!tri_wide(m) || m <= " \
           "kOnePassMaxM);" in common
    limit = re.search(r"constexpr int kOnePassMaxM = (\d+);", common)
    assert int(limit.group(1)) == sym_plan.ONE_PASS_MAX_M
    aniso = (CSRC_DIR / "fused_phi_aniso.cu").read_text()
    runtime = sorted(int(mm) for mm in re.findall(
        r"SVGD_LAUNCH_ONE\((\d+), false\)", aniso))
    assert runtime[0] == 8
    assert runtime[-1] == max(8, sym_plan.ONE_PASS_MAX_M)


# ----------------------------------------------------------------------
# The plain versions against the Pallas kernels
# ----------------------------------------------------------------------


@pytest.mark.parametrize("psd", [True, False])
@pytest.mark.parametrize("m", MID)
def test_k15_gram_vs_pallas_interpret(m, psd):
    """The wide sweep's own form (phi_rbf_gram on P_sym/2) and the
    wrapper's CPU branch (the eigen form) against phi_rbf_pallas, off
    origin."""
    rng = np.random.default_rng(600 + m)
    x = (rng.normal(size=(300, m)) + 2.0).astype(np.float32)
    s = rng.normal(size=(300, m)).astype(np.float32)
    gamma = 0.6 / m
    p = _pd(m, gamma, 610) if psd else _indefinite(m, gamma, 611)
    want = np.asarray(pj.phi_rbf_pallas(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(p), tile_i=64,
        tile_j=128, interpret=True, psd=psd))
    half = 0.5 * (_t(p).double() + _t(p).double().T)
    cuda_phi.reset_launch_counts()
    for phi in (pht.phi_rbf_gram(_t(x), _t(s), half, psd=psd),
                cuda_phi.phi_rbf_cuda(_t(x), _t(s), _t(p), psd=psd)):
        np.testing.assert_allclose(phi.numpy(), want, rtol=2e-4, atol=2e-5)
    assert not any(cuda_phi.launch_counts.values())


@pytest.mark.parametrize("terms", sorted(TERMS))
@pytest.mark.parametrize("m", MID)
def test_k14_groups_vs_pallas_interpret(m, terms):
    """The wide groups' plain slabs through the wrapper's epilogue against
    phi_rbf_aniso_terms_fused_pallas: phi within the interpret tolerance,
    the counts (2U - n of group 0, or the count pass's with no isotropic
    term) equal to the Pallas kernel's and the float64 plain version's."""
    iso_s, an_s = TERMS[terms]
    x, s, thr = _grid(256, m, 620 + m)
    n = x.shape[0]
    gamma = np.float32(0.6 / m)
    iso_g = [gamma, np.float32(2.0 * gamma)][:len(iso_s)]
    ps = [_pd(m, gamma, 630 + t) for t in range(len(an_s))]
    want = pj.phi_rbf_aniso_terms_fused_pallas(
        jnp.asarray(x), jnp.asarray(s), [jnp.float32(g) for g in iso_g],
        iso_s, [jnp.asarray(p) for p in ps], an_s, jnp.asarray(thr),
        interpret=True)
    g32 = [torch.tensor(g) for g in iso_g]
    lowers = cuda_phi.cholesky_factors([_t(p) for p in ps], "cpu")
    acc, upper = pht.aniso_groups_plain(_t(x), _t(s), g32, iso_s, an_s,
                                        _t(thr), lowers)
    phi = pht.aniso_groups_finish(acc, _t(s), g32[0] if g32 else None,
                                  iso_s, an_s, lowers, n)
    counts = (2 * upper - n if iso_s
              else count_le_plain(_t(x), _t(x), _t(thr)))
    np.testing.assert_allclose(phi.numpy(), np.asarray(want[0]), rtol=2e-4,
                               atol=2e-5)
    exact = pht.phi_rbf_aniso_terms_fused_counts(
        _t(x).double(), _t(s).double(),
        [torch.tensor(float(g), dtype=torch.float64) for g in iso_g], iso_s,
        [_t(p).double() for p in ps], an_s, _t(thr).double())[1]
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(want[1]).astype(np.int64))
    np.testing.assert_array_equal(counts.numpy(), exact.numpy())


# ----------------------------------------------------------------------
# The wrappers on a stand-in library
# ----------------------------------------------------------------------


def _stand_in(monkeypatch, calls):
    """A library that records each launch (and returns 0), with the
    card's context managers stood in."""

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


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("m", [9, 10, 12, 13, 16, 17, 24, 32, 33, 50, 54,
                               55, 64, 2, 8, 11])
def test_k15_wrapper_launches_by_width(monkeypatch, m):
    """A HESSIAN-like P each call (no decomposition given) and a caller's
    (lam, V): at a mid width one launch of svgd_phi_rbf_wide with the
    padded width and psd, no svgd_sym_eigen and no svgd_phi_rbf_square;
    at m = 2, 8 and 11 the decomposition (where none is given) and the
    micro-tile triangle at width m."""
    calls = []
    _stand_in(monkeypatch, calls)
    n, x = 300, _meta(300, m)
    wide = m not in MICRO
    for psd, p, eig in ((False, _meta(m, m).double(), None),
                        (True, None, (_meta(m).double(),
                                      _meta(m, m).double()))):
        del calls[:]
        cuda_phi.reset_launch_counts()
        phi = cuda_phi.phi_rbf_cuda(x, x, p, psd=psd, eig=eig)
        assert tuple(phi.shape) == (n, m)
        names = [c[0] for c in calls]
        if wide:
            assert names == ["svgd_phi_rbf_wide"]
            assert calls[0][1][4:7] == (n, sym_plan.wide_row_width(m),
                                        int(psd))
            assert cuda_phi.launch_counts[cuda_phi.PHI_RBF_WIDE_KERNEL] == 1
            assert sum(cuda_phi.launch_counts.values()) == 1
        else:
            want = (["svgd_sym_eigen"] if eig is None else []) + [
                "svgd_phi_rbf_square"]
            assert names == want
            assert calls[-1][1][3:6] == (n, m, int(psd))
            assert cuda_phi.launch_counts[cuda_phi.PHI_RBF_KERNEL] == 1
            assert cuda_phi.launch_counts[cuda_phi.SYM_EIGEN_KERNEL] == (
                eig is None)
    cuda_phi.reset_launch_counts()


@pytest.mark.parametrize("m", [9, 10, 12, 13, 16, 17, 24, 32, 33, 50, 54,
                               55, 64, 2, 8, 11])
def test_k14_groups_wrapper_launches_by_width(monkeypatch, m):
    """Every term set the groups take (two anisotropic terms always; one
    where the one-pass rule does not hold): at a mid width one launch of
    the term-group entry with the padded width, counted under the wide
    instance; at m = 2, 8 and 11 the same entry at width m, counted under
    the narrow one; at every width, with no isotropic term, one count
    launch of the self form after it."""
    calls = []
    _stand_in(monkeypatch, calls)
    n, thr = 300, _meta(3)
    x = _meta(n, m)
    wide = m not in MICRO
    width = sym_plan.wide_row_width(m) if wide else m
    for iso_s, an_s in list(TERMS.values()) + [((), (0.8, 0.5))]:
        if sym_plan.aniso_one_pass(m, len(an_s)):
            continue
        del calls[:]
        cuda_phi.reset_launch_counts()
        phi, counts = cuda_phi.phi_rbf_aniso_terms_fused_cuda(
            x, x, [_meta()] * len(iso_s), iso_s, None, an_s, thr,
            lowers=_meta(len(an_s), m, m).double())
        assert tuple(phi.shape) == (n, m) and tuple(counts.shape) == (3,)
        names = [c[0] for c in calls]
        counted = not iso_s
        assert names == (["svgd_fused_phi_aniso_terms_groups"]
                         + (["svgd_count_le_self"] if counted else []))
        assert calls[0][1][9:12] == (n, width, 3)
        kernel = cuda_phi.ANISO_WIDE_KERNEL if wide else cuda_phi.ANISO_KERNEL
        assert cuda_phi.launch_counts[kernel] == 1
        assert sum(cuda_phi.launch_counts.values()) == 1 + counted
    cuda_phi.reset_launch_counts()


@pytest.mark.parametrize("m", [9, 12, 16, 17, 32, 33, 54, 2, 11])
def test_k14_one_term_follows_the_one_pass_rule(monkeypatch, m):
    """One anisotropic term beside the median RBF (the anisotropic MVN's
    composition): the one-pass entry at width m where aniso_one_pass
    holds, else the groups' entry at the padded width."""
    calls = []
    _stand_in(monkeypatch, calls)
    x = _meta(300, m)
    cuda_phi.reset_launch_counts()
    cuda_phi.phi_rbf_aniso_terms_fused_cuda(
        x, x, [_meta()], (1.0,), None, (1.0,), _meta(3),
        lowers=_meta(1, m, m).double())
    if sym_plan.aniso_one_pass(m, 1):
        assert [c[0] for c in calls] == ["svgd_fused_phi_aniso_terms_sym"]
        assert calls[0][1][9] == m
        assert cuda_phi.launch_counts[cuda_phi.ANISO_KERNEL] == 1
    else:
        assert [c[0] for c in calls] == ["svgd_fused_phi_aniso_terms_groups"]
        assert calls[0][1][10] == sym_plan.wide_row_width(m)
        assert cuda_phi.launch_counts[cuda_phi.ANISO_WIDE_KERNEL] == 1
    cuda_phi.reset_launch_counts()


def test_wide_groups_refuse_only_the_micro_widths(monkeypatch):
    """aniso_wide_groups_cuda (chip_smoke.py reads its raw slabs) refuses
    m = 1-8 and 11 before anything is launched, and launches the groups'
    entry once with the padded width at a mid width."""
    calls = []
    _stand_in(monkeypatch, calls)
    for m in MICRO:
        x = _meta(100, m)
        with pytest.raises(ValueError, match="every m but 1-8 and 11"):
            cuda_phi.aniso_wide_groups_cuda(x, x, [_meta()], (1.0,), (1.0,),
                                            _meta(3),
                                            _meta(1, m, m).double())
    assert not calls
    for m in (9, 10, 54):
        x = _meta(100, m)
        acc, _ = cuda_phi.aniso_wide_groups_cuda(
            x, x, [_meta()], (1.0,), (1.0,), _meta(3),
            _meta(1, m, m).double())
        width = sym_plan.wide_row_width(m)
        assert tuple(acc.shape) == (2, 2 * width, 100)
        assert calls[-1][0] == "svgd_fused_phi_aniso_terms_groups"
        assert calls[-1][1][10] == width
    cuda_phi.reset_launch_counts()


# ----------------------------------------------------------------------
# The driver's kept decomposition
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dim", [9, 10, 12, 33, 54, 64, 2, 8, 11])
def test_fixed_p_eigen_keeps_a_constant_p_only_at_the_micro_widths(dim):
    """The 'cuda' route with a CONSTANT P: at m = 9-64, where K15 takes P
    itself, the step hands it no decomposition; at m = 2, 8 and 11 it
    keeps one (the same object while P stays). A MEDIAN's (diagonal, I)
    at every width."""
    rng = np.random.default_rng(640 + dim)
    x0 = rng.normal(size=(48, dim))
    model = st.MultivariateNormal(np.zeros(dim), np.eye(dim))
    for scale in ("CONSTANT", "MEDIAN"):
        kernel = st.GaussianRBFKernel(
            x0, getattr(st.ScaleMethod, scale), model,
            constant_scale=(0.1 * np.eye(dim) if scale == "CONSTANT"
                            else None))
        svgd = st.SVGD(st.SVGDOptions(
            dimension=dim, num_iterations=1, coordinate_matrix=x0,
            kernel=kernel, model=model, optimizer=st.AdaGrad(dim, 48, 0.1),
            phi_impl="cuda", device="cpu")).initialize()
        p = torch.as_tensor(svgd.kernel.parameters[0])
        eig = svgd._fixed_p_eigen(p)
        if scale == "MEDIAN":
            assert eig is not None and torch.equal(eig[0], p.diagonal())
        elif dim in MICRO:
            assert eig is not None and svgd._fixed_p_eigen(p) is eig
        else:
            assert eig is None
        assert torch.isfinite(svgd.run()).all()


# ----------------------------------------------------------------------
# The bounds
# ----------------------------------------------------------------------


def test_bounds_price_the_mid_widths_as_past_64():
    """utils/profiling at (10240, 54): K15's wide form reads Y and q
    besides P and costs 2m + 5 a pair for the form and the weight where
    the eigen form costs 4m + 2; K14's wide groups count the function's
    work, and their tensor-core bound one Gram product and both
    contractions a group."""
    from svgdcpp_tpu_torch.utils import profiling as pf

    n, m = 10240, 54
    sq_flops, sq_bytes = pf.sweep_work("phi_rbf_square", n, m)
    wide_flops, wide_bytes = pf.sweep_work("phi_rbf_wide", n, m)
    tri = n * (n + 1) / 2
    assert wide_bytes == sq_bytes + 4 * (n * m + n)
    assert sq_flops - wide_flops == tri * (4 * m + 2 - (2 * m + 5))
    assert (pf.sweep_work("fused_phi_aniso_terms_wide", n, m, n_aniso=1)
            == pf.sweep_work("fused_phi_aniso_terms_sym", n, m, n_aniso=1))
    for n_iso, n_aniso in ((1, 1), (1, 2), (0, 1)):
        ms, by = pf.tri_tensor_bound(n, m, n_terms=n_iso, n_aniso=n_aniso)
        tensor = 2 * m + (8 * m if n_iso else 0) + n_aniso * 10 * m
        assert by == "tensor operations"
        assert ms == pytest.approx(tri * tensor / pf.PEAK_TF32_FLOPS * 1e3)
    ms, by = pf.sweep_bound("phi_rbf_wide", n, m)
    assert by == "operations"
    assert ms == pytest.approx(wide_flops / pf.PEAK_FP32_FLOPS * 1e3)


# ----------------------------------------------------------------------
# The slice as a whole at d = 54
# ----------------------------------------------------------------------


def _jax_f64_aniso_sweep(coords, scores, iso_gammas, iso_signs, aniso_ps,
                         aniso_signs, thresholds_sq, **_):
    """The JAX package's anisotropic fused sweep by its own float64 plain
    functions: the isotropic terms' fused sweep (phi and the Euclidean
    counts) plus each anisotropic term's closed form."""
    phi, counts = phj.phi_rbf_terms_fused_counts(
        coords, scores, list(iso_gammas), list(iso_signs), thresholds_sq)
    for p, sign in zip(aniso_ps, aniso_signs):
        phi = phi + sign * phj.phi_rbf_cross(coords, coords, scores, p,
                                             psd=True)
    return phi, counts


def _aniso_driver(pkg, x0, mean, cov, p_aniso, impl, iters, scale=None):
    """The anisotropic MVN's driver (median RBF + RBF(P), or one RBF of
    ``scale``; AdaGrad at ANISO_ADAGRAD_LR) in either package, with the
    workload's float64 target and P."""
    n, dim = x0.shape
    model = pkg.MultivariateNormal(mean, cov)
    if scale is None:
        kernel = pkg.GaussianRBFKernel(
            x0.copy(), pkg.ScaleMethod.MEDIAN, model) + pkg.GaussianRBFKernel(
            x0.copy(), pkg.ScaleMethod.CONSTANT, constant_scale=p_aniso)
    else:
        kernel = pkg.GaussianRBFKernel(x0.copy(), pkg.ScaleMethod.HESSIAN,
                                       model)
    kw = {"device": "cpu"} if pkg is st else {}
    return pkg.SVGD(pkg.SVGDOptions(
        dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model,
        optimizer=pkg.AdaGrad(dim, n, ANISO_ADAGRAD_LR), phi_impl=impl,
        **kw)).initialize()


def test_aniso_driver_d54_matches_jax(monkeypatch):
    """The anisotropic MVN at d = 54, n = 300, float64: the port's
    fused_aniso_terms_cuda (its plain version on the CPU) for 5 steps
    against the JAX driver's fused_aniso_terms_pallas with its sweep in
    float64 plain functions."""
    mean, cov, x0, p = aniso_mvn_workload(300, dim=54)
    x0 = x0.astype(np.float64)
    monkeypatch.setattr(pj, "phi_rbf_aniso_terms_fused_pallas",
                        _jax_f64_aniso_sweep)
    port = _aniso_driver(st, x0, mean, cov, p, "fused_aniso_terms_cuda", 5)
    ref = _aniso_driver(sv, x0, mean, cov, p, "fused_aniso_terms_pallas", 5)
    assert port._phi_impl == "fused_aniso_terms_cuda"
    np.testing.assert_allclose(port.run().numpy(), np.asarray(ref.run()),
                               rtol=1e-9, atol=1e-12)
    assert port.median_fallbacks == 0


def test_hessian_cuda_route_d54_matches_jax_dense():
    """The HESSIAN target at d = 54, n = 300, float64: the 'cuda' route
    (on the CPU the eigen form with torch.linalg.eigh) for 5 steps against
    the JAX 'dense' driver."""
    mean, cov, x0, p = aniso_mvn_workload(300, dim=54)
    x0 = x0.astype(np.float64)
    port = _aniso_driver(st, x0, mean, cov, p, "cuda", 5, scale="hessian")
    ref = _aniso_driver(sv, x0, mean, cov, p, "dense", 5, scale="hessian")
    assert port._rbf_psd is False and port._phi_impl == "cuda"
    np.testing.assert_allclose(port.run().numpy(), np.asarray(ref.run()),
                               rtol=1e-9, atol=1e-12)
