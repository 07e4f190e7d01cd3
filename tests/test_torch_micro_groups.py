"""K14's term groups at the micro widths (m = 1-8 and 11), where they run
csrc/micro_tile.cuh's triangle body and leave each group's slab in the
wide groups' convention, so that one epilogue (``ops/phi.
aniso_groups_finish``) finishes them at every m; on the CPU.

* The plain slabs ``aniso_groups_plain`` through ``aniso_groups_finish``
  against ``phi_rbf_aniso_terms_fused_pallas`` in interpret mode at
  m = 1, 2, 3, 5, 8 and 11, for iso + 1, iso + 2 with a negative sign,
  0 + 1, two isotropic terms + 1 and iso + 3, on grid inputs (multiples of
  1/8, thresholds off the grid: every pair distance exact, so the counts
  equal the Pallas kernel's and the float64 plain version's); rtol 2e-4,
  atol 2e-5 (the JAX package's interpret tolerance, as
  tests/test_torch_mid_p.py).
* The same at the tiles' edges, n = 127, 128, 129 and 257 (tiles of 128:
  one ragged tile, one full, a full and a single row, a second full and a
  single row), m = 2, 5 and 11, iso + 2.
* The wrapper on a stand-in library (meta tensors stand in for the
  card): at every micro width one launch of the groups' entry at width m,
  counted under ANISO_KERNEL, and with no isotropic term one launch of
  ``svgd_count_le_self`` after it; ``aniso_micro_groups_cuda`` refuses
  every m but 1-8 and 11 before it launches anything.
* The sources: csrc/terms_sym.cuh, ``SymTermsTile``, ``combine_terms``
  and ``SVGD_TERMS_SYM_KERNEL`` are gone, and the term-group entry's micro
  branch dispatches the micro-tile kernels.
* The slice as a whole at d = 11: the anisotropic MVN under median RBF +
  RBF(P) + RBF(P_2) (``utils/workloads.second_aniso_p``), float64,
  n = 300, 5 steps, on fused_aniso_terms_cuda against the JAX driver on
  fused_aniso_terms_pallas with its sweep in the JAX package's float64
  plain functions; rtol 1e-9.

About 55 s in one process.
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
    second_aniso_p,
)

torch.set_num_threads(1)

#: The micro widths: the groups' exact instances at m = 2 and 11, the
#: runtime one (MM = 8) at the others.
MICRO = (1, 2, 3, 4, 5, 6, 7, 8, 11)

#: (isotropic signs, anisotropic signs): tests/test_torch_mid_p.py's TERMS
#: and iso + 3.
TERMS = {"iso+1": ((1.0,), (1.0,)), "iso+2": ((1.0,), (1.0, -0.5)),
         "0+1": ((), (1.0,)), "2iso+1": ((1.0, -0.5), (1.0,)),
         "iso+3": ((1.0,), (1.0, 0.5, -0.3))}


def _grid(n, m, seed):
    """float32 (x, s, thresholds) on a grid: coordinates multiples of 1/8,
    symmetric about 0 (each row's mirror image is a row, and odd n adds the
    origin), thresholds halfway between multiples of 1/64 at pair-distance
    quantiles; every pair's squared distance is exact in float32, so no
    pair lies within rounding of a threshold."""
    rng = np.random.default_rng(seed)
    half = np.round(rng.normal(size=(n // 2, m)) * 8.0) / 8.0
    rows = [half, -half] + ([np.zeros((1, m))] if n % 2 else [])
    x = np.concatenate(rows)[rng.permutation(n)]
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


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ----------------------------------------------------------------------
# The plain slabs and the one epilogue against the Pallas kernel
# ----------------------------------------------------------------------


def _groups_vs_pallas(n, m, terms, seed):
    """aniso_groups_plain -> aniso_groups_finish (the counts 2U - n, or the
    count pass's with no isotropic term) against the Pallas kernel in
    interpret mode and the float64 plain version, on grid inputs."""
    iso_s, an_s = TERMS[terms]
    x, s, thr = _grid(n, m, seed)
    gamma = np.float32(0.6 / m)
    iso_g = [gamma, np.float32(2.0 * gamma)][:len(iso_s)]
    ps = [_pd(m, gamma, seed + 10 + t) for t in range(len(an_s))]
    want = pj.phi_rbf_aniso_terms_fused_pallas(
        jnp.asarray(x), jnp.asarray(s), [jnp.float32(g) for g in iso_g],
        iso_s, [jnp.asarray(p) for p in ps], an_s, jnp.asarray(thr),
        interpret=True)
    g32 = [torch.tensor(g) for g in iso_g]
    lowers = cuda_phi.cholesky_factors([_t(p) for p in ps], "cpu")
    acc, upper = pht.aniso_groups_plain(_t(x), _t(s), g32, iso_s, an_s,
                                        _t(thr), lowers)
    assert tuple(acc.shape) == (1 + len(an_s), 2 * m, n)
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


@pytest.mark.parametrize("terms", sorted(TERMS))
@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 11])
def test_micro_groups_vs_pallas_interpret(m, terms):
    _groups_vs_pallas(256, m, terms, 700 + m)


@pytest.mark.parametrize("m", [2, 5, 11])
@pytest.mark.parametrize("n", [127, 128, 129, 257])
def test_micro_groups_tile_edges_vs_pallas_interpret(n, m):
    _groups_vs_pallas(n, m, "iso+2", 720 + n + m)


# ----------------------------------------------------------------------
# The wrapper on a stand-in library
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


@pytest.mark.parametrize("m", MICRO)
def test_micro_groups_wrapper_launches_by_width(monkeypatch, m):
    """Every term set the groups take: one launch of the groups' entry at
    width m (n, m, T among its arguments), counted under ANISO_KERNEL, and
    with no isotropic term one launch of the count kernel's self form
    after it; nothing else."""
    calls = []
    _stand_in(monkeypatch, calls)
    n = 300
    x = _meta(n, m)
    for iso_s, an_s in list(TERMS.values()) + [((), (0.8, 0.5)),
                                               ((1.0,), (1.0,) * 7)]:
        if sym_plan.aniso_one_pass(m, len(an_s)):
            continue
        del calls[:]
        cuda_phi.reset_launch_counts()
        phi, counts = cuda_phi.phi_rbf_aniso_terms_fused_cuda(
            x, x, [_meta()] * len(iso_s), iso_s, None, an_s, _meta(3),
            lowers=_meta(len(an_s), m, m).double())
        assert tuple(phi.shape) == (n, m) and tuple(counts.shape) == (3,)
        assert [c[0] for c in calls] == (
            ["svgd_fused_phi_aniso_terms_groups"]
            + (["svgd_count_le_self"] if not iso_s else []))
        assert calls[0][1][5] == len(iso_s) and calls[0][1][7] == len(an_s)
        assert calls[0][1][9:12] == (n, m, 3)
        assert cuda_phi.launch_counts[cuda_phi.ANISO_KERNEL] == 1
        assert cuda_phi.launch_counts[cuda_phi.ANISO_WIDE_KERNEL] == 0
        assert sum(cuda_phi.launch_counts.values()) == 1 + (not iso_s)
    cuda_phi.reset_launch_counts()


def test_micro_groups_refuse_every_other_width(monkeypatch):
    """aniso_micro_groups_cuda (chip_smoke.py reads its raw slabs) refuses
    every m but 1-8 and 11 before anything is launched, and at a micro
    width launches the groups' entry once and returns the raw slabs
    (1 + n_aniso, 2m, n) at width m."""
    calls = []
    _stand_in(monkeypatch, calls)
    for m in (9, 10, 12, 16, 33, 54, 64, 65, 123):
        x = _meta(100, m)
        with pytest.raises(ValueError, match="m = 1-8 and 11"):
            cuda_phi.aniso_micro_groups_cuda(
                x, x, [_meta()], (1.0,), (1.0, 0.5), _meta(3),
                _meta(2, m, m).double())
    assert not calls
    for m in MICRO:
        x = _meta(100, m)
        cuda_phi.reset_launch_counts()
        acc, upper = cuda_phi.aniso_micro_groups_cuda(
            x, x, [_meta()], (1.0,), (1.0, 0.5), _meta(3),
            _meta(2, m, m).double())
        assert tuple(acc.shape) == (3, 2 * m, 100)
        assert tuple(upper.shape) == (3,)
        assert calls[-1][0] == "svgd_fused_phi_aniso_terms_groups"
        assert calls[-1][1][10] == m
        assert cuda_phi.launch_counts[cuda_phi.ANISO_KERNEL] == 1
    cuda_phi.reset_launch_counts()


# ----------------------------------------------------------------------
# The sources
# ----------------------------------------------------------------------


def test_old_body_is_gone_and_the_micro_branch_dispatches_the_new():
    """No source holds terms_sym.cuh or names what only it used, and the
    groups' entry sends m = 1-8 and 11 through SVGD_DISPATCH_MICRO_2_11 to
    launch_aniso_micro, which launches the micro-tile groups' kernels:
    group 0 with the counts (the isotropic terms' kernel for n_iso >= 2,
    the single-term one's kT > 0 instance for one), then the anisotropic
    groups (its kT = 0 instance)."""
    assert not (CSRC_DIR / "terms_sym.cuh").exists()
    sources = {p.name: p.read_text() for p in CSRC_DIR.iterdir()
               if p.suffix in (".cu", ".cuh")}
    for name, text in sources.items():
        assert '#include "terms_sym.cuh"' not in text, name
        for word in ("SymTermsTile", "combine_terms", "SVGD_TERMS_SYM_KERNEL",
                     "fused_phi_aniso_terms_groups_kernel"):
            assert word not in text, (name, word)
    aniso = sources["fused_phi_aniso.cu"]
    assert '#include "micro_tile.cuh"' in aniso
    entry = aniso[aniso.index("int svgd_fused_phi_aniso_terms_groups("):]
    entry = entry[:entry.index("\n}\n")]
    assert re.search(r"return launch_aniso_micro<MM_, EX_>\(", entry)
    assert "SVGD_DISPATCH_MICRO_2_11(m, SVGD_LAUNCH_ANISO)" in entry
    launch = aniso[aniso.index("int launch_aniso_micro("):]
    launch = launch[:launch.index("\n}\n")]
    for kernel in ("fused_phi_aniso_terms_micro_iso_kernel<MM, kExact, kT>",
                   "fused_phi_aniso_terms_micro_groups_kernel<MM, kExact, kT>",
                   "fused_phi_aniso_terms_micro_groups_kernel<MM, kExact, 0>",
                   "group0(std::integral_constant<int, 3>{})",
                   "group0(std::integral_constant<int, kMaxT>{})"):
        assert kernel in launch
    for kernel in ("fused_phi_aniso_terms_micro_groups_kernel",
                   "fused_phi_aniso_terms_micro_iso_kernel"):
        body = aniso[aniso.index(f"    {kernel}("):]
        assert "micro_tri_body<MM, kExact, kT>(" in body[:body.index("\n}\n")]


# ----------------------------------------------------------------------
# The slice as a whole at d = 11
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


def _three_term_driver(pkg, x0, mean, cov, ps, impl, iters):
    """median RBF + RBF(P) + RBF(P_2) on the anisotropic MVN, AdaGrad at
    ANISO_ADAGRAD_LR, in either package, with the float64 target and
    slots."""
    n, dim = x0.shape
    model = pkg.MultivariateNormal(mean, cov)
    kernel = pkg.GaussianRBFKernel(x0.copy(), pkg.ScaleMethod.MEDIAN, model)
    for p in ps:
        kernel = kernel + pkg.GaussianRBFKernel(
            x0.copy(), pkg.ScaleMethod.CONSTANT, constant_scale=p)
    kw = {"device": "cpu"} if pkg is st else {}
    return pkg.SVGD(pkg.SVGDOptions(
        dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model,
        optimizer=pkg.AdaGrad(dim, n, ANISO_ADAGRAD_LR), phi_impl=impl,
        **kw)).initialize()


def test_three_term_driver_d11_matches_jax(monkeypatch):
    """The anisotropic MVN at d = 11 under three gradient accumulators (the
    term groups' path on the card), n = 300, float64: the port's
    fused_aniso_terms_cuda (its plain version on the CPU) for 5 steps
    against the JAX driver's fused_aniso_terms_pallas with its sweep in
    float64 plain functions."""
    mean, cov, x0, p = aniso_mvn_workload(300)
    x0 = x0.astype(np.float64)
    ps = (p, second_aniso_p(11))
    assert np.linalg.eigvalsh(ps[1]).min() > 0
    monkeypatch.setattr(pj, "phi_rbf_aniso_terms_fused_pallas",
                        _jax_f64_aniso_sweep)
    port = _three_term_driver(st, x0, mean, cov, ps,
                              "fused_aniso_terms_cuda", 5)
    ref = _three_term_driver(sv, x0, mean, cov, ps,
                             "fused_aniso_terms_pallas", 5)
    assert port._phi_impl == "fused_aniso_terms_cuda"
    np.testing.assert_allclose(port.run().numpy(), np.asarray(ref.run()),
                               rtol=1e-9, atol=1e-12)
    assert port.median_fallbacks == 0
