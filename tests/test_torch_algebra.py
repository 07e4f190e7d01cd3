"""svgdcpp_tpu_torch.kernels.algebra against svgdcpp_tpu.kernels.algebra.

* flatten_rbf_terms on the trees of tests/test_algebra.py (sum, difference,
  product, distribution, division, multi-term divisor, custom leaf, term
  blow-up past MAX_RBF_TERMS): the same term lists (or None) from the same
  compositions built in each package.
* The per-composition predicates (fused_terms_eligible,
  fused_terms_statically_positive, term_psd_flags, split_iso_aniso_terms,
  fused_aniso_terms_supported, matrix_is_psd) equal the JAX ones, on
  compositions that include tests/test_pallas.py:1418-1503's, and
  refill_median_slots gives the same parameters and term gammas (float64,
  exactly: the same few scalar operations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.kernels import algebra as alg_j
from svgdcpp_tpu_torch.kernels import algebra as alg_t

# The suite runs several xdist workers on one CPU: torch's default of an
# OpenMP thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

M = 3
X0 = np.random.default_rng(0).normal(size=(24, M))


def spd(seed, scale=1.0):
    a = np.random.default_rng(seed).normal(size=(M, M))
    return scale * (a @ a.T / M + np.eye(M))


def const(pkg, p):
    return pkg.GaussianRBFKernel(
        X0, pkg.ScaleMethod.CONSTANT, constant_scale=np.asarray(p)
    )


def median(pkg):
    return pkg.GaussianRBFKernel(X0, pkg.ScaleMethod.MEDIAN)


def custom(pkg):
    lib = jnp if pkg is sv else torch
    return pkg.Kernel(
        dimension=M,
        kernel_fn=lambda x, p, loc: lib.exp(-lib.sum((x - loc) ** 2)),
    )


def consts(pkg, k):
    return [const(pkg, spd(10 + i)) for i in range(k)]


TREES = {
    "sum": lambda pkg: (lambda a, b: a + b)(*consts(pkg, 2)),
    "difference": lambda pkg: (lambda a, b: a - b)(*consts(pkg, 2)),
    "product": lambda pkg: (lambda a, b: a * b)(*consts(pkg, 2)),
    "distribute": lambda pkg: (lambda a, b, c: (a + b) * c)(*consts(pkg, 3)),
    "division": lambda pkg: (lambda a, b: a / b)(*consts(pkg, 2)),
    "multi_term_divisor":
        lambda pkg: (lambda a, b, c, d: (a + b) / (c + d))(*consts(pkg, 4)),
    "custom_leaf": lambda pkg: consts(pkg, 1)[0] + custom(pkg),
    "custom_alone": custom,
    # (a+b)^5 has 32 terms > MAX_RBF_TERMS
    "blowup": lambda pkg: (lambda s: s * s * s * s * s)(
        (lambda a, b: a + b)(*consts(pkg, 2))
    ),
    "median_plus_const": lambda pkg: median(pkg) + const(pkg, 0.1 * np.eye(M)),
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_flatten_rbf_terms_matches_jax(tree):
    want = alg_j.flatten_rbf_terms(TREES[tree](sv))
    got = alg_t.flatten_rbf_terms(TREES[tree](st))
    assert got == want
    if tree in ("multi_term_divisor", "custom_leaf", "custom_alone", "blowup"):
        assert got is None
    assert alg_t.MAX_RBF_TERMS == alg_j.MAX_RBF_TERMS == 16


def hessian(pkg):
    model = pkg.MultivariateNormal(np.zeros(M), np.eye(M))
    return pkg.GaussianRBFKernel(X0, pkg.ScaleMethod.HESSIAN, model)


COMPOSITIONS = {
    # the hierarchical-BLR kernel: median RBF + 0.1 I
    "median_plus_iso": lambda pkg: median(pkg) + const(pkg, 0.1 * np.eye(M)),
    "median_times_iso": lambda pkg: median(pkg) * const(pkg, 0.4 * np.eye(M)),
    "median_minus_iso": lambda pkg: median(pkg) - const(pkg, 2.0 * np.eye(M)),
    "median_over_iso": lambda pkg: median(pkg) / const(pkg, 0.05 * np.eye(M)),
    "median_plus_aniso": lambda pkg: median(pkg) + const(pkg, spd(3, 0.2)),
    "median_times_indefinite": lambda pkg: median(pkg) * const(
        pkg, np.diag([0.3, -0.1, 0.2])
    ),
    "negative_iso": lambda pkg: median(pkg) + const(pkg, -0.2 * np.eye(M)),
    "hessian_plus_iso": lambda pkg: hessian(pkg) + const(pkg, 0.1 * np.eye(M)),
    "two_medians": lambda pkg: median(pkg) + median(pkg),
    "consts_only": lambda pkg: (lambda a, b: a + b)(*consts(pkg, 2)),
    # tests/test_pallas.py:1418-1503: two isotropic terms and one
    # anisotropic; a PSD singular constant part under a product (PD for
    # every median gamma); a singular constant-only term (not PD)
    "median_plus_aniso_plus_iso": lambda pkg: median(pkg) + const(
        pkg, spd(4, 0.2)
    ) + const(pkg, 0.3 * np.eye(M)),
    "median_times_psd_singular": lambda pkg: median(pkg) * const(
        pkg, np.diag([1.0, 0.0, 0.3])
    ),
    "median_plus_singular": lambda pkg: median(pkg) + const(
        pkg, np.diag([0.5, 0.0, 0.2])
    ),
}


def _predicates(alg, kernel):
    terms = alg.flatten_rbf_terms(kernel)
    slots = kernel.adaptive_slots()
    params = kernel.parameters
    out = {
        "eligible": alg.fused_terms_eligible(terms, slots, params),
        "psd_flags": alg.term_psd_flags(terms, slots, params),
        "split": alg.split_iso_aniso_terms(terms, slots, params),
        "aniso_supported": alg.fused_aniso_terms_supported(terms, slots, params),
        "psd_slots": [alg.matrix_is_psd(p) for p in params],
    }
    if out["eligible"]:
        out["positive"] = alg.fused_terms_statically_positive(
            terms, slots, params
        )
    return out


@pytest.mark.parametrize("comp", sorted(COMPOSITIONS))
def test_predicates_match_jax(comp):
    assert _predicates(alg_t, COMPOSITIONS[comp](st)) == _predicates(
        alg_j, COMPOSITIONS[comp](sv)
    )


@pytest.mark.parametrize("comp", ["median_plus_iso", "median_times_iso",
                                  "median_over_iso", "two_medians"])
def test_refill_median_slots_matches_jax(comp):
    kj = COMPOSITIONS[comp](sv)
    kt = COMPOSITIONS[comp](st)
    terms = alg_j.flatten_rbf_terms(kj)
    plists = [p for _, p in terms]
    slots = [idx for idx, _ in kj.adaptive_slots()]
    gamma = 0.731
    pj, gj = alg_j.refill_median_slots(
        tuple(jnp.asarray(p) for p in kj.parameters), slots,
        jnp.asarray(gamma), M, jnp.float64, plists,
    )
    pt, gt = alg_t.refill_median_slots(
        tuple(torch.as_tensor(np.asarray(p)) for p in kt.parameters), slots,
        torch.tensor(gamma, dtype=torch.float64), M, torch.float64, plists,
    )
    assert len(pt) == len(pj) and len(gt) == len(gj)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(gt, gj):
        assert torch.is_tensor(a)
        assert float(a) == float(b)
