"""K14's wide term groups (m > 64) on the CPU: the plain version of what the
kernels leave in each group's slab (``ops/phi.aniso_groups_plain``) and the
epilogue the wrapper and these tests share (``ops/phi.aniso_groups_finish``).

* float64: the slabs through the epilogue against the function's plain
  version ``phi_rbf_aniso_terms_fused_counts`` (closed form a term), rtol
  1e-10 (atol 1e-13 of max |phi|); the counts, 2U - n of group 0's upper
  count (or, with no isotropic term, the count kernel's plain pass
  ``count_le_plain``), equal to its counts. At m = 65 and 123, n = 129 and
  300, and at the tile-128 edges n = 127, 128 and 257 at m = 65.
* float32: the same against the JAX package's
  ``phi_rbf_aniso_terms_fused_pallas`` in interpret mode, phi rtol 2e-4,
  atol 2e-5 (tests/test_torch_wide_p.py's tolerance), counts within
  COUNT_SLACK.
* Term sets: iso + 1, iso + 2 with a negative sign, 0 + 1, and two
  isotropic terms (one negative) + 1: each group convention (one
  isotropic term's single-RBF slab, the terms slab, no group 0).
* The wrapper's operands past 64 (``cuda_phi.aniso_group_operands``): the
  rows padded to ``wide_row_width(m)`` and z's columns past m exact
  zeros; the epilogue ignores an accumulator's padded columns.

About 40 s in one process.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgdcpp_tpu.ops import pallas_phi as pj
from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.ops import phi as pht
from svgdcpp_tpu_torch.ops.median import count_le_plain
from svgdcpp_tpu_torch.ops.sym_plan import wide_row_width

torch.set_num_threads(1)

#: (isotropic signs, anisotropic signs) of the cases.
TERMS = {"iso+1": ((1.0,), (0.8,)), "iso+2": ((1.0,), (1.0, -0.5)),
         "0+1": ((), (1.0,)), "2iso+1": ((1.0, -0.5), (0.8,))}

#: As tests/test_torch_wide_p.py: the most the Pallas kernel's counts (a
#: bf16x3-split Gram identity) may differ from the plain version's.
COUNT_SLACK = 4


def _case(n, m, terms, dtype):
    """(x, s, iso gammas, iso signs, Ps, aniso signs, thresholds, lowers)
    from a numpy seed: unit-variance points, gamma = 0.6/m, the second
    isotropic term at 2 gamma, P_t = gamma (0.5 I + A A^T / m)."""
    iso_s, an_s = TERMS[terms]
    rng = np.random.default_rng(900 + n + m)
    x = rng.normal(size=(n, m)).astype(np.float32)
    s = rng.normal(size=(n, m)).astype(np.float32)
    gamma = np.float32(0.6 / m)
    ps = []
    for _ in an_s:
        a = rng.normal(size=(m, m))
        ps.append((gamma * (0.5 * np.eye(m) + a @ a.T / m)).astype(
            np.float32))
    thr = np.linspace(0.5, 4.0 * m, 4).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dtype)

    iso_g = [t(g) for g in [gamma, 2.0 * gamma][:len(iso_s)]]
    lowers = cuda_phi.cholesky_factors([t(p) for p in ps], "cpu")
    return (t(x), t(s), iso_g, iso_s, [t(p) for p in ps], an_s, t(thr),
            lowers)


def _groups(x, s, iso_g, iso_s, an_s, thr, lowers):
    """phi and counts through the plain slabs and the shared epilogue, the
    counts as the wrapper forms them."""
    n = x.shape[0]
    acc, upper = pht.aniso_groups_plain(x, s, iso_g, iso_s, an_s, thr,
                                        lowers)
    assert tuple(acc.shape) == (1 + len(an_s), 2 * x.shape[1], n)
    assert (upper is None) == (not iso_s)
    if not iso_s:
        assert not acc[0].any()
    phi = pht.aniso_groups_finish(acc, s, iso_g[0] if iso_g else None,
                                  iso_s, an_s, lowers, n)
    counts = 2 * upper - n if iso_s else count_le_plain(x, x, thr)
    return phi, counts


def _held_f64(n, m, terms):
    x, s, iso_g, iso_s, ps, an_s, thr, lowers = _case(n, m, terms,
                                                      torch.float64)
    phi, counts = _groups(x, s, iso_g, iso_s, an_s, thr, lowers)
    want, want_counts = pht.phi_rbf_aniso_terms_fused_counts(
        x, s, iso_g, iso_s, ps, an_s, thr)
    scale = float(want.abs().max())
    np.testing.assert_allclose(phi.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-13 * scale)
    np.testing.assert_array_equal(counts.numpy(), want_counts.numpy())


@pytest.mark.parametrize("terms", sorted(TERMS))
@pytest.mark.parametrize("n", [129, 300])
@pytest.mark.parametrize("m", [65, 123])
def test_groups_plain_finish_equals_the_f64_plain_version(m, n, terms):
    _held_f64(n, m, terms)


@pytest.mark.parametrize("terms", sorted(TERMS))
@pytest.mark.parametrize("n", [127, 128, 257])
def test_groups_plain_finish_at_the_tile_edges(n, terms):
    """The self pair, entered in both directions by each group and taken
    out once, at the edges of the kernels' tiles of 128."""
    _held_f64(n, 65, terms)


@pytest.mark.parametrize("terms", sorted(TERMS))
@pytest.mark.parametrize("n", [129, 300])
@pytest.mark.parametrize("m", [65, 123])
def test_groups_plain_finish_vs_pallas_interpret(m, n, terms):
    x, s, iso_g, iso_s, ps, an_s, thr, lowers = _case(n, m, terms,
                                                      torch.float32)
    phi, counts = _groups(x, s, iso_g, iso_s, an_s, thr, lowers)
    want = pj.phi_rbf_aniso_terms_fused_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(s.numpy()),
        [jnp.float32(float(g)) for g in iso_g], iso_s,
        [jnp.asarray(p.numpy()) for p in ps], an_s, jnp.asarray(thr.numpy()),
        interpret=True)
    np.testing.assert_allclose(phi.numpy(), np.asarray(want[0]), rtol=2e-4,
                               atol=2e-5)
    cnt = np.asarray(want[1]).astype(np.int64)
    assert np.abs(counts.numpy() - cnt).max() <= COUNT_SLACK


@pytest.mark.parametrize("m", [65, 123, 128])
def test_group_operands_pad_z_with_exact_zeros(m):
    """The wrapper's rows past 64: x and the scores padded with zero
    columns to wide_row_width(m); z_t = x L_t in float64 from L_t padded
    with zero rows and columns, rounded once, so its columns past m are
    exactly 0 and the first m are (x L_t) rounded."""
    x, s, _, _, _, _, _, lowers = _case(100, m, "iso+2", torch.float32)
    x = x - x.mean(dim=0)
    xp, sp, z, width = cuda_phi.aniso_group_operands(x, s, lowers)
    assert width == wide_row_width(m) and width % 4 == 0 and width >= m
    assert tuple(xp.shape) == tuple(sp.shape) == (100, width)
    assert tuple(z.shape) == (2, 100, width) and z.dtype == torch.float32
    assert torch.equal(xp[:, :m], x) and torch.equal(sp[:, :m], s)
    assert not xp[:, m:].any() and not sp[:, m:].any()
    assert not z[:, :, m:].any()
    want = (x.double() @ lowers).float()
    assert torch.equal(z[:, :, :m], want)


def test_finish_ignores_the_padded_columns():
    """The epilogue reads columns [0, m) and [width, width + m) of each
    slab: the plain slabs at width m and the same slabs spread to a
    padded width with junk between them give the same phi."""
    m, width = 65, wide_row_width(65)
    x, s, iso_g, iso_s, _, an_s, thr, lowers = _case(129, m, "iso+2",
                                                     torch.float64)
    acc, _ = pht.aniso_groups_plain(x, s, iso_g, iso_s, an_s, thr, lowers)
    padded = torch.full((acc.shape[0], 2 * width, acc.shape[2]), 7.5,
                        dtype=acc.dtype)
    padded[:, :m] = acc[:, :m]
    padded[:, width:width + m] = acc[:, m:]
    args = (s, iso_g[0], iso_s, an_s, lowers, x.shape[0])
    assert torch.equal(pht.aniso_groups_finish(padded, *args),
                       pht.aniso_groups_finish(acc, *args))
