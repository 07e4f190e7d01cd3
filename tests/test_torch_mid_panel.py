"""The panel sweeps at the mid widths (K3, K5 and K12/K13 at m = 9, 10 and
12-64), and K3/K5 at m = 11, on the CPU.

* The width rule: ``sym_plan.panel_tile128(m)`` is ``tri_wide(m)`` at
  m = 1-130 in float32 and True under bf16; csrc/sweep_common.cuh defines
  ``panel_wide`` as ``tri_wide``, csrc/fused_phi_panel.cu exports it as
  ``svgd_panel_tile128`` and dispatches its window entries through
  ``SVGD_DISPATCH_MICRO_2_11`` (instances at m = 1-8 and 11 only).
  chip_smoke.py phase 50c holds the built library's export to sym_plan on
  the card.
* The plan: at the mid widths ``card_panel_plan(n, blocks,
  panel_tile128(m))`` is the plan of 128 multiples that
  tests/test_torch_wide_tri_plan.py's ``wide_panel_walk`` covers (the
  walk does not depend on m); at the micro widths the plan of 64
  multiples.
* The wrappers on a stand-in library (meta tensors stand in for the card):
  at m = 9, 10, 12, 16, 17, 32, 33, 54 and 64, K3, K12/K13 and K5 (every
  rank of worlds 1-4) call their wide entries (``..._wide``, on
  csrc/wide_tri_sm90.cuh's body) with the padded width
  ``wide_row_width(m)`` and the 128-tile plan, allocate no windows and
  count one launch; at m = 2, 5, 8 and 11 (K3 and K5 with one RBF, K12/K13
  with two and three terms) they call the window entries with m itself,
  the plan of 64 multiples and one window a panel.
* The plain panel schedules, through the CUDA wrappers on CPU tensors
  with sym="panel", against the JAX package's Pallas panel kernels in
  interpret mode at m = 9, 33 and 54, ragged n, off origin, float32:
  K3 (``_phi_rbf_fused_pallas_sympanel_impl``), K12
  (``_phi_rbf_terms_fused_pallas_sympanel_direct_impl``) and K13
  (``_phi_rbf_terms_fused_pallas_sympanel_impl``), with
  tests/test_torch_panel.py's tolerances (phi within 1e-4 of max |phi|,
  counts within n of the Pallas kernel's, whose Gram sq is bf16x3-split)
  and counts within COUNT_SLACK of the float64 plain version's (the
  float32 plain sweep builds sq by the Gram identity past m = 4).
* K5's plain chunks at m = 54, on the kernel's plan of 128 multiples,
  summed over worlds 1-5 against the whole panel sweep in float64 (rtol
  1e-12, counts equal): every pair lies in exactly one rank's chunk.
* The drivers with fused_sym="panel" at m = 54 (one RBF, 'fused_cuda')
  and m = 55 (two terms, 'fused_terms_cuda') for 3 AdaGrad steps in
  float32 against the JAX driver's 'fused_pallas' / 'fused_terms_pallas'
  panel routes in interpret mode, rtol 2e-3, atol 2e-4
  (tests/test_torch_panel.py's bound for that pair).

About 25 s in one process.
"""

import inspect
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
from svgdcpp_tpu_torch.ops import cuda_phi, sym_plan
from svgdcpp_tpu_torch.ops import phi as pht
from svgdcpp_tpu_torch.utils.cuda_build import CSRC_DIR

torch.set_num_threads(1)

#: The mid widths the stand-in library takes: both sides of the wide
#: body's 32-column slices, the padded widths 9 and 10 (to 12), 54
#: (Covertype's, to 56) and the last, 64.
MID = (9, 10, 12, 16, 17, 32, 33, 54, 64)

#: The widths whose panels keep the micro-tile body and its windows.
MICRO = (2, 5, 8, 11)

#: As tests/test_torch_wide.py: one pair on the other side of a threshold
#: in both orders, twice over.
COUNT_SLACK = 4


def _inputs(n, m, offset, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, m)) + offset).astype(dtype)
    s = rng.normal(size=(n, m)).astype(dtype)
    return x, s


def _thresholds(m, dtype=np.float32):
    return np.linspace(0.5, 4.0 * m, 4).astype(dtype)


def _f64(*arrays):
    return [torch.from_numpy(a).double() for a in arrays]


# ----------------------------------------------------------------------
# The width rule and the plan
# ----------------------------------------------------------------------


def test_panel_width_rule_is_the_triangles():
    """The float32 panels take the 128-tile plan and the wide entries
    wherever the float32 triangles run the wide body; the bf16 instance
    at every m."""
    for m in range(1, 131):
        assert sym_plan.panel_tile128(m) is sym_plan.tri_wide(m)
        assert sym_plan.panel_tile128(m) is (m > 8 and m != 11)
        assert sym_plan.panel_tile128(m, bf16=True) is True


def test_panel_width_rule_matches_the_c_side():
    """csrc/sweep_common.cuh's panel_wide is tri_wide; the panel source
    exports it, refuses the other side's widths at each entry and keeps
    no one-row-a-thread body and no runtime instance past the micro
    widths."""
    common = (CSRC_DIR / "sweep_common.cuh").read_text()
    assert "inline bool panel_wide(int m) { return tri_wide(m); }" in common
    assert "SVGD_DISPATCH_M_2_11" not in common
    panel = (CSRC_DIR / "fused_phi_panel.cu").read_text()
    assert ("int svgd_panel_tile128(int m) { return panel_wide(m) ? 1 : 0; }"
            in panel)
    assert "sympanel_body" not in panel and "SVGD_DISPATCH_M_2_11" not in panel
    # the three window entries dispatch over the micro widths only, and
    # refuse panel_wide; the three wide entries refuse the rest
    assert len(re.findall(r"SVGD_DISPATCH_MICRO_2_11\(m, ", panel)) == 3
    assert panel.count("m < 1 || panel_wide(m)") == 3
    assert panel.count("!panel_wide(m)") == 3
    # the wrapper module binds the export's signature
    assert '"svgd_panel_tile128": [i32],' in inspect.getsource(cuda_phi)


@pytest.mark.parametrize("m", MID + MICRO)
def test_panel_plan_follows_the_width_rule(m):
    """At the mid widths the panels' plan is the plan of 128 multiples
    (the wide panel walk's, the bf16 panels'); at the micro widths the
    plan of CARD_PANEL_ALIGN multiples."""
    for n in (1, 127, 129, 2047, 10000, 10007, 131072):
        for blocks in (None, 1, 3, 8):
            plan = sym_plan.card_panel_plan(n, blocks,
                                            sym_plan.panel_tile128(m))
            nb, w, n_pad = plan
            assert n_pad == nb * w >= n
            if m in MID:
                assert plan == sym_plan.card_panel_plan(n, blocks,
                                                        tile128=True)
                assert w % sym_plan.WIDE_TILE == 0
            else:
                assert plan == sym_plan.card_panel_plan(n, blocks)
                assert w % sym_plan.CARD_PANEL_ALIGN == 0


# ----------------------------------------------------------------------
# The wrappers on a stand-in library
# ----------------------------------------------------------------------


def _stand_in(monkeypatch, calls, shapes):
    """A library that records each launch (tests/test_torch_wide_panel.py's
    stand-in), the card's context managers and memory stood in, and the
    shapes of the buffers the wrappers allocate."""

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
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(total_memory=2**36))
    real = torch.zeros

    def spy(*size, **kw):
        one = size[0] if len(size) == 1 else size
        shapes.append(tuple(one) if isinstance(one, (tuple, list))
                      else (one,))
        return real(*size, **kw)
    monkeypatch.setattr(torch, "zeros", spy)


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _windows(shapes):
    """The window buffers (num_p, 2, 2m, w) among the allocations."""
    return [sh for sh in shapes if len(sh) == 4 and sh[1] == 2]


@pytest.mark.parametrize("m", MID + MICRO)
def test_panel_wrappers_launch_once_on_the_width_rule(monkeypatch, m):
    """K3 and K12/K13 (sym="panel", forced and default super-block
    counts; two terms and three) and K5 (every rank of worlds 1-4): one
    launch each. At the mid widths their wide entries, with the padded
    width wide_row_width(m), the plan of 128 multiples and a zeroed
    (2 width, n) accumulator, no window; at the micro widths their window
    entries, with m, the plan of 64 multiples and one (2, 2m, w) window a
    panel."""
    calls, shapes = [], []
    _stand_in(monkeypatch, calls, shapes)
    wide = m in MID
    n, g, thr = 1000, _meta(), _meta(3)
    x = _meta(n, m)
    width = sym_plan.wide_row_width(m) if wide else m
    assert width % 4 == 0 or not wide
    suffix = "_wide" if wide else ""
    for blocks in (None, 3):
        nb, w, _ = sym_plan.card_panel_plan(n, blocks, tile128=wide)
        num_p = nb * (nb + 1) // 2
        for kernel, entry, call in (
            (cuda_phi.SYMPANEL_KERNEL,
             "svgd_fused_phi_counts_sympanel" + suffix,
             lambda: cuda_phi.phi_rbf_fused_cuda(
                 x, x, g, thr, sym="panel", panel_blocks=blocks)),
            (cuda_phi.TERMS_SYMPANEL_KERNEL,
             "svgd_fused_phi_terms_sympanel" + suffix,
             lambda: cuda_phi.phi_rbf_terms_fused_cuda(
                 x, x, [g, g], (1.0, -0.5), thr, sym="panel",
                 panel_blocks=blocks)),
            (cuda_phi.TERMS_SYMPANEL_KERNEL,
             "svgd_fused_phi_terms_sympanel" + suffix,
             lambda: cuda_phi.phi_rbf_terms_fused_cuda(
                 x, x, [g, g, g], (1.0, -0.5, 0.3), thr, sym="panel",
                 panel_blocks=blocks)),
        ):
            del calls[:], shapes[:]
            cuda_phi.reset_launch_counts()
            phi, counts = call()
            assert [c[0] for c in calls] == [entry]
            args = calls[0][1]
            # (n, width, T, nb, w) right after the pointers (and the signs)
            at = 4 if "counts" in entry else 6
            assert args[at:at + 5] == (n, width, 3, nb, w)
            if wide:
                assert (2 * width, n) in shapes
                assert not _windows(shapes)
            else:
                assert _windows(shapes) == [(num_p, 2, 2 * m, w)]
            assert tuple(phi.shape) == (n, m) and tuple(counts.shape) == (3,)
            assert cuda_phi.launch_counts[kernel] == 1
            assert sum(cuda_phi.launch_counts.values()) == 1
    nb, w, _ = sym_plan.card_panel_plan(n, tile128=wide)
    for world in (1, 2, 3, 4):
        for rank in range(world):
            p0, count = sym_plan.panel_chunk(nb, world, rank)
            del calls[:], shapes[:]
            cuda_phi.reset_launch_counts()
            acc, upper = cuda_phi.phi_rbf_sympanel_chunk_cuda(
                x, x, g, thr, world, rank)
            assert [c[0] for c in calls] == [
                "svgd_fused_phi_counts_sympanel_chunk" + suffix]
            assert calls[0][1][4:11] == (n, width, 3, nb, w, p0, count)
            if wide:
                assert (2 * width, n) in shapes
                assert not _windows(shapes)
            else:
                assert _windows(shapes) == [(count, 2, 2 * m, w)]
            assert tuple(acc.shape) == (2 * m, n)
            assert cuda_phi.launch_counts[
                cuda_phi.SYMPANEL_CHUNK_KERNEL] == (1 if count else 0)
    cuda_phi.reset_launch_counts()


# ----------------------------------------------------------------------
# The plain panel schedules against the Pallas panel kernels
# ----------------------------------------------------------------------


def _check(got, want, exact, n):
    """tests/test_torch_panel.py's tolerances (phi within 1e-4 of max
    |phi| of the Pallas kernel's, counts within n of its), and counts
    within COUNT_SLACK of the float64 plain version's."""
    phi_t, cnt_t = got
    phi_j = np.asarray(want[0])
    rel = np.abs(phi_t.numpy() - phi_j).max() / np.abs(phi_j).max()
    assert rel <= 1e-4, rel
    assert np.abs(cnt_t.numpy() - exact.numpy()).max() <= COUNT_SLACK
    cnt_j = np.asarray(want[1]).astype(np.int64)
    assert np.abs(cnt_t.numpy() - cnt_j).max() <= n


@pytest.mark.parametrize("n,m", [(301, 9), (283, 33), (317, 54)])
def test_k3_mid_vs_sympanel_interpret(n, m):
    x, s = _inputs(n, m, 2.0, 900 + m)
    gamma = np.float32(0.6 / m)
    thr = _thresholds(m)
    want = pj._phi_rbf_fused_pallas_sympanel_impl(
        jnp.asarray(x), jnp.asarray(s), jnp.float32(gamma), jnp.asarray(thr),
        4, 32, 64, True, panel_blocks=4,
    )
    cuda_phi.reset_launch_counts()
    got = cuda_phi.phi_rbf_fused_cuda(
        *map(torch.from_numpy, (x, s)), torch.tensor(gamma),
        torch.from_numpy(thr), sym="panel", panel_blocks=3,
    )
    assert not any(cuda_phi.launch_counts.values())  # the plain version
    exact = pht.phi_rbf_fused_counts(
        *_f64(x, s), torch.tensor(float(gamma), dtype=torch.float64),
        *_f64(thr))[1]
    _check(got, want, exact, n)


@pytest.mark.parametrize("impl,n,m,signs", [
    ("direct", 301, 9, (1.0, 1.0)),
    ("legacy", 283, 33, (1.0, -0.5, 0.3)),
    ("direct", 317, 54, (1.0, -0.5)),
    ("legacy", 299, 54, (1.0, 1.0)),
])
def test_k12_k13_mid_vs_interpret(impl, n, m, signs):
    x, s = _inputs(n, m, -1.5, 910 + m + len(signs))
    gs = [np.float32(g) for g in (0.6 / m, 0.2 / m, 1.5 / m)[:len(signs)]]
    thr = _thresholds(m)
    args = (jnp.asarray(x), jnp.asarray(s), tuple(jnp.float32(g) for g in gs),
            signs, jnp.asarray(thr), 4)
    if impl == "direct":
        want = pj._phi_rbf_terms_fused_pallas_sympanel_direct_impl(
            *args, 32, 64, True, panel_blocks=4)
    else:
        want = pj._phi_rbf_terms_fused_pallas_sympanel_impl(
            *args, 32, 64, True, panel_blocks=5)
    got = cuda_phi.phi_rbf_terms_fused_cuda(
        *map(torch.from_numpy, (x, s)), [torch.tensor(g) for g in gs], signs,
        torch.from_numpy(thr), sym="panel", panel_blocks=3,
    )
    exact = pht.phi_rbf_terms_fused_counts(
        *_f64(x, s), [float(g) for g in gs], signs, *_f64(thr))[1]
    _check(got, want, exact, n)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 5])
def test_k5_mid_chunks_sum_to_the_panel_sweep(world):
    """K5's plain chunks at m = 54 on the kernel's plan (128 multiples;
    panel_blocks=4 gives 4 super-blocks of 128 at n = 457, the last one
    ragged) summed over the ranks: the whole panel sweep, phi to rtol
    1e-12 and the counts equal, so every pair lies in one rank's chunk."""
    m, n, gamma = 54, 457, 0.5 / 54
    x, s = _f64(*_inputs(n, m, 1.0, 930 + world, np.float64))
    thr = torch.from_numpy(_thresholds(m, np.float64))
    assert sym_plan.card_panel_plan(n, 4, sym_plan.panel_tile128(m)) == (
        4, 128, 512)
    acc = upper = 0
    for rank in range(world):
        a, u = cuda_phi.phi_rbf_sympanel_chunk_cuda(x, s, gamma, thr, world,
                                                    rank, panel_blocks=4)
        acc, upper = acc + a, upper + u
    phi = pht.phi_rbf_fused_sym_finish(acc, s, gamma, n)
    want_phi, want_cnt = pht.phi_rbf_sympanel_fused_counts(
        x, s, gamma, thr, panel_blocks=4)
    np.testing.assert_allclose(phi.numpy(), want_phi.numpy(), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_array_equal((2 * upper - n).numpy(), want_cnt.numpy())
    exact_phi, exact_cnt = pht.phi_rbf_fused_counts(x, s, gamma, thr)
    np.testing.assert_allclose(phi.numpy(), exact_phi.numpy(), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_array_equal(want_cnt.numpy(), exact_cnt.numpy())


# ----------------------------------------------------------------------
# The drivers
# ----------------------------------------------------------------------


def _mvn_driver(pkg, x0, impl, iters, composed=False):
    n, dim = x0.shape
    model = pkg.MultivariateNormal(np.zeros(dim, x0.dtype),
                                   np.eye(dim, dtype=x0.dtype))
    kernel = pkg.GaussianRBFKernel(x0.copy(), pkg.ScaleMethod.MEDIAN, model)
    if composed:
        kernel = kernel + pkg.GaussianRBFKernel(
            x0.copy(), pkg.ScaleMethod.CONSTANT,
            constant_scale=(0.2 / dim) * np.eye(dim, dtype=x0.dtype))
    extra = {"device": "cpu"} if pkg is st else {}
    return pkg.SVGD(pkg.SVGDOptions(
        dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model, optimizer=pkg.AdaGrad(dim, n, 0.1),
        phi_impl=impl, fused_sym="panel", **extra,
    )).initialize()


@pytest.mark.parametrize("m,composed", [(54, False), (55, True)])
def test_mid_panel_drivers_vs_jax_interpret(m, composed):
    n, steps = 300, 3
    x0 = (np.random.default_rng(940 + m).normal(size=(n, m)) * 0.5).astype(
        np.float32)
    port_impl = "fused_terms_cuda" if composed else "fused_cuda"
    jax_impl = "fused_terms_pallas" if composed else "fused_pallas"
    s_t = _mvn_driver(st, x0, port_impl, steps, composed)
    assert s_t._phi_impl == port_impl and s_t.fused_sym_form == "panel"
    got = s_t.run().numpy()
    want = np.asarray(_mvn_driver(sv, x0, jax_impl, steps, composed).run())
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    assert s_t.median_fallbacks == 0
