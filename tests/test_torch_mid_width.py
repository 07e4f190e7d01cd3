"""The float32 triangles at the mid widths, on the CPU.

At m = 9, 10 and 12-64 K2/K4 and K8-K11 run the float32 wide triangle
body (csrc/wide_tri_sm90.cuh: tiles of 128, rows padded to a multiple of
4); the micro-tile body keeps m = 1-8 and 11. What the CPU can hold:

* The plain chunk sweeps on the wide tile list of 128 particles a side
  (the chunk wrappers on CPU tensors) at m = 9, 13, 33 and 55, summed over
  worlds 1-3 and finished as the engine finishes them: in float64 against
  the JAX package's float64 plain sweep within 1e-10 of max |phi|, counts
  equal; and against the JAX sharded kernels (K4, K10 and K11) summed over
  their chunks in interpret mode. Those compute in float32 whatever their
  inputs (3.6e-6 of max |phi| from float64 at m = 9) and build sq past
  m = 4 by a bf16x3-split Gram identity, so they are held at
  JAX_GRAM_PHI_REL and JAX_GRAM_COUNT_SLACK, as in
  tests/test_torch_sharded.py.
* ``sym_plan``'s triangle dispatch, tile and row width at m = 1-64
  against the table this slice settles (TRIANGLE_TABLE).
* ``sym_plan.wide_sym_walk`` at the moved widths: the blocks of one
  launch, over the whole triangle and over the chunks of worlds 1-3,
  visit every tile pair once and so every unordered pair once.
* The wrappers on a stand-in library at the moved widths: the triangles
  hand the library the padded width and allocate the (2 x width, n)
  accumulator; the square sweeps and K14's groups keep m itself up to 64.
* The card's form rule on the moved widths (``card_resolve_sym``,
  ``resolve_sharded_sym``): the square sweep below SYM_MIN_N, the triangle
  from there, never the panel under None, where the JAX rule takes the
  panel at (10000, 54) and the square form at (10000, 55) with two terms.
  Under ``dot_dtype='bfloat16'`` (K2's and K3's bf16 instances, which did
  not move) the JAX rule up to m = 64, and the driver passes its
  ``fused_dot_dtype`` to the rule.
* The slice as a whole: the flat BLR at Covertype's d = 54 and the
  hierarchical one at d = 54 (m = 55), 3 Adam steps at N = 300 in float64
  against the JAX drivers, rtol 1e-8.
"""

from contextlib import nullcontext
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from svgdcpp_tpu.ops import pallas_phi as pj
from svgdcpp_tpu.ops import phi as phj
from svgdcpp_tpu_torch.ops import cuda_phi, sym_plan
from svgdcpp_tpu_torch.ops import phi as pht
from svgdcpp_tpu_torch.parallel.sharded import resolve_sharded_sym
from svgdcpp_tpu_torch.utils.workloads import blr_workload, build_blr_svgd

torch.set_num_threads(1)

#: The widths whose float32 triangles moved onto the wide body.
MOVED = (9, 10, *range(12, 65))

#: The JAX sharded kernels' limits past DIFF_FORM_MAX_M in interpret mode
#: (tests/test_torch_sharded.py): their bf16x3 Gram sq keeps a residue of
#: about 2^-16, so phi stands up to about 1e-4 of max |phi| from float64
#: and a count may move by one pair across a threshold, twice over.
JAX_GRAM_PHI_REL = 2e-4
JAX_GRAM_COUNT_SLACK = 4


def _inputs(n, m, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, m)) * 2 + 1.0).astype(np.float32)
    s = rng.normal(size=(n, m)).astype(np.float32)
    thr = np.asarray([1.0, 0.5 * m, 2.0 * m, 8.0 * m], np.float32)
    return x, s, thr


def _jax_chunks(fn, d, per, pi, pj_):
    """The JAX sharded kernel's outputs summed over its d chunks."""
    outs = None
    for c in range(d):
        res = fn(jnp.asarray(pi[c * per:(c + 1) * per]),
                 jnp.asarray(pj_[c * per:(c + 1) * per]))
        outs = res if outs is None else tuple(a + b for a, b in zip(outs, res))
    return outs


def _port_chunks(fn, world):
    acc = upper = None
    for rank in range(world):
        a, u = fn(world, rank)
        acc = a if acc is None else acc + a
        upper = u if upper is None else upper + u
    return acc, upper


@pytest.mark.parametrize("m", [9, 13, 33, 55])
@pytest.mark.parametrize("kernel", ["K4", "K10", "K11"])
def test_mid_chunks_vs_jax(kernel, m):
    """The plain chunks at tiles of 128 summed over worlds 1-3: in float64
    within 1e-10 of max |phi| of the JAX float64 plain sweep, counts
    equal; in float32 beside the JAX sharded kernel in interpret mode."""
    n, d = 300, 3
    assert sym_plan.sym_tile(m, kernel != "K4") == sym_plan.WIDE_TILE
    x, s, thr = _inputs(n, m, 900 + m)
    pi, pj_, n_pad, per = pj.sym_pairs_plan(n, d, 64, 128)
    kw = dict(n_pad=n_pad, num_thresholds=thr.shape[0], tile_i=64,
              tile_j=128, interpret=True)
    xj, sj, thj = jnp.asarray(x), jnp.asarray(s), jnp.asarray(thr)
    center = jnp.mean(xj, axis=0)
    x64, s64, thr64 = (torch.from_numpy(a).double() for a in (x, s, thr))
    x32, s32, thr32 = (torch.from_numpy(a) for a in (x, s, thr))
    if kernel == "K4":
        g = np.float32(0.6 / m)
        acc_j, lanes = _jax_chunks(
            lambda a, b: pj.phi_rbf_fused_pallas_sym_sharded(
                xj, sj, g, thj, a, b, **kw), d, per, pi, pj_)
        jax_phi = pj.phi_rbf_fused_sym_finish(acc_j[:, :n], sj, xj, center,
                                              g, n)
        ref = phj.phi_rbf_fused_counts(jnp.asarray(x, jnp.float64),
                                       jnp.asarray(s, jnp.float64),
                                       jnp.float64(g),
                                       jnp.asarray(thr, jnp.float64))

        def port(xt, st_, tt, gdt):
            g_t = torch.tensor(float(g), dtype=gdt)
            return (lambda w, r: cuda_phi.phi_rbf_fused_sym_chunk_cuda(
                        xt, st_, g_t, tt, w, r),
                    lambda acc: pht.phi_rbf_fused_sym_finish(acc, st_, g_t,
                                                             n))
    else:
        gs = (np.float32(0.6 / m), np.float32(0.15 / m))
        signs = (1.0, -0.5) if kernel == "K10" else (1.0, 1.0)
        jg = [jnp.float32(gm) for gm in gs]
        if kernel == "K11":
            acck, accw, lanes = _jax_chunks(
                lambda a, b: pj.phi_rbf_terms_fused_pallas_sym_sharded(
                    xj, sj, jg, signs, thj, a, b, **kw), d, per, pi, pj_)
            jax_phi = pj.phi_rbf_terms_fused_sym_finish(
                acck[:, :n], accw[:, :n], sj, xj, center, jnp.stack(jg),
                signs, n)
        else:
            acc_j, lanes = _jax_chunks(
                lambda a, b: pj.phi_rbf_terms_fused_pallas_sym_sharded_direct(
                    xj, sj, jg, signs, thj, a, b, **kw), d, per, pi, pj_)
            jax_phi = pj.phi_rbf_terms_fused_sym_direct_finish(
                acc_j[:, :n], sj, xj, center, jnp.stack(jg), signs, n)
        ref = phj.phi_rbf_terms_fused_counts(
            jnp.asarray(x, jnp.float64), jnp.asarray(s, jnp.float64),
            [jnp.float64(gm) for gm in gs], signs,
            jnp.asarray(thr, jnp.float64))

        def port(xt, st_, tt, gdt):
            g_t = [torch.tensor(float(gm), dtype=gdt) for gm in gs]
            return (lambda w, r: cuda_phi.phi_rbf_terms_fused_sym_chunk_cuda(
                        xt, st_, g_t, signs, tt, w, r),
                    lambda acc: pht.phi_rbf_terms_fused_sym_finish(
                        acc, st_, signs, n))
    ref_phi, ref_cnt = np.asarray(ref[0]), np.asarray(ref[1]).astype(np.int64)
    scale = np.abs(ref_phi).max()
    jax_phi = np.asarray(jax_phi)
    jax_cnt = np.asarray(2.0 * jnp.sum(lanes, axis=1) - n).astype(np.int64)
    cuda_phi.reset_launch_counts()
    for world in (1, 2, 3):
        chunk, finish = port(x64, s64, thr64, torch.float64)
        acc, upper = _port_chunks(chunk, world)
        phi = finish(acc).numpy()
        assert np.abs(phi - ref_phi).max() / scale < 1e-10
        np.testing.assert_array_equal((2 * upper - n).numpy(), ref_cnt)
        chunk, finish = port(x32, s32, thr32, torch.float32)
        acc, upper = _port_chunks(chunk, world)
        phi32 = finish(acc).numpy()
        assert np.abs(phi32 - jax_phi).max() / scale < JAX_GRAM_PHI_REL
        assert np.abs((2 * upper - n).numpy() - jax_cnt).max() \
            <= JAX_GRAM_COUNT_SLACK
    assert np.abs(jax_phi - ref_phi).max() / scale < JAX_GRAM_PHI_REL
    assert not any(cuda_phi.launch_counts.values())


# ----------------------------------------------------------------------
# The plan's mirrors
# ----------------------------------------------------------------------

#: The float32 triangles' table (csrc/sweep_common.cuh SVGD_DISPATCH_TRI_M,
#: SymTile, TermsTriTile; the row width the triangle wrappers hand the
#: library): m -> (instance, tile of one RBF, tile of terms, row width).
#: The micro-tile body's exact instances at m = 1-8 and 11 take the rows
#: as they are; the wide instance (MM = 0) at every other m takes them
#: padded to 4 (``wide_row_width``, which rounds any m up to 4).
TRIANGLE_TABLE = {
    m: ((m, 128, 128, m) if m <= 8 or m == 11
        else (0, 128, 128, -(-m // 4) * 4))
    for m in range(1, 65)
}


@pytest.mark.parametrize("m", range(1, 65))
def test_triangle_plan_table(m):
    inst, tile, tile_terms, width = TRIANGLE_TABLE[m]
    assert sym_plan.dispatch_m(m) == inst
    assert sym_plan.tri_wide(m) is (inst == sym_plan.WIDE_MM)
    assert sym_plan.sym_tile(m) == tile
    assert sym_plan.sym_tile(m, terms=True) == tile_terms
    assert (sym_plan.wide_row_width(m) if sym_plan.tri_wide(m)
            else m) == width
    assert sym_plan.wide_row_width(m) == -(-m // 4) * 4
    assert width % 4 == 0 or inst != sym_plan.WIDE_MM


@pytest.mark.parametrize("n", [1, 9, 127, 128, 129, 255, 256, 257, 1000,
                               4097, 10000, 10007])
def test_wide_walk_covers_each_pair_once_at_the_moved_widths(n):
    """At every moved width the triangle's tile is the wide body's 128, and
    the blocks of one launch (one an SM, at most one a tile pair) over the
    whole triangle and over each rank's chunk of worlds 1-3 visit every
    tile pair once, so every unordered pair (diagonal included) once."""
    assert {sym_plan.sym_tile(m, t) for m in MOVED for t in (False, True)} \
        == {sym_plan.WIDE_TILE}
    tile = sym_plan.WIDE_TILE
    nb = -(-n // tile)
    want = [(i, j) for i in range(nb) for j in range(i, nb)]
    for world in (None, 1, 2, 3):
        ranges = ([(0, len(want))] if world is None else
                  [sym_plan.sym_tile_chunk(n, world, r, tile)
                   for r in range(world)])
        seen, pairs = [], 0
        for t0, count in ranges:
            blocks = sym_plan.wide_sym_blocks(count)
            assert blocks == min(count, sym_plan.WIDE_SYM_SMS)
            for block in range(blocks):
                for bi, bj in sym_plan.wide_sym_walk(n, t0, count, block):
                    seen.append((bi, bj))
                    rows = min(tile, n - bi * tile)
                    cols = min(tile, n - bj * tile)
                    pairs += rows * (rows + 1) // 2 if bi == bj else \
                        rows * cols
        assert sorted(seen) == want
        assert pairs == n * (n + 1) // 2


# ----------------------------------------------------------------------
# The wrappers on a stand-in library
# ----------------------------------------------------------------------


def _stand_in(monkeypatch, calls):
    """A library that answers the plan's questions with sym_plan's copies
    and records each launch, and the card's context managers stood in."""

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                if name == "svgd_square_splits":
                    return sym_plan.square_splits(*args)
                if name == "svgd_sym_tile":
                    return sym_plan.sym_tile(args[0], bool(args[1]))
                return 0
            return entry

    monkeypatch.setattr(cuda_phi, "_require_cuda", lambda tensor: None)
    monkeypatch.setattr(cuda_phi, "load_library", Library)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("m", [9, 10, 13, 33, 54, 55, 64])
def test_mid_width_wrappers_pad_the_triangles(monkeypatch, m):
    """K2, K8/K9, K4 and K10/K11 hand the library the padded width
    wide_row_width(m) and allocate the (2 x width, n) accumulator, return
    phi (or the chunk's accumulator) of m columns and count one launch
    each; K1 and K6/K7 keep m itself up to 64 (their tensor-core
    instances); K14's term groups take the padded width too (their wide
    kernels)."""
    calls, shapes = [], []
    _stand_in(monkeypatch, calls)
    real = torch.zeros

    def spy(*size, **kw):
        one = size[0] if len(size) == 1 else size
        shapes.append(tuple(one) if isinstance(one, (tuple, list))
                      else (one,))
        return real(*size, **kw)
    monkeypatch.setattr(torch, "zeros", spy)
    n, thr = 300, _meta(3)
    x, g = _meta(n, m), _meta()
    gs, signs = [_meta(), _meta()], (1.0, 1.0)
    width = sym_plan.wide_row_width(m)
    assert width % 4 == 0 and width >= m
    cuda_phi.reset_launch_counts()
    runs = [
        (cuda_phi.SYM_KERNEL, "svgd_fused_phi_counts_sym",
         lambda: cuda_phi.phi_rbf_fused_cuda(x, x, g, thr, sym=True)),
        (cuda_phi.TERMS_SYM_KERNEL, "svgd_fused_phi_terms_sym",
         lambda: cuda_phi.phi_rbf_terms_fused_cuda(x, x, gs, signs, thr,
                                                   sym=True)),
        (cuda_phi.SYM_CHUNK_KERNEL, "svgd_fused_phi_counts_sym_chunk",
         lambda: cuda_phi.phi_rbf_fused_sym_chunk_cuda(x, x, g, thr, 2, 1)),
        (cuda_phi.TERMS_SYM_CHUNK_KERNEL, "svgd_fused_phi_terms_sym_chunk",
         lambda: cuda_phi.phi_rbf_terms_fused_sym_chunk_cuda(
             x, x, gs, signs, thr, 2, 1)),
    ]
    for kernel, entry, run in runs:
        del calls[:], shapes[:]
        phi, counts = run()
        launches = [a for name, a in calls if name == entry]
        assert len(launches) == 1, (entry, calls)
        assert width in launches[0] and (width == m or m not in launches[0])
        assert (2 * width, n) in shapes
        assert tuple(phi.shape) == ((n, m) if "chunk" not in entry
                                    else (2 * m, n))
        assert tuple(counts.shape) == (3,)
        if "chunk" in entry:  # rank 1 of 2 on the tile list of 128
            assert sym_plan.sym_tile_chunk(n, 2, 1, 128) == \
                launches[0][-5:-3]
        assert cuda_phi.launch_counts[kernel] == 1
    for entry, run in (
            ("svgd_fused_phi_counts_square",
             lambda: cuda_phi.phi_rbf_fused_cuda(x, x, g, thr, sym=False)),
            ("svgd_fused_phi_terms_square",
             lambda: cuda_phi.phi_rbf_terms_fused_cuda(x, x, gs, signs, thr,
                                                       sym=False))):
        del calls[:]
        run()
        args = [a for name, a in calls if name == entry][0]
        assert args[-2] == sym_plan.square_splits(n, n, m)
        assert args[7 if "counts" in entry else 9] == m
    lowers = torch.eye(m, dtype=torch.float64)[None]
    x_c = torch.zeros((n, m))
    got = cuda_phi.aniso_group_operands(x_c, torch.zeros((n, m)), lowers)
    assert got[3] == width and tuple(got[0].shape) == (n, width)
    cuda_phi.reset_launch_counts()


# ----------------------------------------------------------------------
# The card's form rule on the moved widths
# ----------------------------------------------------------------------

RULE_N = (1, 1000, 2047, 2048, 4096, 10000, 32768, 45057, 131072, 262144,
          10**6)


@pytest.mark.parametrize("num_terms", [None, 1, 2, 3])
def test_card_rule_on_the_moved_widths(num_terms):
    """Where the triangle runs the wide body: the square sweep below
    SYM_MIN_N, the full-width triangle from there, never the panel; the
    forced forms pass through."""
    for m in MOVED:
        for n in RULE_N:
            got = cuda_phi.resolve_sym(None, n, m, num_terms)
            assert got is (n >= sym_plan.SYM_MIN_N), (n, m)
            assert sym_plan.card_resolve_sym(n, m, num_terms) is got
        assert cuda_phi.resolve_sym("panel", 10**6, m, num_terms) == "panel"
        assert cuda_phi.resolve_sym(False, 10**6, m, num_terms) is False


def test_card_rule_moves_where_chip_smoke_measures_it():
    """Phase 48e's shapes: the JAX rule takes the panel at (10000, 54) with
    one RBF, the square form at (10000, 55) with two terms, and both at
    (32768, 33); the card's rule takes the triangle at all four, and at
    chip_profile.py --mid-width's shapes past the JAX budget at m = 9, 12
    and 16, where the JAX rule takes the panel. At the micro widths the
    two rules agree (tests/test_torch_panel.py)."""
    assert sym_plan.jax_resolve_sym(10000, 54) == "panel"
    assert sym_plan.jax_resolve_sym(10000, 55, 2) is False
    assert sym_plan.jax_resolve_sym(32768, 33) == "panel"
    assert sym_plan.jax_resolve_sym(32768, 33, 2) is False
    for n, m, terms in ((10000, 54, None), (10000, 55, 2), (32768, 33, None),
                        (32768, 33, 2)):
        assert cuda_phi.resolve_sym(None, n, m, terms) is True
    # chip_profile.py --mid-width's forms past the JAX budget at m = 9-16:
    # the JAX rule's panel there, the card's triangle.
    for n in (65536, 131072):
        for m in (9, 12, 16):
            for terms in (None, 2):
                assert sym_plan.jax_resolve_sym(n, m, terms) == "panel"
                assert cuda_phi.resolve_sym(None, n, m, terms) is True
    for m in (2, 11):
        assert cuda_phi.resolve_sym(None, 262144, m) == \
            sym_plan.jax_resolve_sym(262144, m)


@pytest.mark.parametrize("m", [9, 12, 16, 33, 54, 64, 65, 123])
def test_bf16_rule_keeps_the_jax_rule_up_to_64(m):
    """K2's and K3's bfloat16 instances did not move: under
    dot_dtype='bfloat16' resolve_sym(None, ...) is the JAX rule up to
    m = 64 (the panel past its budget) and the card's past it, as before
    the float32 mid widths moved; float32 takes the card's rule."""
    for n in RULE_N:
        got = cuda_phi.resolve_sym(None, n, m, dot_dtype="bfloat16")
        card = n >= sym_plan.SYM_MIN_N
        want = sym_plan.jax_resolve_sym(n, m) if m <= 64 else card
        assert got == want and type(got) is type(want), (n, m)
        assert sym_plan.card_resolve_sym(n, m, bf16=True) == want
        assert cuda_phi.resolve_sym(None, n, m) is card
    with pytest.raises(ValueError):
        cuda_phi.resolve_sym(None, 10000, m, dot_dtype="float16")


@pytest.mark.parametrize("dot_dtype", ["float32", "bfloat16"])
def test_driver_form_follows_the_dot_dtype(monkeypatch, dot_dtype):
    """The 'fused_cuda' driver resolves its form with its
    fused_dot_dtype (with the card stood in): resolve_sym gets it, and at
    (12288, 54) that gives the triangle in float32 and the JAX rule's
    panel in bfloat16."""
    import svgdcpp_tpu_torch as st
    import svgdcpp_tpu_torch.svgd as driver_module

    n, m = 300, 54
    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.normal(size=(n, m)))
    port = st.SVGD(st.SVGDOptions(
        dimension=m, num_iterations=1, coordinate_matrix=x0,
        kernel=st.GaussianRBFKernel(x0),
        model=st.MultivariateNormal(np.zeros(m), np.eye(m)),
        optimizer=st.AdaGrad(m, n, 0.1), phi_impl="fused_cuda",
        fused_dot_dtype=dot_dtype, device="cpu"))
    seen = []

    def spy(sym, n_, m_, num_terms=None, dot_dtype="float32"):
        seen.append(dot_dtype)
        return cuda_phi.resolve_sym(sym, 12288, m_, num_terms, dot_dtype)
    monkeypatch.setattr(driver_module, "resolve_sym", spy)
    port.store = SimpleNamespace(
        value=SimpleNamespace(device=SimpleNamespace(type="cuda")))
    port._select_impl()
    assert seen == [dot_dtype]
    assert port.fused_sym_form == (True if dot_dtype == "float32"
                                   else "panel")
    assert sym_plan.jax_resolve_sym(12288, m) == "panel"


def test_sharded_rule_on_the_moved_widths():
    """The engine's None follows the card's rule at the moved widths (never
    the panel), and a forced "panel" or "full" runs there."""
    for m in (9, 10, 12, 33, 54, 55, 64):
        for n in RULE_N:
            for world in (1, 2, 4, 8):
                for terms in (None, 2):
                    got = resolve_sharded_sym(None, True, n, m, world,
                                              terms is None, num_terms=terms)
                    assert got == ("full" if n >= sym_plan.SYM_MIN_N
                                   else False), (n, m, world, terms)
        assert resolve_sharded_sym("panel", True, 262144, m, 4,
                                   True) == "panel"
        assert resolve_sharded_sym("full", True, 100, m, 2, True) == "full"
    # The micro widths keep the JAX rule: the panel at path A's shape.
    assert resolve_sharded_sym(None, True, 262144, 2, 4, True) == "panel"


# ----------------------------------------------------------------------
# The slice as a whole
# ----------------------------------------------------------------------


@pytest.mark.parametrize("hierarchical", [False, True])
def test_covertype_width_blr_drivers_match_jax(hierarchical):
    """Flat BLR at Covertype's d = 54 (m = 54) and hierarchical at d = 54
    (m = 55), auto (the plain fused sweeps on the CPU), 3 Adam steps at
    N = 300 in float64 against the JAX drivers."""
    n, d = 300, 54
    feats, labels, x0 = blr_workload(n, d, hierarchical=hierarchical)
    x0 = x0.astype(np.float64)
    sj = bench.build_blr_svgd(x0, feats, labels, hierarchical=hierarchical,
                              steps_per_call=3)
    s_t = build_blr_svgd(x0, feats, labels, hierarchical=hierarchical,
                         num_iterations=3, device="cpu")
    assert sj._phi_impl == s_t._phi_impl
    np.testing.assert_allclose(s_t.run().numpy(), np.asarray(sj.run()),
                               rtol=1e-8, atol=1e-12)
