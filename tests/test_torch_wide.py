"""The fused sweeps past m = 64 (the square kernels K1 and K6/K7, the
full-width triangles K2/K4 and K8-K11), on the CPU.

* The plain versions, through the CUDA wrappers on CPU tensors, against
  the JAX package's Pallas kernels in interpret mode at m = 65, 100 and
  123, off origin: K1 square and cross, K2, K6 and K7 (cross), K8 and K9
  (triangle), K4 and K10/K11 summed over the port's worlds 1 and 2 against
  the JAX sharded kernels summed over their chunks. phi rtol 2e-4, atol
  2e-5 (the JAX package's interpret tolerance); the counts equal the
  float64 plain version's and lie within COUNT_SLACK of the Pallas
  kernel's, whose sq comes from a bf16x3-split Gram identity.
* The plan mirrors past 64 (``ops/sym_plan``): the wide instance, its tile
  side, the square launch's splits (covering every source once), and the
  wide tile list covering every unordered pair once at worlds 1-8.
* The wrappers on a stand-in library (meta tensors stand in for the card)
  at m = 65, 123 and 512: each widened wrapper hands m to the library,
  allocates its workspace or accumulator and counts one launch; so do the
  panel wrappers and the anisotropic and fixed-P ones
  (tests/test_torch_wide_panel.py and tests/test_torch_wide_p.py hold
  those), and ``symmetric_eigen`` alone still raises past 64, naming its
  one block's shared memory.
* The form rules past 64: ``resolve_sym(None, ...)`` never "panel",
  ``resolve_sharded_sym`` never "panel" under None and taking a forced
  one; the CPU route against the JAX driver's; with the card stood in,
  the driver and the engine at m = 123 take the kernel routes without the
  old dimension error, the 'cuda' route and a forced panel included.
* The slice as a whole: the flat (m = 123) and hierarchical (m = 124) BLR
  drivers on ``auto``, 5 Adam steps in float64 against the JAX drivers,
  rtol 1e-9.
"""

from contextlib import nullcontext
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.ops import pallas_phi as pj
from svgdcpp_tpu_torch.ops import cuda_phi, sym_plan
from svgdcpp_tpu_torch.ops import phi as pht
from svgdcpp_tpu_torch.parallel import ParticleGroup, ShardedSVGD
from svgdcpp_tpu_torch.parallel import ShardedSVGDConfig
from svgdcpp_tpu_torch.parallel.sharded import resolve_sharded_sym
from svgdcpp_tpu_torch.utils.workloads import blr_workload, build_blr_svgd

torch.set_num_threads(1)

#: The widths the tests take past 64: just past it, a round one and a9a's
#: 123 features (a flat BLR's m).
WIDE = (65, 100, 123)

#: The most the Pallas kernels' counts may differ from the plain version's
#: (one pair, both orders, on the other side of a threshold, twice over),
#: as in test_torch_square.py.
COUNT_SLACK = 4


def _inputs(n, m, offset, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, m)) + offset).astype(np.float32)
    s = rng.normal(size=(n, m)).astype(np.float32)
    return x, s


def _thresholds(m):
    return np.linspace(0.5, 4.0 * m, 4).astype(np.float32)


def _check(got, want, exact):
    """phi against the Pallas kernel's; counts equal to the float64 plain
    version's and within COUNT_SLACK of the Pallas kernel's."""
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(got[1].numpy(), exact.numpy())
    cnt = np.asarray(want[1]).astype(np.int64)
    assert np.abs(got[1].numpy() - cnt).max() <= COUNT_SLACK


def _f64(*arrays):
    return [torch.from_numpy(a).double() for a in arrays]


# ----------------------------------------------------------------------
# The plain versions against the Pallas kernels
# ----------------------------------------------------------------------


@pytest.mark.parametrize("m", WIDE)
@pytest.mark.parametrize("cross", [False, True])
def test_k1_wide_vs_pallas_interpret(m, cross):
    xs, s = _inputs(230, m, 2.0, 700 + m)
    xt = _inputs(130, m, 2.2, 710 + m)[0] if cross else xs
    gamma = np.float32(0.6 / m)
    thr = _thresholds(m)
    cuda_phi.reset_launch_counts()
    if cross:
        want = pj.phi_rbf_fused_pallas_cross(
            jnp.asarray(xt), jnp.asarray(xs), jnp.asarray(s), gamma,
            jnp.asarray(thr), tile_i=64, tile_j=128, interpret=True)
        got = cuda_phi.phi_rbf_fused_cuda_cross(
            *map(torch.from_numpy, (xt, xs, s)), torch.tensor(gamma),
            torch.from_numpy(thr))
    else:
        want = pj.phi_rbf_fused_pallas(
            jnp.asarray(xs), jnp.asarray(s), gamma, jnp.asarray(thr),
            tile_i=64, tile_j=128, interpret=True, sym=False)
        got = cuda_phi.phi_rbf_fused_cuda(
            *map(torch.from_numpy, (xs, s)), torch.tensor(gamma),
            torch.from_numpy(thr), sym=False)
    assert not any(cuda_phi.launch_counts.values())
    exact = pht.phi_rbf_cross_fused_counts(
        *_f64(xt, xs, s), torch.tensor(float(gamma), dtype=torch.float64),
        *_f64(thr))[1]
    _check(got, want, exact)


@pytest.mark.parametrize("m", WIDE)
def test_k2_wide_vs_pallas_interpret(m):
    x, s = _inputs(250, m, 2.0, 720 + m)
    gamma = np.float32(0.6 / m)
    thr = _thresholds(m)
    want = pj.phi_rbf_fused_pallas(
        jnp.asarray(x), jnp.asarray(s), gamma, jnp.asarray(thr), tile_i=64,
        tile_j=128, interpret=True, sym=True)
    got = cuda_phi.phi_rbf_fused_cuda(
        *map(torch.from_numpy, (x, s)), torch.tensor(gamma),
        torch.from_numpy(thr), sym=True)
    exact = pht.phi_rbf_fused_counts(
        *_f64(x, s), torch.tensor(float(gamma), dtype=torch.float64),
        *_f64(thr))[1]
    _check(got, want, exact)


#: The JAX package's composed kernels: K7 and K6 (cross), K9 and K8
#: (triangle).
TERMS_CROSS = {"K7": pj._phi_rbf_terms_fused_pallas_cross_impl,
               "K6": pj._phi_rbf_terms_fused_pallas_cross_direct_impl}
TERMS_SYM = {"K9": pj._phi_rbf_terms_fused_pallas_sym_impl,
             "K8": pj._phi_rbf_terms_fused_pallas_sym_direct_impl}


@pytest.mark.parametrize("m", WIDE)
@pytest.mark.parametrize("kernel", ["K7", "K6", "K9", "K8"])
def test_terms_wide_vs_pallas_interpret(kernel, m):
    sym = kernel in TERMS_SYM
    signs = (1.0, 1.0) if m != 100 else (1.0, -0.5, 0.3)
    xs, s = _inputs(220, m, 2.0, 730 + m)
    xt = xs if sym else _inputs(120, m, 2.2, 740 + m)[0]
    g = 0.6 / m
    gammas = [np.float32(g), np.float32(0.1 / m), np.float32(2.0 * g)][
        :len(signs)]
    thr = _thresholds(m)
    jg = tuple(jnp.float32(gm) for gm in gammas)
    tg = [torch.tensor(gm) for gm in gammas]
    if sym:
        want = TERMS_SYM[kernel](jnp.asarray(xs), jnp.asarray(s), jg, signs,
                                 jnp.asarray(thr), thr.shape[0], 64, 128,
                                 True)
        got = cuda_phi.phi_rbf_terms_fused_cuda(
            *map(torch.from_numpy, (xs, s)), tg, signs, torch.from_numpy(thr),
            sym=True)
    else:
        want = TERMS_CROSS[kernel](
            jnp.asarray(xt), jnp.asarray(xs), jnp.asarray(s), jg, signs,
            jnp.asarray(thr), thr.shape[0], 64, 128, True)
        got = cuda_phi.phi_rbf_terms_fused_cuda_cross(
            *map(torch.from_numpy, (xt, xs, s)), tg, signs,
            torch.from_numpy(thr))
    exact = pht.phi_rbf_terms_cross_fused_counts(
        *_f64(xt, xs, s),
        [torch.tensor(float(gm), dtype=torch.float64) for gm in gammas],
        signs, *_f64(thr))[1]
    _check(got, want, exact)


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


@pytest.mark.parametrize("m", WIDE)
@pytest.mark.parametrize("kernel", ["K4", "K11", "K10"])
def test_chunks_wide_vs_jax_sharded_interpret(kernel, m):
    """The chunk wrappers on CPU tensors (their plain chunks over the wide
    tile list of 128 particles a side), summed over the port's worlds 1 and
    2, against the JAX sharded kernel summed over 3 chunks in interpret
    mode, both finished as the engines finish them."""
    n, d = 300, 3
    assert sym_plan.sym_tile(m, kernel != "K4") == sym_plan.WIDE_TILE
    x, s = _inputs(n, m, 1.0, 750 + m)
    thr = _thresholds(m)
    pi, pj_, n_pad, per = pj.sym_pairs_plan(n, d, 64, 128)
    kw = dict(n_pad=n_pad, num_thresholds=thr.shape[0], tile_i=64,
              tile_j=128, interpret=True)
    xj, sj, thj = jnp.asarray(x), jnp.asarray(s), jnp.asarray(thr)
    center = jnp.mean(xj, axis=0)
    xt, stt, tht = map(torch.from_numpy, (x, s, thr))
    if kernel == "K4":
        g = np.float32(0.6 / m)
        acc_j, lanes = _jax_chunks(
            lambda a, b: pj.phi_rbf_fused_pallas_sym_sharded(
                xj, sj, g, thj, a, b, **kw), d, per, pi, pj_)
        want_phi = pj.phi_rbf_fused_sym_finish(acc_j[:, :n], sj, xj, center,
                                               g, n)

        def port(world, rank):
            return cuda_phi.phi_rbf_fused_sym_chunk_cuda(
                xt, stt, torch.tensor(g), tht, world, rank)

        def finish(acc):
            return pht.phi_rbf_fused_sym_finish(acc, stt, torch.tensor(g), n)
        exact = pht.phi_rbf_fused_counts(
            *_f64(x, s), torch.tensor(float(g), dtype=torch.float64),
            *_f64(thr))[1]
    else:
        gs = (np.float32(0.6 / m), np.float32(0.15 / m))
        signs = (1.0, 1.0)
        jg = [jnp.float32(gm) for gm in gs]
        if kernel == "K11":
            acck, accw, lanes = _jax_chunks(
                lambda a, b: pj.phi_rbf_terms_fused_pallas_sym_sharded(
                    xj, sj, jg, signs, thj, a, b, **kw), d, per, pi, pj_)
            want_phi = pj.phi_rbf_terms_fused_sym_finish(
                acck[:, :n], accw[:, :n], sj, xj, center, jnp.stack(jg),
                signs, n)
        else:
            acc_j, lanes = _jax_chunks(
                lambda a, b: pj.phi_rbf_terms_fused_pallas_sym_sharded_direct(
                    xj, sj, jg, signs, thj, a, b, **kw), d, per, pi, pj_)
            want_phi = pj.phi_rbf_terms_fused_sym_direct_finish(
                acc_j[:, :n], sj, xj, center, jnp.stack(jg), signs, n)
        tg = [torch.tensor(gm) for gm in gs]

        def port(world, rank):
            return cuda_phi.phi_rbf_terms_fused_sym_chunk_cuda(
                xt, stt, tg, signs, tht, world, rank)

        def finish(acc):
            return pht.phi_rbf_terms_fused_sym_finish(acc, stt, signs, n)
        exact = pht.phi_rbf_terms_fused_counts(
            *_f64(x, s),
            [torch.tensor(float(gm), dtype=torch.float64) for gm in gs],
            signs, *_f64(thr))[1]
    want = (want_phi, 2.0 * jnp.sum(lanes, axis=1) - n)
    cuda_phi.reset_launch_counts()
    for world in (1, 2):
        acc, upper = _port_chunks(port, world)
        _check((finish(acc), 2 * upper - n), want, exact)
    assert not any(cuda_phi.launch_counts.values())


# ----------------------------------------------------------------------
# The plan mirrors past 64
# ----------------------------------------------------------------------

PLAN_WIDTHS = (65, 100, 123, 124, 128, 256, 512)

#: The float32 wide square body's plan (csrc/square_wide_sm90.cuh): per m,
#: the sources a split at (1000, 1000) and the split counts at (1000,
#: 1000), (1500, 1500), the cross form (700, 1500) and (10000, 10000).
#: Up to m = 128 a block holds 64 target rows (16 x 8 = 128 blocks at
#: n = 1000, 24 x 5 = 120 at 1500), at 256 it holds 32, at 512 16.
WIDE_SQUARE_PINS = {
    65: (128, 8, 5, 12, 5), 100: (128, 8, 5, 12, 5),
    123: (128, 8, 5, 12, 5), 124: (128, 8, 5, 12, 5),
    128: (128, 8, 5, 12, 5), 256: (256, 4, 5, 6, 5), 512: (512, 2, 4, 3, 4),
}
#: K1's bf16 instance on its own body (csrc/square_bf16_sm90.cuh's
#: sq_bf16_chunk: target blocks of 128 rows, whole tiles of 64 sources, the
#: record in chunks of 128 columns along the grid's z): the sources a split
#: at (1000, 1000) and the split count at (10000, 10000).
WIDE_SQUARE_BF16_PINS = {
    65: (128, 5), 100: (128, 5), 123: (128, 5), 124: (128, 5),
    128: (256, 5), 256: (384, 1), 512: (384, 2),
}


@pytest.mark.parametrize("m", PLAN_WIDTHS)
def test_wide_plan_mirrors_pinned(m):
    """Past 64 one wide instance (MM = 0) serves every m, in triangle
    tiles of 128 for one RBF and terms alike (the float32 triangles' body,
    csrc/wide_tri_sm90.cuh); the square launch takes the float32 wide
    square body's plan (csrc/square_wide_sm90.cuh: whole tiles of 64
    sources, the split count that fills whole waves of 132 blocks), the
    bf16 instance its own body's (csrc/square_bf16_sm90.cuh,
    WIDE_SQUARE_BF16_PINS)."""
    assert sym_plan.dispatch_m(m) == sym_plan.WIDE_MM == 0
    assert sym_plan.sym_tile(m) == sym_plan.sym_tile(m, True) == 128
    assert sym_plan.square_tensor(m)
    chunk, *splits = WIDE_SQUARE_PINS[m]
    assert sym_plan.square_chunk(1000, 1000, m) == chunk
    assert [sym_plan.square_splits(n_t, n_s, m) for n_t, n_s in (
        (1000, 1000), (1500, 1500), (700, 1500), (10000, 10000))] == splits
    bf16_chunk, bf16_splits = WIDE_SQUARE_BF16_PINS[m]
    assert sym_plan.square_chunk(1000, 1000, m, bf16=True) == bf16_chunk
    assert sym_plan.square_splits(10000, 10000, m, bf16=True) == bf16_splits
    assert sym_plan.dispatch_m(64) == 64 and sym_plan.sym_tile(64) == 32


@pytest.mark.parametrize("m,rows,passes", [
    (65, 64, 1), (123, 64, 1), (124, 64, 1), (128, 64, 1), (129, 32, 1),
    (256, 32, 1), (257, 16, 1), (512, 16, 1), (513, 16, 2), (2000, 16, 4),
])
def test_wide_square_body_layout(m, rows, passes):
    """The float32 wide square body's layout (sq_wide_plan's mirror): the
    record [S | 0.. | X | 0..] of the padded width w, X from the first
    multiple of 8 at or past w; the block's target rows the most whose
    accumulators of every record column fit 16 warps of 8 blocks of
    16 x 8 (64 rows up to 32 blocks, 32 up to 64, 16 up to 128); one
    pass up to m = 512, the target rows resident; past it passes of 128
    blocks along the grid's z, the target rows streamed; the dynamic
    shared memory within the H100's 227 KB a block with either weight
    tile count."""
    plan = sym_plan.square_wide_plan(m)
    w = sym_plan.wide_row_width(m)
    assert plan.width == w and plan.xo == 8 * -(-w // 8)
    assert plan.blocks == -(-(plan.xo + w) // 8)
    assert (plan.rows, plan.passes) == (rows, passes)
    assert plan.rows // 16 * plan.cap == 16 * 8
    assert plan.blocks <= plan.passes * plan.cap
    assert plan.streamed == (passes > 1)
    assert plan.smem < plan.smem_terms <= 232448 - 192


@pytest.mark.parametrize("n", [1, 33, 127, 129, 1000, 1001, 10007])
@pytest.mark.parametrize("m", [65, 123, 124, 512])
def test_wide_square_plan_covers_each_source_once(n, m):
    """Every source lies in exactly one split of whole 64-source tiles
    (the square and the cross forms: n targets against n sources, and 700
    against n), no split is empty, and the grid (target blocks x splits x
    passes) never leaves a wave of 132 blocks emptier than the fewest
    splits would."""
    for n_t in (n, 700):
        splits = sym_plan.square_splits(n_t, n, m)
        chunk = sym_plan.square_chunk(n_t, n, m)
        assert chunk % sym_plan.SQUARE_WIDE_TILE == 0
        owner = [j // chunk for j in range(n)]
        assert sorted(set(owner)) == list(range(splits))
        assert (splits - 1) * chunk < n <= splits * chunk
        plan = sym_plan.square_wide_plan(m)
        row_blocks = -(-n_t // plan.rows)
        tiles = -(-n // sym_plan.SQUARE_WIDE_TILE)

        def cost(s):
            return -(-row_blocks * s * plan.passes // 132) * (
                -(-tiles // s) + 1)
        assert cost(splits) <= cost(1)


@pytest.mark.parametrize("n_t,n_s", [(1, 1), (130, 230), (1000, 1000),
                                     (700, 1500), (10007, 10007)])
@pytest.mark.parametrize("m", PLAN_WIDTHS)
def test_wide_square_splits_cover_the_sources(n_t, n_s, m):
    splits = sym_plan.square_splits(n_t, n_s, m)
    chunk = sym_plan.square_chunk(n_t, n_s, m)
    assert chunk % sym_plan.SQUARE_GRAIN == 0
    assert (splits - 1) * chunk < n_s <= splits * chunk


@pytest.mark.parametrize("world", range(1, 9))
def test_wide_tile_list_covers_each_pair_once(world):
    side = sym_plan.sym_tile(123)
    for n in (63, 64, 1000, 10007):
        nb = -(-n // side)
        seen, pairs, counts = [], 0, []
        for rank in range(world):
            t0, count = sym_plan.sym_tile_chunk(n, world, rank, side)
            counts.append(count)
            for bi, first, last in sym_plan.upper_tile_rows(nb, t0, count):
                for bj in range(first, last + 1):
                    seen.append((bi, bj))
                    rows = min(side, n - bi * side)
                    cols = min(side, n - bj * side)
                    pairs += (rows * (rows + 1) // 2 if bi == bj
                              else rows * cols)
        assert seen == [(i, j) for i in range(nb) for j in range(i, nb)]
        assert pairs == n * (n + 1) // 2
        assert max(counts) - min(counts) <= 1


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


@pytest.mark.parametrize("m", [65, 123, 512])
def test_widened_wrappers_launch_past_64(monkeypatch, m):
    """K1, K6/K7, K2, K8/K9, K4 and K10/K11 hand the library the row width
    ``sym_plan.wide_row_width(m)`` (m rounded up to 4 with zero columns,
    so that the wide bodies' 16-byte copies start every row aligned), size
    the square workspace by its splits (splits, n, 2 x that width + 1) and
    the triangles' accumulator (2 x that width, n), return phi of m
    columns, and count one launch each."""
    calls = []
    _stand_in(monkeypatch, calls)
    shapes = []
    for name in ("empty", "zeros"):
        real = getattr(torch, name)

        def spy(*size, real=real, **kw):
            one = size[0] if len(size) == 1 else size
            shapes.append(tuple(one) if isinstance(one, (tuple, list))
                          else (one,))
            return real(*size, **kw)
        monkeypatch.setattr(torch, name, spy)
    n, thr = 300, _meta(3)
    x, g = _meta(n, m), _meta()
    gs, signs = [_meta(), _meta()], (1.0, 1.0)
    cuda_phi.reset_launch_counts()
    runs = [
        (cuda_phi.SQUARE_KERNEL, "svgd_fused_phi_counts_square",
         lambda: cuda_phi.phi_rbf_fused_cuda(x, x, g, thr, sym=False)),
        (cuda_phi.TERMS_SQUARE_KERNEL, "svgd_fused_phi_terms_square",
         lambda: cuda_phi.phi_rbf_terms_fused_cuda(x, x, gs, signs, thr,
                                                   sym=False)),
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
    splits = sym_plan.square_splits(n, n, m)
    for kernel, entry, run in runs:
        del calls[:], shapes[:]
        phi, counts = run()
        launches = [a for name, a in calls if name == entry]
        assert len(launches) == 1, (entry, calls)
        args = launches[0]
        width = sym_plan.wide_row_width(m)
        assert width % 4 == 0
        assert width in args and n in args
        assert tuple(counts.shape) == (3,)
        if "square" in entry:
            assert tuple(phi.shape) == (n, m)
            assert args[-2] == splits
            assert (splits, n, 2 * width + 1) in shapes
        else:
            assert (2 * width, n) in shapes
            assert tuple(phi.shape) == ((n, m) if "chunk" not in entry
                                        else (2 * m, n))
        if "chunk" in entry:  # rank 1 of 2 on the wide tile list
            t0, count = sym_plan.sym_tile_chunk(n, 2, 1, 128)
            assert (t0, count) == args[-5:-3]
            assert ("svgd_sym_tile", (m, int("terms" in entry))) in calls
        assert cuda_phi.launch_counts[kernel] == 1
    cuda_phi.reset_launch_counts()


@pytest.mark.parametrize("m", [65, 123, 512])
def test_narrow_families_still_refuse_past_64(monkeypatch, m):
    """Of the families that stopped at 64 only sym_eigen still does, with
    its own reason (one block's shared memory), and launches nothing; the
    panel sweeps (K3, K12/K13, K5's chunk: their wide entries), the
    anisotropic and the fixed-P sweeps launch their wide instances, one
    launch each, all on the float32 wide triangle body, with the rows'
    padded width wide_row_width(m)."""
    calls = []
    _stand_in(monkeypatch, calls)
    x, g, thr = _meta(300, m), _meta(), _meta(3)
    with pytest.raises(ValueError, match=r"m <= 64.*shared memory"):
        cuda_phi.symmetric_eigen(_meta(m, m))
    assert not calls
    cuda_phi.reset_launch_counts()
    launches = [
        ("svgd_fused_phi_counts_sympanel_wide", cuda_phi.SYMPANEL_KERNEL,
         lambda: cuda_phi.phi_rbf_fused_cuda(x, x, g, thr, sym="panel")),
        ("svgd_fused_phi_terms_sympanel_wide",
         cuda_phi.TERMS_SYMPANEL_KERNEL,
         lambda: cuda_phi.phi_rbf_terms_fused_cuda(x, x, [g, g], (1.0, 1.0),
                                                   thr, sym="panel")),
        ("svgd_fused_phi_counts_sympanel_chunk_wide",
         cuda_phi.SYMPANEL_CHUNK_KERNEL,
         lambda: cuda_phi.phi_rbf_sympanel_chunk_cuda(x, x, g, thr, 2, 0)),
        ("svgd_fused_phi_aniso_terms_groups", cuda_phi.ANISO_WIDE_KERNEL,
         lambda: cuda_phi.phi_rbf_aniso_terms_fused_cuda(
             x, x, [g], (1.0,), None, (1.0,), thr,
             lowers=_meta(1, m, m).double())),
        ("svgd_phi_rbf_wide", cuda_phi.PHI_RBF_WIDE_KERNEL,
         lambda: cuda_phi.phi_rbf_cuda(x, x, None,
                                       eig=(_meta(m), _meta(m, m)))),
    ]
    for entry, kernel, call in launches:
        del calls[:]
        call()
        assert [c[0] for c in calls] == [entry]
        assert sym_plan.wide_row_width(m) in calls[0][1]
        assert cuda_phi.launch_counts[kernel] == 1
    cuda_phi.reset_launch_counts()
    cuda_phi.check_dimension(64, eigen=True)
    cuda_phi.check_dimension(m)
    with pytest.raises(ValueError, match="m >= 1"):
        cuda_phi.check_dimension(0)


# ----------------------------------------------------------------------
# The form rules past 64
# ----------------------------------------------------------------------

RULE_N = (1, 1000, 2047, 2048, 4096, 6144, 10000, 45057, 103424, 154624,
          10**6)


@pytest.mark.parametrize("num_terms", [None, 1, 2, 3])
def test_card_rule_past_64_is_never_the_panel(num_terms):
    """Past 64 the card's rule: the square sweep below SYM_MIN_N, the
    full-width triangle (measured faster) from there; up to 64 the JAX
    package's rule."""
    for m in (65, 100, 123, 124, 128, 256, 512):
        for n in RULE_N:
            got = cuda_phi.resolve_sym(None, n, m, num_terms)
            assert got is (n >= sym_plan.SYM_MIN_N)
    for n in RULE_N:
        assert (cuda_phi.resolve_sym(None, n, 64, num_terms)
                == sym_plan.jax_resolve_sym(n, 64, num_terms))
    # The forced forms pass through at any m.
    assert cuda_phi.resolve_sym(True, 10, 123) is True
    assert cuda_phi.resolve_sym(False, 10**6, 123, 2) is False
    assert cuda_phi.resolve_sym("panel", 10**6, 123) == "panel"


def test_sharded_rule_past_64():
    """Past 64 the engine's None follows the card's rule (never the panel,
    where the JAX decision takes it), and a forced "panel" and "full" run
    at any m."""
    for m in (65, 123, 124, 512):
        for n in RULE_N:
            for world in (1, 2, 4, 8):
                for terms in (None, 2):
                    got = resolve_sharded_sym(None, True, n, m, world,
                                              terms is None, num_terms=terms)
                    want = cuda_phi.resolve_sym(None, n, m, terms)
                    assert got == ("full" if want else False)
        assert resolve_sharded_sym("full", True, 100, m, 2, True) == "full"
        assert resolve_sharded_sym("panel", True, 262144, m, 4,
                                   True) == "panel"
    # The JAX rule up to 64: the panel at path A's shape.
    assert resolve_sharded_sym(None, True, 262144, 2, 4, True) == "panel"
    assert resolve_sharded_sym(None, True, 262144, 64, 4, True) in (
        "panel", False, "full")


def _mvn_drivers(n, m, seed=0):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=m)
    cov = np.eye(m)
    x0 = rng.normal(size=(n, m))
    x0t = torch.tensor(x0)
    port = st.SVGD(st.SVGDOptions(
        dimension=m, num_iterations=1, coordinate_matrix=x0t,
        kernel=st.GaussianRBFKernel(x0t),
        model=st.MultivariateNormal(mean, cov),
        optimizer=st.AdaGrad(m, n, 0.1), device="cpu")).initialize()
    jax_svgd = sv.SVGD(sv.SVGDOptions(
        dimension=m, num_iterations=1, coordinate_matrix=x0,
        kernel=sv.GaussianRBFKernel(x0), model=sv.MultivariateNormal(mean, cov),
        optimizer=sv.AdaGrad(m, n, 0.1))).initialize()
    return port, jax_svgd


def _on_card(svgd):
    """Re-run the driver's route selection as if its coordinates lay on
    a CUDA device."""
    svgd.store = SimpleNamespace(
        value=SimpleNamespace(device=SimpleNamespace(type="cuda")))
    svgd._select_impl()
    return svgd


@pytest.mark.parametrize("n,m", [(1500, 123), (2100, 123), (200, 65)])
def test_driver_routes_past_64(n, m):
    """On the CPU both packages take the same route; with the card stood
    in, auto takes the kernel route and its form by the card's rule, the
    fixed-P route ('cuda') runs, and a forced panel takes the panel form
    (its wide instance)."""
    port, jax_svgd = _mvn_drivers(n, m)
    assert port._auto_impl(on_cuda=False) == jax_svgd._phi_impl
    assert port._phi_impl == jax_svgd._phi_impl
    if n < 600:
        return
    port = _on_card(port)
    assert port._phi_impl == "fused_cuda"
    assert port.fused_sym_form is cuda_phi.resolve_sym(None, n, m)
    assert port.fused_sym_form != "panel"
    for impl, sym in (("fused_cuda", True), ("fused_cuda", False)):
        port.options.phi_impl, port.options.fused_sym = impl, sym
        assert _on_card(port).fused_sym_form is sym
    port.options.phi_impl, port.options.fused_sym = "cuda", None
    assert _on_card(port)._phi_impl == "cuda"
    port.options.phi_impl, port.options.fused_sym = "fused_cuda", "panel"
    assert _on_card(port).fused_sym_form == "panel"


def test_driver_terms_route_past_64():
    """The hierarchical BLR at m = 124 takes fused_terms_cuda on the card
    (stood in), with the card's form for two terms."""
    feats, labels, x0 = blr_workload(2100, 123, hierarchical=True)
    port = build_blr_svgd(x0, feats, labels, hierarchical=True,
                          num_iterations=1, device="cpu")
    assert port._phi_impl == "fused_terms"
    port = _on_card(port)
    assert port._phi_impl == "fused_terms_cuda"
    assert port.fused_sym_form is cuda_phi.resolve_sym(None, 2100, 124, 2)


def _fake_group(device, world=1):
    return ParticleGroup(None, 0, world, torch.device(device), "gloo")


@pytest.mark.parametrize("composed", [False, True])
def test_engine_routes_past_64(composed):
    """The engine at m = 123 with the card stood in: the CUDA sweep and the
    card's form, no dimension error; a forced panel takes the panel form
    (K5's wide instance)."""
    n, m = 4096, 123
    model = st.MultivariateNormal(np.zeros(m), np.eye(m))
    kernel = None
    if composed:
        x = np.random.default_rng(3).normal(size=(8, m))
        kernel = st.GaussianRBFKernel(
            x, st.ScaleMethod.MEDIAN, model, median_method="exact"
        ) + st.GaussianRBFKernel(x, st.ScaleMethod.CONSTANT,
                                 constant_scale=0.1 * np.eye(m))
    eng = ShardedSVGD(model, st.AdaGrad(m, n, 0.1), n, m,
                      mesh=_fake_group("cpu"), kernel=kernel,
                      config=ShardedSVGDConfig(fused_phi=True))
    assert eng._fused_cuda is False
    eng.mesh = _fake_group("cuda")
    eng._fused_cuda = eng._resolve_fused_cuda()
    assert eng._fused_cuda is True
    want = cuda_phi.resolve_sym(None, n, m, 2 if composed else None)
    assert eng._resolve_fused_sym() == ("full" if want else False)
    if not composed:
        eng.config = ShardedSVGDConfig(fused_phi=True, fused_sym="panel")
        assert eng._resolve_fused_sym() == "panel"


# ----------------------------------------------------------------------
# The slice as a whole
# ----------------------------------------------------------------------


@pytest.mark.parametrize("hierarchical", [False, True])
def test_wide_blr_drivers_match_jax(hierarchical):
    """Flat BLR at d = 123 (m = 123) and hierarchical at d = 123 (m = 124),
    auto (the plain fused sweeps on the CPU), 5 Adam steps in float64
    against the JAX drivers."""
    n, d = 1100, 123
    feats, labels, x0 = blr_workload(n, d, hierarchical=hierarchical)
    x0 = x0.astype(np.float64)
    sj = bench.build_blr_svgd(x0, feats, labels, hierarchical=hierarchical,
                              steps_per_call=5)
    s_t = build_blr_svgd(x0, feats, labels, hierarchical=hierarchical,
                         num_iterations=5, device="cpu")
    assert sj._phi_impl == s_t._phi_impl == (
        "fused_terms" if hierarchical else "fused")
    np.testing.assert_allclose(s_t.run().numpy(), np.asarray(sj.run()),
                               rtol=1e-9, atol=1e-12)
