"""The sharded engine of svgdcpp_tpu_torch against svgdcpp_tpu.

* Plans: ``ops/sym_plan``'s copies of ``sym_pairs_plan``,
  ``sym_sharded_plan`` and ``sym_panel_sharded_plan`` equal the JAX
  package's on a grid of (n, m, world); the card's chunks
  (``sym_tile_chunk``, ``panel_chunk``) cover each tile or panel exactly
  once for worlds 1 to 8, and the composed triangle kernel's tile list at
  every m = 1-64 each unordered pair exactly once.
* Chunk sweeps: the plain chunk versions (K4, K10/K11, K5), summed over
  the ranks and finished, against the JAX package's sharded kernels summed
  over their devices in interpret mode (float32, phi within 5e-6 of max
  |phi| as the JAX tests hold them, counts equal); the chunk wrappers on CPU
  tensors, summed over 3, 4 and 8 ranks (empty ranges included), against
  K2's and K3's plain versions in float64 (phi within 1e-10, counts equal).
* Engine, one rank (an in-process gloo group): ShardedSVGD against the
  JAX engine on the 8-device CPU mesh from the same x0 (float64; the
  tolerances of tests/test_sharded.py, tighter where the port follows the
  JAX selection exactly), the forced "full" and "panel" triangle schedules
  against the JAX fused cross engine, the config and form resolution, and
  the options that raise.
* Engine, two and four ranks: spawned gloo worlds
  (``tests/torch_sharded_worker.py``), the gathered coordinates against
  the JAX engine.
* State: a JAX sharded state split per rank (``sharded_state_from_numpy``)
  steps as the JAX engine does; ``state_from_numpy`` follows the package's
  device rule.
"""

import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu.ops import pallas_phi as pj
from svgdcpp_tpu.ops import phi as phj
from svgdcpp_tpu.parallel import ShardedSVGD as JaxSharded
from svgdcpp_tpu.parallel import ShardedSVGDConfig as JaxConfig
from svgdcpp_tpu.parallel import make_particle_mesh
from svgdcpp_tpu_torch.ops import cuda_phi, sym_plan
from svgdcpp_tpu_torch.ops import phi as pht
from svgdcpp_tpu_torch.ops.median import (
    centered_count_env,
    pairwise_distance_median_exact,
)
from svgdcpp_tpu_torch.parallel import (
    ParticleGroup,
    ShardedSVGD,
    ShardedSVGDConfig,
    initialize_distributed,
    place_sharded,
    sharded_pairwise_median,
)
from svgdcpp_tpu_torch.utils.convert import (
    sharded_state_from_numpy,
    state_from_numpy,
)

# The suite runs several xdist workers on one CPU: torch's default of an
# OpenMP thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MEAN = np.array([0.5, -1.0])
COV = np.array([[1.0, 0.2], [0.2, 0.8]])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo world in this process."""
    g = initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0,
                               device="cpu")
    yield g
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8
    return make_particle_mesh()


def fake_group(world, rank=0):
    """A ParticleGroup for the form decisions only (no collective runs)."""
    return ParticleGroup(None, rank, world, torch.device("cpu"), "gloo")


# ----------------------------------------------------------------------
# Plans and chunks
# ----------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_sharded_plans_equal_jax(world):
    for n in (1000, 2048, 4096, 10000, 10240, 100000, 262144, 500000):
        for m in (2, 11, 40):
            want = pj.sym_sharded_plan(n, m, world)
            got = sym_plan.sym_sharded_plan(n, m, world)
            assert (got is None) == (want is None), (n, m, world)
            if want is not None:
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
                assert got[2:] == want[2:]
            want = pj.sym_panel_sharded_plan(n, m, world)
            got = sym_plan.sym_panel_sharded_plan(n, m, world)
            assert (got is None) == (want is None), (n, m, world)
            if want is not None:
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
                assert got[2:] == want[2:]
    for n, ti, tj in ((10240, 512, 2048), (1000, 64, 128), (2048, 512, 2048)):
        want = pj.sym_pairs_plan(n, world, ti, tj)
        got = sym_plan.sym_pairs_plan(n, world, ti, tj)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:] == want[2:]


@pytest.mark.parametrize("world", range(1, 9))
def test_card_chunks_cover_each_tile_once(world):
    for n, tile in ((100, 64), (1000, 64), (10000, 64), (2100, 32),
                    (10000, 128)):
        nb = -(-n // tile)
        seen = []
        for rank in range(world):
            t0, count = sym_plan.sym_tile_chunk(n, world, rank, tile)
            for bi, first, last in sym_plan.upper_tile_rows(nb, t0, count):
                seen += [(bi, bj) for bj in range(first, last + 1)]
            assert count >= nb * (nb + 1) // 2 // world
        assert seen == [(i, j) for i in range(nb) for j in range(i, nb)]
    for nb in (1, 3, 8, 16):
        seen = []
        for rank in range(world):
            p0, count = sym_plan.panel_chunk(nb, world, rank)
            seen += sym_plan.panel_pairs(nb)[p0:p0 + count]
        assert seen == sym_plan.panel_pairs(nb)
    assert sym_plan.sym_tile(16) == 64 and sym_plan.sym_tile(17) == 32
    # The composed kernels' tile follows the instance that serves m: the
    # micro-tile body's 128 at m = 1-8 and 11, the instance of 16's 32 at
    # m = 9, 10 and 12.
    assert [sym_plan.sym_tile(m, terms=True) for m in (8, 9, 10, 11, 12, 13)] \
        == [128, 32, 32, 128, 32, 32]
    assert sym_plan.sym_tile(50) == 32 and sym_plan.sym_tile(9) == 64


@pytest.mark.parametrize("m,side", [
    (1, 128), (2, 128), (3, 128), (4, 128), (5, 128), (6, 128), (7, 128),
    (8, 128), (9, 64), (10, 64), (11, 128), (12, 64), (16, 64), (50, 32),
])
def test_single_rbf_tile_follows_the_micro_widths(m, side):
    """One RBF's triangle tile (``SymTile``): the micro-tile body's 128 at
    m = 1-8 and 11, the one-row-a-thread body's 64 up to the instance of 16
    and 32 above; the composed kernels' tile is the same at the micro
    widths."""
    assert sym_plan.sym_tile(m) == side
    if side == sym_plan.MICRO_TILE:
        assert sym_plan.sym_tile(m, terms=True) == side


def tile_pairs(n, side, bi, bj):
    """Unordered pairs (diagonal included) of tile (bi, bj): j >= i on a
    diagonal tile, rows and columns below n."""
    rows = max(0, min(side, n - bi * side))
    cols = max(0, min(side, n - bj * side))
    return rows * (rows + 1) // 2 if bi == bj else rows * cols


@pytest.mark.parametrize("world", range(1, 9))
def test_terms_chunks_cover_each_pair_once_at_every_m(world):
    """The composed triangle kernel's work list at every m = 1-64 (128
    particles a side where the micro-tile body serves m, 32 elsewhere):
    the ranks' ranges cover each tile pair once, in order, and so each of
    the n (n + 1) / 2 unordered pairs; ranks differ by at most one tile."""
    sides = {}
    for m in range(1, 65):
        side = sym_plan.sym_tile(m, terms=True)
        assert side == (128 if m <= 8 or m == 11 else 32), m
        sides.setdefault(side, []).append(m)
    assert sorted(sides) == [32, 128]
    for side in sides:
        for n in (127, 1000, 10007):
            nb = -(-n // side)
            seen, pairs, counts = [], 0, []
            for rank in range(world):
                t0, count = sym_plan.sym_tile_chunk(n, world, rank, side)
                counts.append(count)
                for bi, first, last in sym_plan.upper_tile_rows(nb, t0,
                                                                count):
                    for bj in range(first, last + 1):
                        seen.append((bi, bj))
                        pairs += tile_pairs(n, side, bi, bj)
            assert seen == [(i, j) for i in range(nb) for j in range(i, nb)]
            assert pairs == n * (n + 1) // 2
            assert max(counts) - min(counts) <= 1


# ----------------------------------------------------------------------
# Chunk sweeps
# ----------------------------------------------------------------------


def f32_inputs(n, m, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, m)) * 2 + 1.0).astype(np.float32)
    s = rng.normal(size=(n, m)).astype(np.float32)
    return x, s


def jax_chunks_summed(fn, d, per, pi, pj_, **kw):
    outs = None
    for c in range(d):
        res = fn(jnp.asarray(pi[c * per:(c + 1) * per]),
                 jnp.asarray(pj_[c * per:(c + 1) * per]), **kw)
        outs = res if outs is None else tuple(a + b for a, b in zip(outs, res))
    return outs


def torch_chunks_summed(fn, world):
    acc = upper = None
    for rank in range(world):
        a, u = fn(rank)
        acc = a if acc is None else acc + a
        upper = u if upper is None else upper + u
    return acc, upper


def check_vs_jax(phi, counts, ref_phi, ref_cnt):
    ref_phi = np.asarray(ref_phi)
    rel = np.abs(phi.numpy() - ref_phi).max() / np.abs(ref_phi).max()
    assert rel < 5e-6, rel
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(ref_cnt).astype(np.int64))


@pytest.mark.parametrize("world", [2, 4])
def test_k4_chunks_vs_jax_sym_sharded_interpret(world):
    n, m, d = 1000, 2, 4
    x, s = f32_inputs(n, m, 1)
    thr = np.asarray([1.0, 5.0], np.float32)
    g = np.float32(0.6)
    pi, pj_, n_pad, per = pj.sym_pairs_plan(n, d, 64, 128)
    acc_j, lanes = jax_chunks_summed(
        lambda a, b: pj.phi_rbf_fused_pallas_sym_sharded(
            jnp.asarray(x), jnp.asarray(s), g, jnp.asarray(thr), a, b,
            n_pad=n_pad, num_thresholds=2, tile_i=64, tile_j=128,
            interpret=True),
        d, per, pi, pj_,
    )
    center = jnp.mean(jnp.asarray(x), axis=0)
    ref_phi = pj.phi_rbf_fused_sym_finish(acc_j[:, :n], jnp.asarray(s),
                                          jnp.asarray(x), center, g, n)
    ref_cnt = 2.0 * jnp.sum(lanes, axis=1) - n
    xt, stt, thr_t = (torch.from_numpy(a) for a in (x, s, thr))
    acc, upper = torch_chunks_summed(
        lambda r: pht.phi_rbf_sym_chunk_counts(xt, stt, torch.tensor(g),
                                               thr_t, world, r), world)
    phi = pht.phi_rbf_fused_sym_finish(acc, stt, torch.tensor(g), n)
    check_vs_jax(phi, 2 * upper - n, ref_phi, ref_cnt)


#: Past DIFF_FORM_MAX_M the JAX sharded kernel in interpret mode builds sq
#: by its bf16x3 Gram branch, whose sq keeps a residue of about 2^-16 (the
#: kernel's own note): its phi stands 9.2e-5 (m = 5) and 2.1e-5 (m = 11)
#: of max |phi| from the float64 plain sweep on these inputs, the plain
#: chunks 9.7e-7 and 6.4e-7, and its counts 2 off at one threshold (one
#: pair across it). Twice those readings: the JAX kernel's phi limit and
#: count slack at those widths.
JAX_GRAM_PHI_REL = 2e-4
JAX_GRAM_COUNT_SLACK = 4


@pytest.mark.parametrize("m,world", [(2, 3), (2, 8), (3, 5), (5, 3),
                                     (11, 5)])
def test_k4_chunk_wrappers_vs_jax_sym_sharded_interpret(m, world):
    """K4's wrapper on CPU tensors (its plain chunk over the tile list of
    128 particles a side), summed over the ranks, against the JAX sharded
    kernel summed over 4 devices in interpret mode; at n = 1000 the list
    holds 36 tile pairs, so world 8 cuts tile rows. Both are also held to
    the float64 plain sweep: the chunks within 5e-6 of max |phi| and with
    its counts, at every m; past DIFF_FORM_MAX_M, where the two forms of sq
    differ, the JAX kernel within JAX_GRAM_PHI_REL and JAX_GRAM_COUNT_SLACK
    of it and of the chunks."""
    n, d = 1000, 4
    assert sym_plan.sym_tile(m) == 128
    x, s = f32_inputs(n, m, 10 + m)
    thr = np.asarray([1.0, 5.0, 2.0 * m], np.float32)
    g = np.float32(0.4)
    pi, pj_, n_pad, per = pj.sym_pairs_plan(n, d, 64, 128)
    acc_j, lanes = jax_chunks_summed(
        lambda a, b: pj.phi_rbf_fused_pallas_sym_sharded(
            jnp.asarray(x), jnp.asarray(s), g, jnp.asarray(thr), a, b,
            n_pad=n_pad, num_thresholds=3, tile_i=64, tile_j=128,
            interpret=True),
        d, per, pi, pj_,
    )
    center = jnp.mean(jnp.asarray(x), axis=0)
    ref_phi = pj.phi_rbf_fused_sym_finish(acc_j[:, :n], jnp.asarray(s),
                                          jnp.asarray(x), center, g, n)
    ref_cnt = 2.0 * jnp.sum(lanes, axis=1) - n
    xt, stt, thr_t = (torch.from_numpy(a) for a in (x, s, thr))
    cuda_phi.reset_launch_counts()
    acc, upper = torch_chunks_summed(
        lambda r: cuda_phi.phi_rbf_fused_sym_chunk_cuda(
            xt, stt, torch.tensor(g), thr_t, world, r), world)
    assert not any(cuda_phi.launch_counts.values())
    phi = pht.phi_rbf_fused_sym_finish(acc, stt, torch.tensor(g), n)
    phi64, cnt64 = pht.phi_rbf_fused_counts(
        xt.double(), stt.double(), torch.tensor(float(g), dtype=torch.float64),
        thr_t.double())
    scale = phi64.abs().max().item()
    assert (phi.double() - phi64).abs().max().item() / scale < 5e-6
    np.testing.assert_array_equal((2 * upper - n).numpy(), cnt64.numpy())
    if m <= sym_plan.DIFF_FORM_MAX_M:
        check_vs_jax(phi, 2 * upper - n, ref_phi, ref_cnt)
        return
    ref_phi = np.asarray(ref_phi)
    ref_cnt = np.asarray(ref_cnt).astype(np.int64)
    assert np.abs(ref_phi - phi64.numpy()).max() / scale < JAX_GRAM_PHI_REL
    assert np.abs(phi.numpy() - ref_phi).max() / scale < JAX_GRAM_PHI_REL
    assert np.abs(ref_cnt - cnt64.numpy()).max() <= JAX_GRAM_COUNT_SLACK


@pytest.mark.parametrize("impl", ["k11", "k10"])
def test_k10_k11_chunks_vs_jax_terms_sym_sharded_interpret(impl):
    n, m, d, world = 900, 2, 4, 3
    x, s = f32_inputs(n, m, 2)
    thr = np.asarray([1.0, 5.0], np.float32)
    gs = (np.float32(0.6), np.float32(0.15))
    sg = (1.0, 1.0)
    pi, pj_, n_pad, per = pj.sym_pairs_plan(n, d, 64, 128)
    args = (jnp.asarray(x), jnp.asarray(s), [jnp.float32(g) for g in gs], sg,
            jnp.asarray(thr))
    kw = dict(n_pad=n_pad, num_thresholds=2, tile_i=64, tile_j=128,
              interpret=True)
    center = jnp.mean(jnp.asarray(x), axis=0)
    if impl == "k11":
        acck, accw, lanes = jax_chunks_summed(
            lambda a, b: pj.phi_rbf_terms_fused_pallas_sym_sharded(
                *args, a, b, **kw), d, per, pi, pj_)
        ref_phi = pj.phi_rbf_terms_fused_sym_finish(
            acck[:, :n], accw[:, :n], jnp.asarray(s), jnp.asarray(x), center,
            jnp.stack([jnp.float32(g) for g in gs]), sg, n)
    else:
        acc_j, lanes = jax_chunks_summed(
            lambda a, b: pj.phi_rbf_terms_fused_pallas_sym_sharded_direct(
                *args, a, b, **kw), d, per, pi, pj_)
        ref_phi = pj.phi_rbf_terms_fused_sym_direct_finish(
            acc_j[:, :n], jnp.asarray(s), jnp.asarray(x), center,
            jnp.stack([jnp.float32(g) for g in gs]), sg, n)
    ref_cnt = 2.0 * jnp.sum(lanes, axis=1) - n
    xt, stt, thr_t = (torch.from_numpy(a) for a in (x, s, thr))
    gt = [torch.tensor(g) for g in gs]
    acc, upper = torch_chunks_summed(
        lambda r: pht.phi_rbf_terms_sym_chunk_counts(xt, stt, gt, sg, thr_t,
                                                     world, r), world)
    phi = pht.phi_rbf_terms_fused_sym_finish(acc, stt, sg, n)
    check_vs_jax(phi, 2 * upper - n, ref_phi, ref_cnt)


def test_k5_chunks_vs_jax_sympanel_sharded_interpret():
    n, m, d, world = 2100, 2, 8, 4
    x, s = f32_inputs(n, m, 3)
    thr = np.asarray([1.0, 5.0], np.float32)
    g = np.float32(0.7)
    pi, pj_, nb, w, n_pad, per = pj.sym_panel_sharded_plan(n, m, d, 64, 128)
    acc_j, lanes = jax_chunks_summed(
        lambda a, b: pj.phi_rbf_fused_pallas_sympanel_sharded(
            jnp.asarray(x), jnp.asarray(s), g, jnp.asarray(thr), a, b, nb=nb,
            w=w, num_thresholds=2, tile_i=64, tile_j=128, interpret=True),
        d, per, pi, pj_,
    )
    center = jnp.mean(jnp.asarray(x), axis=0)
    ref_phi = pj.phi_rbf_fused_sym_finish(acc_j[:, :n], jnp.asarray(s),
                                          jnp.asarray(x), center, g, n)
    ref_cnt = 2.0 * jnp.sum(lanes, axis=1) - n
    xt, stt, thr_t = (torch.from_numpy(a) for a in (x, s, thr))
    acc, upper = torch_chunks_summed(
        lambda r: pht.phi_rbf_sympanel_chunk_counts(
            xt, stt, torch.tensor(g), thr_t, world, r, panel_blocks=5),
        world)
    phi = pht.phi_rbf_fused_sym_finish(acc, stt, torch.tensor(g), n)
    check_vs_jax(phi, 2 * upper - n, ref_phi, ref_cnt)


@pytest.mark.parametrize("world", [3, 4, 8])
def test_chunk_wrappers_on_cpu_vs_k2_k3_plain_f64(world):
    """The CUDA chunk wrappers on CPU tensors, summed over the ranks, give
    the full-width and panel triangles' phi and counts; at n = 100 the tile
    list has 3 tiles, so 8 ranks leave five ranges empty."""
    cuda_phi.reset_launch_counts()
    for n, m in ((100, 2), (301, 2), (301, 6)):
        rng = np.random.default_rng(n + m)
        x = torch.from_numpy(rng.normal(size=(n, m)) * 2.0 + 5.0)
        s = torch.from_numpy(rng.normal(size=(n, m)))
        thr = torch.tensor([0.5, 3.0, 2.0 * m, 40.0], dtype=torch.float64)
        g = torch.tensor(0.35, dtype=torch.float64)
        want_phi, want_cnt = pht.phi_rbf_fused_counts(x, s, g, thr)
        acc, upper = torch_chunks_summed(
            lambda r: cuda_phi.phi_rbf_fused_sym_chunk_cuda(x, s, g, thr,
                                                            world, r), world)
        phi = pht.phi_rbf_fused_sym_finish(acc, s, g, n)
        np.testing.assert_allclose(phi.numpy(), want_phi.numpy(), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_array_equal((2 * upper - n).numpy(),
                                      want_cnt.numpy())
        for blocks in (3, 8):
            acc, upper = torch_chunks_summed(
                lambda r: cuda_phi.phi_rbf_sympanel_chunk_cuda(
                    x, s, g, thr, world, r, panel_blocks=blocks), world)
            phi = pht.phi_rbf_fused_sym_finish(acc, s, g, n)
            want = pht.phi_rbf_sympanel_fused_counts(x, s, g, thr,
                                                     panel_blocks=blocks)
            np.testing.assert_allclose(phi.numpy(), want[0].numpy(),
                                       rtol=1e-10, atol=1e-12)
            np.testing.assert_array_equal((2 * upper - n).numpy(),
                                          want[1].numpy())
        gs, signs = [g, torch.tensor(0.05, dtype=torch.float64)], (1.0, -0.4)
        want_phi, want_cnt = pht.phi_rbf_terms_fused_counts(x, s, gs, signs,
                                                            thr)
        acc, upper = torch_chunks_summed(
            lambda r: cuda_phi.phi_rbf_terms_fused_sym_chunk_cuda(
                x, s, gs, signs, thr, world, r), world)
        phi = pht.phi_rbf_terms_fused_sym_finish(acc, s, signs, n)
        np.testing.assert_allclose(phi.numpy(), want_phi.numpy(), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_array_equal((2 * upper - n).numpy(),
                                      want_cnt.numpy())
    assert not any(cuda_phi.launch_counts.values())
    for name in (cuda_phi.SYM_CHUNK_KERNEL, cuda_phi.TERMS_SYM_CHUNK_KERNEL,
                 cuda_phi.SYMPANEL_CHUNK_KERNEL, cuda_phi.COUNT_KERNEL):
        assert name in cuda_phi.launch_counts


def test_chunk_wrappers_never_fall_back():
    x = torch.empty((8, 2), device="meta")
    thr = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_phi.phi_rbf_fused_sym_chunk_cuda(x, x, 0.5, thr, 2, 0)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_phi.phi_rbf_terms_fused_sym_chunk_cuda(x, x, [0.5], (1,), thr,
                                                    2, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_phi.phi_rbf_sympanel_chunk_cuda(x, x, 0.5, thr, 2, 0)
    with pytest.raises(ValueError, match="rank"):
        cuda_phi.phi_rbf_fused_sym_chunk_cuda(x, x, 0.5, thr, 2, 2)
    assert not cuda_phi.library_loaded()


# ----------------------------------------------------------------------
# Collective building blocks (one rank)
# ----------------------------------------------------------------------


def test_sharded_median_matches_exact(group):
    coords = torch.from_numpy(np.random.default_rng(42).normal(size=(64, 3)))
    local = place_sharded(coords, group)
    med = sharded_pairwise_median(local, coords, group, bins=512, passes=3,
                                  row_tile=16)
    exact = float(pairwise_distance_median_exact(coords))
    assert abs(float(med) - exact) <= 1e-6 * exact


def test_sharded_phi_matches_dense(group):
    """This rank's rows against the gathered sources: the JAX package's
    dense phi (test_sharded.py's cross-shard blocks)."""
    rng = np.random.default_rng(43)
    coords, scores = rng.normal(size=(40, 3)), rng.normal(size=(40, 3))
    p_mat = np.eye(3) * 0.7 + 0.1
    local = place_sharded(coords, group)
    sources = group.all_gather_rows(local)
    scores_all = group.all_gather_rows(place_sharded(scores, group))
    got = pht.phi_rbf_cross(local, sources, scores_all,
                            torch.from_numpy(p_mat), row_tile=4)
    want = phj.phi_rbf(jnp.asarray(coords), jnp.asarray(scores),
                       jnp.asarray(p_mat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


def test_sharded_count_env_equals_single_device(group):
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(90, 2)) + 7.0)
    thr = torch.tensor([0.5, 2.0, 8.0], dtype=torch.float64)
    fn_1, hi_1 = centered_count_env(x)
    fn_g, hi_g = centered_count_env(x, x, group=group, n_global=90)
    np.testing.assert_array_equal(fn_g(thr).numpy(), fn_1(thr).numpy())
    assert float(hi_g) == pytest.approx(float(hi_1), rel=1e-12)


# ----------------------------------------------------------------------
# The engine, one rank, against the JAX engine on the 8-device mesh
# ----------------------------------------------------------------------


def run_both(group, mesh, x0, iters, config, *, kernel=None, model=None,
             optimizer=None, jax_config=None):
    """(port, JAX) gathered coordinates after ``iters`` steps from x0."""
    n, dim = x0.shape
    model = model or (lambda pkg: pkg.MultivariateNormal(MEAN, COV))
    optimizer = optimizer or (lambda pkg: pkg.AdaGrad(dim, n, 0.1))
    outs = []
    for pkg, engine, cfg_cls, where in ((st, ShardedSVGD, ShardedSVGDConfig,
                                         group),
                                        (sv, JaxSharded, JaxConfig, mesh)):
        cfg = dict(config)
        if pkg is sv and jax_config is not None:
            cfg = jax_config
        if "scale_method" in cfg:
            cfg["scale_method"] = pkg.ScaleMethod[cfg["scale_method"]]
        mdl = model(pkg)
        eng = engine(mdl, optimizer(pkg), num_particles=n, dimension=dim,
                     mesh=where, config=cfg_cls(**cfg),
                     kernel=None if kernel is None else kernel(pkg, mdl))
        outs.append(np.asarray(eng.run(x0.copy(), iters)))
    return outs


@pytest.mark.parametrize("method", ["MEDIAN", "HESSIAN"])
def test_cold_run_matches_jax_engine(group, mesh, method):
    x0 = np.random.default_rng(42).normal(size=(32, 2)) * 2
    got, want = run_both(group, mesh, x0, 10, dict(
        scale_method=method, median_bins=1024, median_passes=4, row_tile=4,
        warm_start=False))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_bounds(group):
    x0 = np.random.default_rng(1).normal(size=(16, 2)) * 5
    eng = ShardedSVGD(
        st.MultivariateNormal(np.zeros(2), np.eye(2)), st.AdaGrad(2, 16, 0.1),
        16, 2, mesh=group, config=ShardedSVGDConfig(
            scale_method=st.ScaleMethod.CONSTANT, constant_scale=np.eye(2),
            lower_bound=np.array([-1.0, -1.0]), upper_bound=[1.0, 1.0]),
    )
    out = eng.run(x0, 5).numpy()
    assert np.abs(out).max() <= 1.0 + 1e-12


def test_uneven_shard_raises():
    model = st.MultivariateNormal(np.zeros(2), np.eye(2))
    with pytest.raises(st.DimensionMismatchError):
        ShardedSVGD(model, st.AdaGrad(2, 30, 0.1), 30, 2,
                    mesh=fake_group(8))


def test_warm_start_matches_jax_and_is_deterministic(group, mesh):
    x0 = np.random.default_rng(2).normal(size=(32, 2)) * 2
    cfg = dict(median_bins=16, median_passes=4, row_tile=4)
    got, want = run_both(group, mesh, x0, 15, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    again, _ = run_both(group, mesh, x0, 15, cfg)
    np.testing.assert_array_equal(got, again)
    cold, _ = run_both(group, mesh, x0, 15, dict(cfg, warm_start=False))
    assert np.abs(got - cold).max() < 5e-2


def test_adam_matches_jax(group, mesh):
    x0 = np.random.default_rng(3).normal(size=(16, 2))
    got, want = run_both(
        group, mesh, x0, 5, dict(median_passes=4, row_tile=4),
        model=lambda pkg: pkg.MultivariateNormal(np.zeros(2), np.eye(2)),
        optimizer=lambda pkg: pkg.Adam(2, 16, 0.1, 0.9, 0.999),
    )
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_config_validation():
    with pytest.raises(ValueError):
        ShardedSVGDConfig(phi_mode="rings")
    with pytest.raises(ValueError):
        ShardedSVGDConfig(scale_method=st.ScaleMethod.CONSTANT)
    with pytest.raises(ValueError):
        ShardedSVGDConfig(fused_phi=True, scale_method=st.ScaleMethod.HESSIAN)
    with pytest.raises(ValueError, match="fused_sym=True requires"):
        ShardedSVGDConfig(fused_sym=True)
    with pytest.raises(ValueError, match="fused_cuda"):
        ShardedSVGDConfig(fused_phi=True, fused_pallas=True)
    with pytest.raises(ValueError, match="fused_sym"):
        ShardedSVGDConfig(fused_phi=True, fused_sym="triangle")


def test_unported_options_raise_naming_the_roadmap():
    model = st.MultivariateNormal(np.zeros(2), np.eye(2))
    g = fake_group(1)

    def build(config=None, kernel=None, mdl=model):
        return ShardedSVGD(mdl, st.AdaGrad(2, 16, 0.1), 16, 2, mesh=g,
                           config=config, kernel=kernel)

    with pytest.raises(NotImplementedError, match="item 11"):
        build(ShardedSVGDConfig(phi_mode="ring"))
    with pytest.raises(NotImplementedError, match="item 12"):
        build(ShardedSVGDConfig(log_intermediate_matrices=True))
    with pytest.raises(NotImplementedError, match="item 15"):
        build(ShardedSVGDConfig(fused_dot_dtype="bfloat16"))
    x0 = np.zeros((16, 2))
    kernel = st.GaussianRBFKernel(x0, st.ScaleMethod.CONSTANT,
                                  constant_scale=np.eye(2))
    with pytest.raises(NotImplementedError, match="item 9a"):
        build(ShardedSVGDConfig(kernel_phi="generic"), kernel)

    class Hooked(st.MultivariateNormal):
        def step(self):
            pass

    with pytest.raises(NotImplementedError, match="item 12"):
        build(mdl=Hooked(np.zeros(2), np.eye(2)))


def test_fused_sym_resolution():
    """The JAX decision with the group's world size; on the CPU the CUDA
    sweep is off by default, and forced forms need it."""
    model = st.MultivariateNormal(np.zeros(2, np.float32),
                                  np.eye(2, dtype=np.float32))

    def resolve(n, world=1, **cfg):
        return ShardedSVGD(
            model, st.AdaGrad(2, n, 0.1), n, 2, mesh=fake_group(world),
            config=ShardedSVGDConfig(fused_phi=True, **cfg),
        )._fused_sym

    assert resolve(4096) is False  # CPU: fused_cuda resolves False
    with pytest.raises(ValueError, match="fused_sym"):
        resolve(4096, fused_sym=True)
    with pytest.raises(ValueError, match="fused_cuda"):
        resolve(4096, fused_sym="full")
    for n, world in ((10240, 1), (10240, 8), (4096, 2)):
        want = "full" if pj.sym_sharded_plan(n, 2, world) else False
        assert resolve(n, world, fused_cuda=True) == want == "full"
    assert resolve(262144, 4, fused_cuda=True) == "panel"
    assert resolve(1024, 2, fused_cuda=True) is False
    with pytest.raises(ValueError, match="fused_sym=True"):
        resolve(1024, 2, fused_cuda=True, fused_sym=True)
    assert resolve(64, 2, fused_cuda=True, fused_sym="panel") == "panel"
    assert resolve(64, 2, fused_cuda=True, fused_sym=False) is False


def test_annealing_matches_jax(group, mesh):
    x0 = np.random.default_rng(4).normal(size=(16, 2)) * 2
    cfg = dict(median_passes=4, row_tile=4)
    model = lambda pkg: pkg.MultivariateNormal(np.zeros(2), np.eye(2))  # noqa: E731
    plain, _ = run_both(group, mesh, x0, 10, cfg, model=model)
    ones, _ = run_both(group, mesh, x0, 10, dict(cfg, annealing=np.ones(10)),
                       model=model)
    np.testing.assert_allclose(plain, ones, rtol=1e-12)
    ramp = dict(cfg, annealing=np.linspace(0.1, 1.0, 10))
    got, want = run_both(group, mesh, x0, 10, ramp, model=model)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    assert not np.allclose(got, plain)
    ramp_fn = dict(cfg, annealing=lambda it: 0.1 + 0.9 * it / 9)
    got_fn, _ = run_both(group, mesh, x0, 10, ramp_fn, model=model,
                         jax_config=ramp)
    np.testing.assert_allclose(got_fn, got, rtol=1e-9)


def test_track_stats_and_continuation(group):
    """Stats per step, appended by a continued run; run(x0) then
    run(None) equals one uninterrupted run (Adam's moments and the
    iteration count carry over)."""
    x0 = np.random.default_rng(5).normal(size=(16, 2)) * 3

    def make(**cfg):
        return ShardedSVGD(
            st.MultivariateNormal(np.zeros(2), np.eye(2)),
            st.Adam(2, 16, 0.1, 0.9, 0.999), 16, 2, mesh=group,
            config=ShardedSVGDConfig(median_passes=4, row_tile=4, **cfg),
        )

    eng = make(track_stats=True)
    eng.run(x0, 6)
    assert set(eng.stats) == {"phi_rms", "step_max", "bandwidth"}
    assert all(v.shape == (6,) for v in eng.stats.values())
    assert (eng.stats["bandwidth"] > 0).all()
    eng.run(None, 4)
    assert all(v.shape == (10,) for v in eng.stats.values())
    assert eng._state["iteration"] == 10
    split = make()
    split.run(x0, 3)
    np.testing.assert_array_equal(split.run(None, 3).numpy(),
                                  make().run(x0, 6).numpy())


@pytest.mark.parametrize("bimodal", [False, True])
def test_fused_matches_jax_fused(group, mesh, bimodal):
    rng = np.random.default_rng(6)
    if bimodal:
        x0 = np.concatenate([0.3 * rng.normal(size=(16, 2)),
                             0.3 * rng.normal(size=(16, 2)) + [8.0, 0.0]])

        def model(pkg):
            return (pkg.MultivariateNormal(np.zeros(2), np.eye(2))
                    + pkg.MultivariateNormal(np.array([8.0, 0.0]), np.eye(2)))
    else:
        x0 = rng.normal(size=(32, 2)) * 2
        model = None
    got, want = run_both(group, mesh, x0, 12, dict(row_tile=4, fused_phi=True),
                         model=model)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("form", ["full", "panel"])
def test_forced_triangle_schedules_match_jax_fused_cross(group, mesh, form):
    """fused_sym "full" / "panel" run the plain chunk schedules on the CPU
    (fused_cuda=True): the same function as the JAX fused cross engine."""
    x0 = np.random.default_rng(7).normal(size=(96, 2)) * 2
    cfg = dict(row_tile=16, fused_phi=True)
    got, want = run_both(group, mesh, x0, 10,
                         dict(cfg, fused_cuda=True, fused_sym=form),
                         jax_config=cfg)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def composed(x0, extra=0.25):
    def build(pkg, mdl):
        return pkg.GaussianRBFKernel(
            x0, pkg.ScaleMethod.MEDIAN, mdl, median_method="exact"
        ) + pkg.GaussianRBFKernel(
            x0, pkg.ScaleMethod.CONSTANT,
            constant_scale=extra * np.eye(x0.shape[1]),
        )
    return build


@pytest.mark.parametrize("fused", [False, True])
def test_composed_kernel_matches_jax(group, mesh, fused):
    x0 = np.random.default_rng(8).normal(size=(32, 2)) * 2
    cfg = (dict(row_tile=4, fused_phi=True) if fused else
           dict(median_bins=1024, median_passes=4, row_tile=4,
                warm_start=False, kernel_phi="rbf_terms"))
    got, want = run_both(group, mesh, x0, 8, cfg, kernel=composed(x0))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
    if fused:  # the terms triangle schedule (K10/K11's plain version)
        got, _ = run_both(group, mesh, x0, 8,
                          dict(cfg, fused_cuda=True, fused_sym="full"),
                          kernel=composed(x0), jax_config=cfg)
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_fused_hotswap_rejects_anisotropic(group):
    x0 = np.random.default_rng(9).normal(size=(16, 2)) * 2
    model = st.MultivariateNormal(np.zeros(2), np.eye(2))
    kernel = composed(x0)(st, model)
    eng = ShardedSVGD(model, st.AdaGrad(2, 16, 0.1), 16, 2, mesh=group,
                      kernel=kernel,
                      config=ShardedSVGDConfig(fused_phi=True, row_tile=4))
    params = list(kernel.parameters)
    params[1] = np.diag([0.3, 0.1])
    with pytest.raises(ValueError, match="isotropic"):
        eng.update_kernel_parameters(tuple(params))


def test_constant_scale_f32_coords(group):
    x0 = np.random.default_rng(10).normal(size=(16, 2)).astype(np.float32)
    eng = ShardedSVGD(
        st.MultivariateNormal(np.zeros(2, np.float32),
                              np.eye(2, dtype=np.float32)),
        st.AdaGrad(2, 16, 0.1), 16, 2, mesh=group,
        config=ShardedSVGDConfig(scale_method=st.ScaleMethod.CONSTANT,
                                 constant_scale=np.eye(2), row_tile=4),
    )
    out = eng.run(x0, 3)
    assert out.dtype == torch.float32 and bool(out.isfinite().all())


# ----------------------------------------------------------------------
# State carried over from the JAX engine
# ----------------------------------------------------------------------


def test_sharded_state_split_steps_as_jax(group, mesh):
    """One JAX sharded state, split per rank, steps as the JAX engine: the
    rank-0-of-1 split here, and the rows of every rank of 4 cover the
    global arrays."""
    x0 = np.random.default_rng(12).normal(size=(32, 2)) * 2
    cfg = dict(row_tile=4, fused_phi=True)
    j = JaxSharded(sv.MultivariateNormal(MEAN, COV),
                   sv.Adam(2, 32, 0.1, 0.9, 0.999), 32, 2, mesh=mesh,
                   config=JaxConfig(**cfg))
    state_j = j.run_state(j.init_state(x0), 3)
    np_state = jax.device_get(state_j)
    want = np.asarray(j.run_state(state_j, 2)["coords"])
    t = ShardedSVGD(st.MultivariateNormal(MEAN, COV),
                    st.Adam(2, 32, 0.1, 0.9, 0.999), 32, 2, mesh=group,
                    config=ShardedSVGDConfig(**cfg))
    state_t = sharded_state_from_numpy(np_state, t.optimizer, 0, 1,
                                       device="cpu")
    assert state_t["iteration"] == 3
    got = t.run_state(state_t, 2)["coords"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    parts = [sharded_state_from_numpy(np_state, t.optimizer, r, 4,
                                      device="cpu") for r in range(4)]
    np.testing.assert_array_equal(
        torch.cat([p["coords"] for p in parts]).numpy(),
        np.asarray(np_state["coords"]))
    np.testing.assert_array_equal(
        torch.cat([p["opt_state"]["m"] for p in parts]).numpy(),
        np.asarray(np_state["opt_state"]["m"]))
    assert all(int(p["opt_state"]["count"]) == 3 for p in parts)


def test_state_from_numpy_follows_the_device_rule(monkeypatch):
    """Its default is the card, as every entry point's: without one it
    raises unless the caller asks for the CPU."""
    kernel_x = np.zeros((4, 2))
    np_state = {
        "coords": kernel_x, "opt_state": {"h": kernel_x},
        "kernel_params": (np.eye(2),), "model_params": (np.zeros(2),),
        "scale_aux": (None,), "slot_model_params": (),
        "iteration": np.int32(2),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        state_from_numpy(np_state)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sharded_state_from_numpy(np_state, st.AdaGrad(2, 4, 0.1), 0, 2)
    state = state_from_numpy(np_state, device="cpu")
    assert state["coords"].device.type == "cpu" and state["iteration"] == 2


# ----------------------------------------------------------------------
# Two and four ranks, spawned
# ----------------------------------------------------------------------


def jax_reference(name, composed_kernel, cfg, x0):
    """The JAX engine's run of a worker case (its fused cross engine for
    the forced triangle forms)."""
    cfg = {k: v for k, v in cfg.items()
           if k not in ("fused_cuda", "fused_sym")}
    model = sv.MultivariateNormal(MEAN, COV)
    kernel = None
    if composed_kernel:
        kernel = composed(x0)(sv, model)
    n, dim = x0.shape
    j = JaxSharded(model, sv.AdaGrad(dim, n, 0.1), n, dim,
                   mesh=make_particle_mesh(), kernel=kernel,
                   config=JaxConfig(**cfg))
    return np.asarray(j.run(x0.copy(), 10))


@pytest.mark.parametrize("world", [2, 4])
def test_spawned_ranks_match_jax_engine(world, tmp_path):
    sys.path.insert(0, str(Path(__file__).parent))
    try:
        import torch_sharded_worker as worker
    finally:
        sys.path.pop(0)
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(worker.__file__)), str(rank),
             str(world), str(port), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO,
        )
        for rank in range(world)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank}: OK" in out
    got = np.load(tmp_path / f"torch_sharded_{world}.npz")
    x0 = worker.x0()
    for name, (composed_kernel, cfg) in worker.cases().items():
        want = jax_reference(name, composed_kernel, cfg, x0)
        np.testing.assert_allclose(got[name], want, rtol=1e-8, atol=1e-10,
                                   err_msg=name)


def test_sharded_builders_match_the_drivers(group):
    """The sharded example's flagship and the hierarchical BLR on one rank
    against the single-device drivers' fused routes (float64, the plain
    sweeps on the CPU): the same lag-1 pipeline from the same seed."""
    from svgdcpp_tpu_torch.utils.workloads import (
        blr_workload,
        build_blr_svgd,
        build_mvn_svgd,
        build_sharded_hier_svgd,
        build_sharded_mvn_svgd,
        flagship_mvn,
    )

    mean, cov, x0 = flagship_mvn(600)
    eng = build_sharded_mvn_svgd(x0, mean, cov, group)
    assert eng.config.fused_phi and eng._fused_sym is False
    drv = build_mvn_svgd(x0, mean, cov, phi_impl="fused", num_iterations=5,
                         device="cpu")
    np.testing.assert_allclose(eng.run(x0, 5).numpy(), drv.run().numpy(),
                               rtol=1e-9, atol=1e-12)
    feats, labels, xh = blr_workload(640, 5, hierarchical=True)
    xh = xh.astype(np.float64)
    eng = build_sharded_hier_svgd(xh, feats, labels, group)
    drv = build_blr_svgd(xh, feats, labels, hierarchical=True,
                         phi_impl="fused_terms", num_iterations=5,
                         device="cpu")
    np.testing.assert_allclose(eng.run(xh, 5).numpy(), drv.run().numpy(),
                               rtol=1e-9, atol=1e-12)
