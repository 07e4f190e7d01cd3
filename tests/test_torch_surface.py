"""svgdcpp_tpu_torch's surface where it used to differ from svgdcpp_tpu.

* Wide m on the card: ``ops/median.count_le_cross`` sends a CUDA tensor to
  the count kernel (K16's port) at any m, as the JAX package counts at any
  m; ``auto`` on a CUDA device keeps the JAX package's TPU rule past
  ``cuda_phi.MAX_M`` (the kernel route, as the TPU takes its Mosaic one),
  and that route raises there, naming the item that widens the sweeps.
* Process groups: ``initialize_distributed`` without a rendezvous makes a
  one-rank world (torchrun's ``env://`` where its variables are set), a
  second call returns the existing group, ``make_particle_mesh`` and
  ``ShardedSVGD(mesh=None)`` need no set-up, as the JAX package's do.
* The top-level ``__all__`` is the JAX package's, less the names not
  ported yet.
"""

import socket
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import svgdcpp_tpu as sv
import svgdcpp_tpu_torch as st
from svgdcpp_tpu_torch.ops import cuda_phi
from svgdcpp_tpu_torch.ops import median as median_t
from svgdcpp_tpu_torch.parallel import ShardedSVGD, ShardedSVGDConfig
from svgdcpp_tpu_torch.parallel import mesh as mesh_t
from svgdcpp_tpu_torch.parallel import sharded as sharded_t

torch.set_num_threads(1)

#: Public names of the JAX package the port does not export yet (ROADMAP
#: items 9b and 12b).
NOT_PORTED = {"BinomialLikelihood", "OptaxOptimizer"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def no_group():
    """No process group before the test, and none left after it."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# Wide m on the card
# ----------------------------------------------------------------------


@pytest.mark.parametrize("m,route", [(64, "kernel"), (65, "kernel"),
                                     (100, "kernel")])
def test_count_le_cross_dispatches_by_dimension(monkeypatch, m, route):
    """A tensor off the CPU (here on the meta device, which reaches the
    same branch as a CUDA tensor) goes to the count kernel at every m: the
    kernel takes m past MAX_M, and nothing on the card falls back to the
    plain pass."""
    calls = []
    monkeypatch.setattr(cuda_phi, "count_le_cuda",
                        lambda *a, **k: calls.append("kernel"))
    monkeypatch.setattr(median_t, "count_le_plain",
                        lambda *a, **k: calls.append("plain"))
    x = torch.empty((300, m), device="meta")
    thr = torch.empty((3,), device="meta")
    median_t.count_le_cross(x, x, thr)
    assert calls == [route]
    assert cuda_phi.MAX_M == 64


@pytest.mark.parametrize("m", [64, 65, 100])
def test_count_wrapper_launches_past_max_m(monkeypatch, m):
    """count_le_cuda hands every m to the library (whose count kernel has a
    wide instance past MAX_M) instead of raising the sweeps' dimension
    error. The device is stood in for: meta tensors, a library that records
    its arguments, no stream."""
    launched = []

    class Library:
        def svgd_count_le_cross(self, rows, cols, thr, n_r, n_c, m_, t,
                                counts, stream):
            launched.append((n_r, n_c, m_, t))
            return 0

    monkeypatch.setattr(cuda_phi, "_require_cuda", lambda tensor: None)
    monkeypatch.setattr(cuda_phi, "load_library", Library)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    cuda_phi.reset_launch_counts()
    rows = torch.empty((300, m), device="meta")
    cols = torch.empty((200, m), device="meta")
    thr = torch.empty((cuda_phi.COUNT_MAX_T + 1,), device="meta")
    counts = cuda_phi.count_le_cuda(rows, cols, thr)
    assert counts.shape == (cuda_phi.COUNT_MAX_T + 1,)
    assert launched == [(300, 200, m, cuda_phi.COUNT_MAX_T), (300, 200, m, 1)]
    assert cuda_phi.launch_counts[cuda_phi.COUNT_KERNEL] == 2
    cuda_phi.reset_launch_counts()


def _drivers(n, m, seed=0):
    """The port's and the JAX package's drivers on the same MVN target,
    median RBF, auto route, on the CPU."""
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


@pytest.mark.parametrize("n,m,route", [
    (1500, 64, "fused_cuda"),
    (1500, 65, "fused_cuda"),
    (1500, 100, "fused_cuda"),
    (600, 65, "fused_cuda"),
    (200, 65, "dense"),
])
def test_auto_rule_on_cuda_past_max_m(n, m, route):
    """Auto on a CUDA device takes the kernel route at any m, as the JAX
    package's auto takes its Mosaic route on the TPU; the driver's
    dimension check then raises past MAX_M (next test) rather than
    running the plain route on the card. On the CPU both packages take
    the same route."""
    port, jax_svgd = _drivers(n, m)
    assert port._auto_impl(on_cuda=True) == route
    assert port._auto_impl(on_cuda=False) == jax_svgd._phi_impl
    assert port._phi_impl == jax_svgd._phi_impl


def test_the_kernel_routes_keep_their_dimension_check():
    """A forced kernel route past MAX_M still raises on a CUDA device (the
    driver calls check_dimension there), naming the item that widens it."""
    cuda_phi.check_dimension(cuda_phi.MAX_M)
    with pytest.raises(ValueError, match=r"1 <= m <= 64.*item 17"):
        cuda_phi.check_dimension(cuda_phi.MAX_M + 1)


# ----------------------------------------------------------------------
# Process groups
# ----------------------------------------------------------------------


def test_initialize_distributed_without_a_rendezvous(no_group):
    group = st.initialize_distributed(device="cpu")
    assert (group.rank, group.world_size, group.backend) == (0, 1, "gloo")
    assert group.device == torch.device("cpu")
    assert st.initialize_distributed() is group  # a second call
    assert st.make_particle_mesh() is group
    assert mesh_t.make_particle_group() is group


def test_initialize_distributed_under_torchrun(no_group, monkeypatch):
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                       ("MASTER_ADDR", "localhost"),
                       ("MASTER_PORT", str(free_port()))):
        monkeypatch.setenv(key, value)
    group = st.initialize_distributed(device="cpu")
    assert (group.rank, group.world_size) == (0, 1)
    assert dist.get_world_size() == 1


def test_a_larger_world_needs_a_rendezvous(no_group, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="without a rendezvous"):
        st.initialize_distributed(world_size=2, rank=0, device="cpu")
    with pytest.raises(ValueError, match="needs world_size and rank"):
        st.initialize_distributed(f"tcp://localhost:{free_port()}",
                                  device="cpu")
    assert not dist.is_initialized()


def test_make_particle_mesh_needs_no_set_up(no_group):
    group = st.make_particle_mesh(device="cpu")
    assert group.world_size == 1 and dist.is_initialized()


def test_sharded_engine_without_a_mesh(no_group, monkeypatch):
    """ShardedSVGD(mesh=None) makes a one-rank world where none exists (on
    the CPU here: the default device is the card) and steps as the engine
    on an explicit one-rank group does."""
    monkeypatch.setattr(sharded_t, "initialize_distributed",
                        lambda: mesh_t.initialize_distributed(device="cpu"))
    n, m = 64, 2
    mean = np.array([0.5, -1.0])
    cov = np.array([[1.0, 0.2], [0.2, 0.8]])
    x0 = np.random.default_rng(3).normal(size=(n, m))
    cfg = ShardedSVGDConfig(fused_phi=True)

    def run(mesh):
        engine = ShardedSVGD(st.MultivariateNormal(mean, cov),
                             st.AdaGrad(m, n, 0.1), n, m, mesh=mesh,
                             config=cfg)
        return engine, engine.run(x0, 5)

    engine, got = run(None)
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert engine.mesh.world_size == 1
    _, want = run(engine.mesh)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool(got.isfinite().all())


# ----------------------------------------------------------------------
# The top-level surface
# ----------------------------------------------------------------------


def test_all_is_the_jax_packages_less_the_unported():
    assert set(st.__all__) == set(sv.__all__) - NOT_PORTED
    assert len(st.__all__) == len(set(st.__all__))
    for name in st.__all__:
        assert getattr(st, name) is not None, name
