"""The multi-rank dry run (the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

    python -m svgdcpp_tpu_torch.parallel.dryrun [N_RANKS]   # default 8

Spawns N_RANKS gloo ranks on the CPU (a world on localhost, rendezvous on
a free port) and runs on each, at 8 particles a rank (d = 2, the flagship
MVN target), the eight parts of the JAX dry run through this package's
classes:

  1. one gather-mode step of ShardedSVGD (bounds on);
  2. a ring-mode run (``phi_mode='ring'``, warm median, Adam) of 3 steps;
  3. a composed kernel through the generic (VJP) sweep, 2 steps;
  4. the same kernel as RBF terms (``kernel_phi='rbf_terms'``), 2 steps;
  5. the fused single sweep (``fused_phi``) of the built-in RBF, 2 steps;
  6. the fused sweep of the composed kernel, 2 steps;
  7. the driver under ``SVGDOptions.mesh`` with ``phi_impl='fused'``,
     ``run()`` of 3 iterations;
  8. the fused triangle forms ``fused_sym="full"`` and ``"panel"`` with
     ``fused_cuda=True`` at n = 2048 rounded up to the world size: on CPU
     tensors the CUDA wrappers run their plain chunk versions.

Each part asserts finite coordinates of the right shape (and the
iteration count where the JAX one does); the parent prints one
``dryrun_multichip(<n>): OK`` line when every rank exited cleanly, and a
failing rank raises.
"""

from __future__ import annotations

import socket
import sys

import numpy as np
import torch
import torch.distributed as dist


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _finite(coords, shape, what):
    if tuple(coords.shape) != shape or not bool(torch.isfinite(coords).all()):
        raise AssertionError(f"{what}: coordinates {tuple(coords.shape)}, "
                             f"want {shape} and finite")


def _parts(group) -> None:
    import svgdcpp_tpu_torch as st

    from ..utils.workloads import flagship_mvn
    from .sharded import ShardedSVGD, ShardedSVGDConfig

    world = group.world_size
    n, dim = 8 * world, 2
    local = (n // world, dim)
    mean, cov, x0 = flagship_mvn(n)

    def engine(optimizer=None, kernel=None, model=None, particles=n,
               **config):
        return ShardedSVGD(
            model or st.MultivariateNormal(mean, cov),
            optimizer or st.AdaGrad(dim, particles, 0.1), particles, dim,
            mesh=group, kernel=kernel, config=ShardedSVGDConfig(**config),
        )

    def composed():
        model = st.MultivariateNormal(mean, cov)
        kernel = st.GaussianRBFKernel(
            x0, st.ScaleMethod.MEDIAN, model
        ) + st.GaussianRBFKernel(
            x0, st.ScaleMethod.CONSTANT, constant_scale=0.25 * np.eye(dim)
        )
        return model, kernel

    # 1. gather mode, one step
    eng = engine(median_passes=3, row_tile=8, lower_bound=np.full(dim, -10.0),
                 upper_bound=np.full(dim, 10.0))
    state = eng.step_state(eng.init_state(x0))
    _finite(state["coords"], local, "gather step")
    # 2. ring mode, warm median, Adam, 3 steps
    eng = engine(st.Adam(dim, n, 0.1, 0.9, 0.999), phi_mode="ring",
                 median_passes=3, row_tile=8, warm_start=True)
    state = eng.run_state(eng.init_state(x0), 3)
    _finite(state["coords"], local, "ring run")
    assert state["iteration"] == 3, state["iteration"]
    # 3. and 4. a composed kernel: the generic sweep and RBF terms
    for kernel_phi in ("generic", "rbf_terms"):
        model, kernel = composed()
        eng = engine(model=model, kernel=kernel, median_passes=3, row_tile=8,
                     kernel_phi=kernel_phi)
        state = eng.run_state(eng.init_state(x0), 2)
        _finite(state["coords"], local, f"composed {kernel_phi}")
    # 5. and 6. the fused sweep: the built-in RBF and the composed kernel
    eng = engine(fused_phi=True, median_passes=3, row_tile=8)
    _finite(eng.run_state(eng.init_state(x0), 2)["coords"], local,
            "fused RBF")
    model, kernel = composed()
    eng = engine(model=model, kernel=kernel, fused_phi=True, row_tile=8)
    _finite(eng.run_state(eng.init_state(x0), 2)["coords"], local,
            "fused terms")
    # 7. the driver under SVGDOptions.mesh
    model = st.MultivariateNormal(mean, cov)
    svgd = st.SVGD(st.SVGDOptions(
        dimension=dim, num_iterations=3, coordinate_matrix=x0,
        kernel=st.GaussianRBFKernel(x0, st.ScaleMethod.MEDIAN, model),
        model=model, optimizer=st.AdaGrad(dim, n, 0.1), mesh=group,
        phi_impl="fused",
    )).initialize()
    _finite(svgd.run(), (n, dim), "driver under a mesh")
    assert svgd._iteration == 3, svgd._iteration
    # 8. the fused triangle forms, their plain chunk versions on the CPU
    n_sym = -(-2048 // world) * world
    x0s = flagship_mvn(n_sym)[2]
    for form in ("full", "panel"):
        eng = engine(st.AdaGrad(dim, n_sym, 0.1), particles=n_sym,
                     fused_phi=True, fused_cuda=True, fused_sym=form)
        assert eng._fused_sym == form, eng._fused_sym
        _finite(eng.run_state(eng.init_state(x0s), 2)["coords"],
                (n_sym // world, dim), f"fused_sym={form!r}")


def _rank(rank: int, world: int, port: int) -> None:
    from .mesh import initialize_distributed

    torch.set_num_threads(1)
    group = initialize_distributed(f"tcp://localhost:{port}", world, rank,
                                   device="cpu")
    try:
        _parts(group)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_ranks: int) -> None:
    """Run the eight parts on ``n_ranks`` spawned gloo ranks on the CPU and
    print one OK line; raise if a rank fails."""
    n_ranks = int(n_ranks)
    torch.multiprocessing.start_processes(
        _rank, args=(n_ranks, _free_port()), nprocs=n_ranks, join=True,
        start_method="spawn",
    )
    print(
        f"dryrun_multichip({n_ranks}): OK — gather step, ring warm 3-step "
        "run, composed-kernel generic + RBF-terms runs, fused single-sweep "
        "runs (built-in RBF and composed), the driver under "
        "SVGDOptions.mesh (phi_impl='fused'), and the fused_sym schedules "
        f"(full-width + panel chunks, plain versions, n="
        f"{-(-2048 // n_ranks) * n_ranks}) on {n_ranks} gloo ranks"
    )


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
