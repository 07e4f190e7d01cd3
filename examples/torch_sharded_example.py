"""Multi-rank SVGD on svgdcpp_tpu_torch (the PyTorch/CUDA port):
particle-axis sharding over a torch.distributed group.

The port's counterpart of ``sharded_example.py``. The reference's only
parallelism is OpenMP threads over particles (reference SVGD.hpp:418-431);
here the particle axis is split over the ranks of a process group, each
rank owning a block of particles on its own device, and the two globally
coupled computations (the cross-rank kernel blocks of phi, the global
pairwise-distance median) run over the group's collectives
(svgdcpp_tpu_torch/parallel/sharded.py). On one card the sweep is the
sharded triangle kernel's chunk (``fused_phi_counts_sym_chunk``).

Runs anywhere: alone it makes a one-rank world on this process's device
(NCCL on the card, gloo on the CPU). Several ranks each call
``initialize_distributed("tcp://localhost:<port>", world, rank)`` first
(or run under torchrun) and then ``run(...)``.

    python examples/torch_sharded_example.py [num_particles] [num_iterations] [cuda|cpu]
"""

import sys
from pathlib import Path

import numpy as np
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import svgdcpp_tpu_torch as st
from svgdcpp_tpu_torch.ops.ksd import ksd_rbf
from svgdcpp_tpu_torch.parallel import (
    ShardedSVGD,
    ShardedSVGDConfig,
    make_particle_mesh,
)
from svgdcpp_tpu_torch.utils.workloads import flagship_mvn


def run(num_particles=4096, num_iterations=200, seed=0, verbose=True,
        device="cuda"):
    created = not dist.is_initialized()
    group = make_particle_mesh(device=device)
    try:
        return _run(group, num_particles, num_iterations, seed, verbose)
    finally:
        if created:  # the one-rank world this call made
            dist.destroy_process_group()


def _run(group, num_particles, num_iterations, seed, verbose):
    n_dev = group.world_size
    if num_particles < n_dev:
        raise ValueError(
            f"num_particles ({num_particles}) must be >= the rank count "
            f"({n_dev}): each rank owns at least one particle row."
        )
    # The particle count must split evenly over the group.
    n = (num_particles // n_dev) * n_dev
    mean, cov, x0 = flagship_mvn(n, seed=seed, dtype=np.float32)
    dim = x0.shape[1]

    model = st.MultivariateNormal(mean, cov)
    sharded = ShardedSVGD(
        model,
        st.AdaGrad(dim, n, 0.1),
        num_particles=n,
        dimension=dim,
        mesh=group,
        # fused_phi: ONE cross-rank O(n^2/D) sweep per step computes phi
        # and the (summed) median-selection counts; on the card it runs
        # the sharded triangle kernel.
        config=ShardedSVGDConfig(fused_phi=True),
    )

    ksd0 = float(ksd_rbf(model, x0, device=group.device))
    if verbose:
        print(
            f"group: {n_dev} rank(s) on {group.device} ({group.backend}), "
            f"{n // n_dev} particles/rank"
        )
    final = sharded.run(x0, num_iterations).cpu().numpy()
    ksd1 = float(ksd_rbf(model, final, device=group.device))
    if verbose:
        print(f"coords rows of rank {group.rank}: {group.rows(n)}")
        print(f"KSD before: {ksd0:.4f}  after: {ksd1:.4f}")
        print(f"posterior mean: {final.mean(axis=0)}  (target {mean})")
    return x0, final, ksd0, ksd1


if __name__ == "__main__":
    run(
        int(sys.argv[1]) if len(sys.argv) > 1 else 4096,
        int(sys.argv[2]) if len(sys.argv) > 2 else 200,
        device=sys.argv[3] if len(sys.argv) > 3 else "cuda",
    )
