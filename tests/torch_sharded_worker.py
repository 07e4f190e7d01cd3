"""One rank of a CPU world for tests/test_torch_sharded.py.

    python tests/torch_sharded_worker.py RANK WORLD PORT OUT_DIR

Joins a gloo world of WORLD ranks over tcp://localhost:PORT, runs
svgdcpp_tpu_torch's ShardedSVGD (float64, on the CPU) for each case of
``cases()`` from the same x0, and rank 0 writes the gathered coordinates to
OUT_DIR/torch_sharded_<WORLD>.npz. Imports torch and the port only.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import svgdcpp_tpu_torch as st  # noqa: E402
from svgdcpp_tpu_torch.parallel import (  # noqa: E402
    ShardedSVGD,
    ShardedSVGDConfig,
    initialize_distributed,
)

N, DIM, STEPS = 200, 2, 10
MEAN = np.array([0.5, -1.0])
COV = np.array([[1.0, 0.2], [0.2, 0.8]])


def x0():
    return np.random.default_rng(11).normal(size=(N, DIM)) * 2.0


def composed_kernel(x, model):
    return st.GaussianRBFKernel(
        x, st.ScaleMethod.MEDIAN, model, median_method="exact"
    ) + st.GaussianRBFKernel(
        x, st.ScaleMethod.CONSTANT, constant_scale=0.25 * np.eye(DIM)
    )


def cases():
    """name -> (composed, config kwargs)."""
    fused = {"fused_phi": True, "row_tile": 16}
    return {
        "flagship_cross": (False, dict(fused)),
        "flagship_full": (False, dict(fused, fused_cuda=True,
                                      fused_sym="full")),
        "flagship_panel": (False, dict(fused, fused_cuda=True,
                                       fused_sym="panel")),
        "composed_cross": (True, dict(fused)),
        "composed_full": (True, dict(fused, fused_cuda=True,
                                     fused_sym="full")),
        "warm_gather": (False, {"median_passes": 4, "row_tile": 16}),
    }


def run_case(group, composed, config):
    model = st.MultivariateNormal(MEAN, COV)
    kernel = composed_kernel(x0(), model) if composed else None
    engine = ShardedSVGD(
        model, st.AdaGrad(DIM, N, 0.1), N, DIM, mesh=group, kernel=kernel,
        config=ShardedSVGDConfig(**config),
    )
    out = engine.run(x0(), STEPS)
    assert engine.median_fallbacks == 0
    return out.numpy()


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), Path(sys.argv[4]))
    torch.set_num_threads(1)
    group = initialize_distributed(f"tcp://localhost:{port}", world, rank,
                                   device="cpu")
    results = {name: run_case(group, composed, config)
               for name, (composed, config) in cases().items()}
    if rank == 0:
        np.savez(out_dir / f"torch_sharded_{world}.npz", **results)
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: OK")


if __name__ == "__main__":
    main()
