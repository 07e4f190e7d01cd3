"""One rank of a CPU world for tests/test_torch_sharded.py.

    python tests/torch_sharded_worker.py RANK WORLD PORT OUT_DIR

Joins a gloo world of WORLD ranks over tcp://localhost:PORT, runs
svgdcpp_tpu_torch's ShardedSVGD (float64, on the CPU) for each case of
``cases()`` from the same x0, a generic-kernel run with the debug dump
(written to OUT_DIR/torch_log_<WORLD>.txt) and a checkpoint round trip
(5 steps, save to OUT_DIR, restore on every rank, 5 more, beside 10
uninterrupted), and rank 0 writes the gathered coordinates and the debug
matrices to OUT_DIR/torch_sharded_<WORLD>.npz. Imports torch and the port
only.
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
from svgdcpp_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint,
    save_checkpoint,
)

N, DIM, STEPS = 200, 2, 10
MEAN = np.array([0.5, -1.0])
COV = np.array([[1.0, 0.2], [0.2, 0.8]])
#: The debug-dump run: the first 16 particles of x0, the composed kernel
#: through the generic sweep.
LOG_CFG = {"kernel_phi": "generic", "median_bins": 1024, "median_passes": 4,
           "row_tile": 4, "warm_start": False}
LOG_STEPS = 3


class HookedMVN(st.MultivariateNormal):
    """An MVN whose Step hook shrinks its mean each step."""

    def step(self):
        self.update_parameters((self.parameters[0] * 0.9,
                                self.parameters[1]))


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
        "generic_gather": (True, {"kernel_phi": "generic",
                                  "median_passes": 4, "row_tile": 16}),
        "hooked_gather": (False, {"median_passes": 4, "row_tile": 16}),
    }


def run_case(group, composed, config, hooked=False):
    model = (HookedMVN if hooked else st.MultivariateNormal)(MEAN, COV)
    kernel = composed_kernel(x0(), model) if composed else None
    engine = ShardedSVGD(
        model, st.AdaGrad(DIM, N, 0.1), N, DIM, mesh=group, kernel=kernel,
        config=ShardedSVGDConfig(**config),
    )
    out = engine.run(x0(), STEPS)
    assert engine.median_fallbacks == 0
    return out.numpy()


def logged_run(group, path):
    x = x0()[:16]
    model = st.MultivariateNormal(MEAN, COV)
    engine = ShardedSVGD(
        model, st.AdaGrad(DIM, 16, 0.1), 16, DIM, mesh=group,
        kernel=composed_kernel(x, model),
        config=ShardedSVGDConfig(**LOG_CFG, log_intermediate_matrices=True,
                                 intermediate_matrices_output_path=str(path)),
    )
    engine.run(x, LOG_STEPS)
    return {"log_" + k: v for k, v in engine.intermediate_logs.items()}


def checkpoint_round_trip(group, path):
    def make():
        return ShardedSVGD(
            st.MultivariateNormal(MEAN, COV),
            st.Adam(DIM, N, 0.1, 0.9, 0.999), N, DIM, mesh=group,
            config=ShardedSVGDConfig(fused_phi=True, row_tile=16),
        )

    full = make().run(x0(), STEPS)
    first = make()
    state = first.run_state(first.init_state(x0()), STEPS // 2)
    save_checkpoint(path, state, step=STEPS // 2)
    second = make()
    restored, _ = restore_checkpoint(path, second.init_state(x0()))
    out = second.run_state(restored, STEPS - STEPS // 2)
    resumed = group.all_gather_rows(out["coords"])
    return {"ckpt_full": full.numpy(), "ckpt_resumed": resumed.numpy()}


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), Path(sys.argv[4]))
    torch.set_num_threads(1)
    group = initialize_distributed(f"tcp://localhost:{port}", world, rank,
                                   device="cpu")
    results = {name: run_case(group, composed, config,
                              hooked=name.startswith("hooked"))
               for name, (composed, config) in cases().items()}
    results.update(logged_run(group, out_dir / f"torch_log_{world}.txt"))
    results.update(checkpoint_round_trip(group, out_dir / f"ck_{world}"))
    if rank == 0:
        np.savez(out_dir / f"torch_sharded_{world}.npz", **results)
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: OK")


if __name__ == "__main__":
    main()
