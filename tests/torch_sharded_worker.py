"""One rank of a CPU world for tests/test_torch_sharded.py.

    python tests/torch_sharded_worker.py RANK WORLD PORT OUT_DIR

Joins a gloo world of WORLD ranks over tcp://localhost:PORT, runs
svgdcpp_tpu_torch's ShardedSVGD (float64, on the CPU) for each case of
``cases()`` from the same x0 (gather and ring modes), the driver under
SVGDOptions.mesh for each case of ``mesh_cases()``, the ring primitives on
``ring_inputs()`` (their counts checked equal to the gather counts here), a
generic-kernel run with the debug dump (written to
OUT_DIR/torch_log_<WORLD>.txt) and checkpoint round trips of the engine
and of the driver under a mesh (5 steps, save to OUT_DIR, restore on every
rank, 5 more, beside 10 uninterrupted), and rank 0 writes the gathered
results to OUT_DIR/torch_sharded_<WORLD>.npz. N = 192 splits evenly over
2, 3, 4 and 8 ranks. The driver also runs under the mesh at N_UNEVEN = 13
particles, which no world of 2, 3 or 4 divides (``uneven_cases()``, a
checkpoint round trip, the debug dump against the meshless driver's, the
row placement and gather, and the forced kernel routes' raise). Imports
torch and the port only.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import svgdcpp_tpu_torch as st  # noqa: E402
from svgdcpp_tpu_torch.kernels.algebra import flatten_rbf_terms  # noqa: E402
from svgdcpp_tpu_torch.ops.median import centered_count_env  # noqa: E402
from svgdcpp_tpu_torch.parallel import (  # noqa: E402
    ShardedSVGD,
    ShardedSVGDConfig,
    initialize_distributed,
    place_sharded,
)
from svgdcpp_tpu_torch.parallel import ring  # noqa: E402
from svgdcpp_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint,
    save_checkpoint,
)

N, DIM, STEPS = 192, 2, 10
MEAN = np.array([0.5, -1.0])
COV = np.array([[1.0, 0.2], [0.2, 0.8]])
#: The debug-dump run: the first LOG_N particles of x0, the composed kernel
#: through the generic sweep.
LOG_CFG = {"kernel_phi": "generic", "median_bins": 1024, "median_passes": 4,
           "row_tile": 4, "warm_start": False}
LOG_STEPS = 3
LOG_N = 24


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
        "ring_cold": (False, {"phi_mode": "ring", "median_bins": 16,
                              "median_passes": 10, "row_tile": 16,
                              "warm_start": False}),
        "ring_warm": (False, {"phi_mode": "ring", "median_passes": 4,
                              "row_tile": 16}),
        "ring_terms": (True, {"phi_mode": "ring", "kernel_phi": "rbf_terms",
                              "median_bins": 16, "median_passes": 10,
                              "row_tile": 16, "warm_start": False}),
        "ring_generic": (True, {"phi_mode": "ring", "kernel_phi": "generic",
                                "median_passes": 4, "row_tile": 16}),
    }


def mesh_cases():
    """name -> (composed, phi_impl, options) of the driver under
    SVGDOptions.mesh; the fused_cuda routes run their plain forms on the
    CPU (the triangle chunks forced, the cross sweep at this n)."""
    return {
        "mesh_dense": (False, "dense", {}),
        "mesh_fused": (False, "fused", {}),
        "mesh_rbf_terms": (True, "rbf_terms", {}),
        "mesh_generic": (True, "generic", {"row_tile": 16}),
        "mesh_fused_cross": (False, "fused_cuda", {}),
        "mesh_fused_full": (False, "fused_cuda", {"fused_sym": "full"}),
        "mesh_fused_panel": (False, "fused_cuda", {"fused_sym": "panel"}),
        "mesh_fused_terms_full": (True, "fused_terms_cuda",
                                  {"fused_sym": "full"}),
    }


#: A particle count that no world of 2, 3 or 4 ranks divides.
N_UNEVEN = 13


def uneven_cases():
    """name -> (composed, phi_impl, options, median_method) of the driver
    under SVGDOptions.mesh at N_UNEVEN particles (the plain routes; the
    histogram selector sums the ranks' histograms)."""
    return {
        "uneven_dense": (False, "dense", {}, "auto"),
        "uneven_fused": (False, "fused", {}, "auto"),
        "uneven_blocked": (False, "blocked", {"row_tile": 8}, "auto"),
        "uneven_generic": (True, "generic", {"row_tile": 8}, "auto"),
        "uneven_histogram": (False, "dense", {}, "histogram"),
    }


def ring_inputs():
    """(coords (N, 3), scores (N, 3), P (3, 3)) of the ring primitives."""
    rng = np.random.default_rng(5)
    return (rng.normal(size=(N, 3)) * 1.5 + 2.0, rng.normal(size=(N, 3)),
            np.eye(3) * 0.7 + 0.1)


def ring_kernel(pkg, x):
    """A composed kernel of constant RBFs with a negative term."""
    m = x.shape[1]
    return pkg.GaussianRBFKernel(
        x, pkg.ScaleMethod.CONSTANT, constant_scale=0.5 * np.eye(m)
    ) - pkg.GaussianRBFKernel(
        x, pkg.ScaleMethod.CONSTANT,
        constant_scale=np.diag(np.linspace(0.1, 0.3, m)),
    ) * pkg.GaussianRBFKernel(
        x, pkg.ScaleMethod.CONSTANT, constant_scale=0.2 * np.eye(m)
    )


#: The ring primitives' thresholds (away from 0, where a self pair counts
#: by the rounding of the Gram identity).
RING_THRESHOLDS = np.linspace(0.05, 12.0, 17)


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


def run_driver(group, composed, impl, options, iters=STEPS, n=N,
               median_method="auto"):
    x = x0()[:n]
    model = st.MultivariateNormal(MEAN, COV)
    kernel = (composed_kernel(x, model) if composed
              else st.GaussianRBFKernel(x, st.ScaleMethod.MEDIAN, model,
                                        median_method=median_method))
    svgd = st.SVGD(st.SVGDOptions(
        dimension=DIM, num_iterations=iters, coordinate_matrix=x,
        kernel=kernel, model=model, optimizer=st.AdaGrad(DIM, n, 0.1),
        phi_impl=impl, mesh=group, **options,
    )).initialize()
    return svgd


def uneven_runs(group, path, log_path):
    """The driver under the mesh at N_UNEVEN: uneven_cases(), a checkpoint
    round trip on 'fused', the debug dump (equal to the meshless
    driver's), the split and the gather of place_sharded, and the forced
    kernel routes' raise."""
    out = {}
    for name, (composed, impl, options, method) in uneven_cases().items():
        svgd = run_driver(group, composed, impl, options, n=N_UNEVEN,
                          median_method=method)
        assert svgd._phi_impl == impl
        out[name] = svgd.run().numpy()
    auto = run_driver(group, False, "auto", {}, n=N_UNEVEN)
    assert auto._phi_impl == "dense", auto._phi_impl
    for impl in ("fused_cuda", "fused_terms_cuda"):
        try:
            run_driver(group, impl == "fused_terms_cuda", impl, {},
                       n=N_UNEVEN)
        except ValueError as e:
            assert "duplicates" in str(e), e
        else:
            raise AssertionError(f"{impl} ran at an uneven split")
    x = torch.from_numpy(x0()[:N_UNEVEN])
    local = place_sharded(x, group)
    assert local.shape[0] == group.share(N_UNEVEN)
    assert torch.equal(local, x[group.rows(N_UNEVEN)])
    assert torch.equal(group.all_gather_rows(local, N_UNEVEN), x)
    out["uneven_gather"] = group.all_gather_rows(local * 2.0,
                                                 N_UNEVEN).numpy()
    full = run_driver(group, False, "fused", {}, n=N_UNEVEN).run()
    first = run_driver(group, False, "fused", {}, STEPS // 2, n=N_UNEVEN)
    first.run()
    save_checkpoint(path, first.make_state(), step=STEPS // 2)
    second = run_driver(group, False, "fused", {}, STEPS - STEPS // 2,
                        n=N_UNEVEN)
    restored, _ = restore_checkpoint(path, second.make_state())
    second._absorb_state(restored)
    out["uneven_ckpt_full"] = full.numpy()
    out["uneven_ckpt_resumed"] = second.run().numpy()
    logs = []
    for where in (group, None):
        svgd = run_driver(where, False, "auto",
                          {"log_intermediate_matrices": True,
                           "intermediate_matrices_output_path": str(
                               log_path), "device": "cpu"},
                          iters=LOG_STEPS, n=N_UNEVEN)
        svgd.run()
        logs.append(svgd._intermediate_logs)
    for key, want in logs[1].items():
        np.testing.assert_allclose(logs[0][key], want, rtol=1e-12,
                                   atol=1e-14, err_msg=key)
    return out


def ring_primitives(group):
    """The ring functions on this rank's rows of ring_inputs(), gathered;
    the ring counts equal to the gather counts."""
    x, s, p = ring_inputs()
    rows = group.rows(N)
    xl, sl = torch.from_numpy(x[rows]), torch.from_numpy(s[rows])
    kernel = ring_kernel(st, x)
    params = tuple(torch.as_tensor(np.asarray(q)) for q in kernel.parameters)
    out = {
        "ring_phi": ring.ring_phi_rbf(xl, sl, torch.from_numpy(p), group, N,
                                      row_tile=16),
        "ring_terms_phi": ring.ring_phi_rbf_terms(
            xl, sl, params, flatten_rbf_terms(kernel), group, N,
            row_tile=16),
        "ring_generic_phi": ring.ring_phi_generic(
            xl, sl, kernel.kernel_pure, params, group, N, row_tile=16),
    }
    out = {k: group.all_gather_rows(v).numpy() for k, v in out.items()}
    out["ring_median"] = ring.ring_pairwise_median(
        xl, group, N, bins=16, passes=8).numpy()
    thr = torch.from_numpy(RING_THRESHOLDS)
    counts = ring.ring_count_le(xl, thr, group, N, row_tile=16)
    count_fn, _ = centered_count_env(xl, torch.from_numpy(x), group=group,
                                     n_global=N)
    assert torch.equal(counts, count_fn(thr)), (counts, count_fn(thr))
    out["ring_counts"] = counts.numpy()
    return out


def mesh_checkpoint_round_trip(group, path):
    full = run_driver(group, False, "fused", {}).run()
    first = run_driver(group, False, "fused", {}, STEPS // 2)
    first.run()
    save_checkpoint(path, first.make_state(), step=STEPS // 2)
    second = run_driver(group, False, "fused", {}, STEPS - STEPS // 2)
    restored, _ = restore_checkpoint(path, second.make_state())
    second._absorb_state(restored)
    return {"mesh_ckpt_full": full.numpy(),
            "mesh_ckpt_resumed": second.run().numpy()}


def logged_run(group, path):
    x = x0()[:LOG_N]
    model = st.MultivariateNormal(MEAN, COV)
    engine = ShardedSVGD(
        model, st.AdaGrad(DIM, LOG_N, 0.1), LOG_N, DIM, mesh=group,
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
    for name, (composed, impl, options) in mesh_cases().items():
        svgd = run_driver(group, composed, impl, options)
        results[name] = svgd.run().numpy()
        assert svgd.median_fallbacks == 0
    results.update(ring_primitives(group))
    results.update(logged_run(group, out_dir / f"torch_log_{world}.txt"))
    results.update(checkpoint_round_trip(group, out_dir / f"ck_{world}"))
    results.update(mesh_checkpoint_round_trip(group,
                                              out_dir / f"mesh_ck_{world}"))
    results.update(uneven_runs(group, out_dir / f"uneven_ck_{world}",
                               out_dir / f"uneven_log_{rank}_{world}.txt"))
    if rank == 0:
        np.savez(out_dir / f"torch_sharded_{world}.npz", **results)
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: OK")


if __name__ == "__main__":
    main()
