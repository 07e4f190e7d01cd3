"""Large-scale SVGD on svgdcpp_tpu_torch (the PyTorch/CUDA port): the fused
single-sweep production path.

The port's counterpart of ``large_scale_example.py``: the reference's MVN
workload at 10k-1M particles, where each step is ONE fused O(n^2) sweep
computing phi and the median-selection counts together. On the card
``phi_impl='auto'`` takes the fused CUDA kernels (from n >= 2048 the
triangle sweep visits each unordered pair once; the form rule,
``ops/cuda_phi.resolve_sym``, takes the full-width triangle or its panel
form); on the CPU the plain fused sweep. Prints per-step timing,
throughput, and the kernel Stein discrepancy before/after as the
convergence check.

    python examples/torch_large_scale_example.py [num_particles] [num_iterations] [cuda|cpu]

Defaults are sized for one card (100k particles); on the CPU pass a
smaller count (e.g. 4096).
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import svgdcpp_tpu_torch as st
from svgdcpp_tpu_torch.core.types import place_coords
from svgdcpp_tpu_torch.utils.profiling import sync
from svgdcpp_tpu_torch.utils.workloads import flagship_mvn


def run(num_particles=100_000, num_iterations=100, seed=0, verbose=True,
        device="cuda"):
    mean, cov, x0 = flagship_mvn(num_particles, seed=seed, dtype=np.float32)
    dim = x0.shape[1]

    model = st.MultivariateNormal(mean, cov)
    # On the device first, so the kernel's median is taken there.
    x0_dev = place_coords(x0, device)
    kernel = st.GaussianRBFKernel(x0_dev, st.ScaleMethod.MEDIAN, model)
    svgd = st.SVGD(
        st.SVGDOptions(
            dimension=dim,
            num_iterations=num_iterations,
            coordinate_matrix=x0_dev.clone(),
            kernel=kernel,
            model=model,
            optimizer=st.AdaGrad(dim, num_particles, 0.1),
            device=device,
        )
    )
    svgd.initialize()
    if verbose:
        print(f"phi_impl={svgd._phi_impl}  n={num_particles}  d={dim}")

    ksd_before = float(st.ksd_rbf(model, x0, device=device))

    # The first run IS the advertised num_iterations trajectory: the
    # convergence numbers come from its output. The second run (continuing
    # in place, the reference's SVGD.hpp:393 contract) is timed for the
    # steady state only: it excludes the kernels' build and first launches,
    # and a step's cost depends on the shapes, not the values.
    out = svgd.run().cpu().numpy()
    ksd_after = float(st.ksd_rbf(model, out, device=device))

    t0 = time.perf_counter()
    sync(svgd.run())
    dt = time.perf_counter() - t0
    rate = num_particles * num_iterations / dt
    if verbose:
        print(
            f"{1e3 * dt / num_iterations:.3f} ms/step, "
            f"{rate:,.0f} particle-updates/s"
        )
        print(f"KSD before {ksd_before:.4f} -> after {ksd_after:.4f}")
        print(f"particle mean: {out.mean(0)}  (target {mean})")
    assert np.isfinite(out).all()
    return out, ksd_before, ksd_after


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    run(n, iters, device=sys.argv[3] if len(sys.argv) > 3 else "cuda")
