"""Multivariate-normal example on svgdcpp_tpu_torch (the PyTorch/CUDA port).

The port's counterpart of ``mvn_example.py`` (reference:
examples/multivariate_normal/mvn_example.cpp:9-35): 2-D MVN target,
10 particles, 1000 iterations, Gaussian-RBF kernel with median bandwidth,
AdaGrad lr=0.1, x0 ~ 3*U(-1,1). Runs on the card (``device="cuda"``)
unless asked for the CPU:

    python examples/torch_mvn_example.py [cuda|cpu]

Prints initial and final particle coordinates like the reference binary.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import svgdcpp_tpu_torch as st


def run(num_particles=10, num_iterations=1000, seed=0, verbose=True,
        device="cuda"):
    mean = np.array([-0.6871, 0.8010])
    covariance = 5.0 * np.array([[0.2260, 0.1652], [0.1652, 0.6779]])

    mvn = st.MultivariateNormal(mean, covariance)

    dim = 2
    rng = np.random.default_rng(seed)
    x0 = 3.0 * rng.uniform(-1.0, 1.0, (num_particles, dim))

    if verbose:
        print("Initial particle coordinates")
        print(x0.T)  # reference prints m x n

    kernel = st.GaussianRBFKernel(x0, st.ScaleMethod.MEDIAN, mvn)
    optimizer = st.AdaGrad(dim, num_particles, 1.0e-1)

    svgd = st.SVGD(
        st.SVGDOptions(
            dimension=dim,
            num_iterations=num_iterations,
            coordinate_matrix=x0,
            kernel=kernel,
            model=mvn,
            optimizer=optimizer,
            device=device,
        )
    )
    svgd.initialize()
    final = svgd.run().cpu().numpy()

    if verbose:
        print("Final particle coordinates")
        print(final.T)
    return x0, final, mean, covariance


if __name__ == "__main__":
    run(device=sys.argv[1] if len(sys.argv) > 1 else "cuda")
