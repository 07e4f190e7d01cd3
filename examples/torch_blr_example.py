"""Bayesian logistic regression example on svgdcpp_tpu_torch (the
PyTorch/CUDA port; BASELINE.md config 3).

The port's counterpart of ``blr_example.py``: d~50 weight dimensions, 1k
particles, Gaussian-RBF median-bandwidth kernel, Adam. The dataset is
synthetic two-class data; the posterior mean should classify like the
generating weights. On the card ``auto`` takes the fused square kernel
(``fused_cuda``); on the CPU the plain route of the JAX package's rule.

    python examples/torch_blr_example.py [cuda|cpu]
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import svgdcpp_tpu_torch as st
from svgdcpp_tpu_torch.models.bayesian_logistic_regression import (
    make_synthetic_classification,
)


def run(num_particles=1000, num_iterations=500, dim=50, n_data=1024, seed=0,
        verbose=True, device="cuda"):
    rng = np.random.default_rng(seed)
    features, labels, true_w = make_synthetic_classification(
        rng, n_data=n_data, dim=dim
    )
    model = st.BayesianLogisticRegression(features, labels, prior_precision=0.1)

    x0 = rng.normal(size=(num_particles, dim)).astype(np.float32)
    kernel = st.GaussianRBFKernel(x0, st.ScaleMethod.MEDIAN, model)
    optimizer = st.Adam(dim, num_particles, 5e-2, 0.9, 0.999)

    svgd = st.SVGD(
        st.SVGDOptions(
            dimension=dim,
            num_iterations=num_iterations,
            coordinate_matrix=x0,
            kernel=kernel,
            model=model,
            optimizer=optimizer,
            device=device,
        )
    )
    svgd.initialize()
    final = svgd.run().cpu().numpy()

    features = np.asarray(features)
    post_mean = final.mean(axis=0)
    agreement = np.mean(
        np.sign(features @ post_mean) == np.sign(features @ np.asarray(true_w))
    )
    if verbose:
        print(f"posterior-mean vs true-weight label agreement: {agreement:.3f}")
    return final, agreement, np.asarray(true_w)


if __name__ == "__main__":
    run(device=sys.argv[1] if len(sys.argv) > 1 else "cuda")
