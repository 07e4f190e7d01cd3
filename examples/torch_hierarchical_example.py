"""Hierarchical model with a composed kernel + per-step bandwidth adaptation
on svgdcpp_tpu_torch (the PyTorch/CUDA port; BASELINE.md config 4).

The port's counterpart of ``hierarchical_example.py``. Target: hierarchical
Bayesian logistic regression over [w, log alpha] (Gamma prior on the
precision). Kernel: sum-composition of a median-adaptive Gaussian RBF and a
fixed-scale Gaussian RBF; the adaptive slot's bandwidth is recomputed every
step (the generalization of the reference's GaussianRBFKernel::Step,
GaussianRBFKernel.hpp:141-156). 200 particles stay below
``CUDA_FUSED_MIN_PARTICLES``, so ``auto`` takes the plain composed route on
the card as on the CPU.

    python examples/torch_hierarchical_example.py [cuda|cpu]
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import svgdcpp_tpu_torch as st
from svgdcpp_tpu_torch.models.bayesian_logistic_regression import (
    make_synthetic_classification,
)


def run(num_particles=200, num_iterations=400, dim=10, n_data=512, seed=0,
        verbose=True, device="cuda"):
    rng = np.random.default_rng(seed)
    features, labels, true_w = make_synthetic_classification(
        rng, n_data=n_data, dim=dim
    )
    model = st.HierarchicalBayesianLogisticRegression(
        features, labels, a0=1.0, b0=0.01
    )
    full_dim = dim + 1

    x0 = np.concatenate(
        [
            rng.normal(size=(num_particles, dim)),
            rng.normal(scale=0.3, size=(num_particles, 1)),  # log alpha
        ],
        axis=1,
    ).astype(np.float32)

    k_adaptive = st.GaussianRBFKernel(x0, st.ScaleMethod.MEDIAN, model)
    k_fixed = st.GaussianRBFKernel(
        x0, st.ScaleMethod.CONSTANT, constant_scale=0.1 * np.eye(full_dim)
    )
    kernel = k_adaptive + k_fixed  # composed kernel, adaptive slot 0

    svgd = st.SVGD(
        st.SVGDOptions(
            dimension=full_dim,
            num_iterations=num_iterations,
            coordinate_matrix=x0,
            kernel=kernel,
            model=model,
            optimizer=st.Adam(full_dim, num_particles, 5e-2, 0.9, 0.999),
            device=device,
        )
    )
    svgd.initialize()
    final = svgd.run().cpu().numpy()

    features = np.asarray(features)
    post_w = final[:, :dim].mean(axis=0)
    post_alpha = np.exp(final[:, dim]).mean()
    agreement = np.mean(
        np.sign(features @ post_w) == np.sign(features @ np.asarray(true_w))
    )
    if verbose:
        print(f"label agreement: {agreement:.3f}  posterior alpha: {post_alpha:.4f}")
    return final, agreement, post_alpha, np.asarray(true_w)


if __name__ == "__main__":
    run(device=sys.argv[1] if len(sys.argv) > 1 else "cuda")
