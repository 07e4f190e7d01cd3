"""Canonical SVGD workloads.

The flagship MVN configuration (the reference mvn_example target,
examples/multivariate_normal/mvn_example.cpp:9-35), with the same constants
and the same seeded x0 as ``svgdcpp_tpu.utils.workloads``. It is repeated
here because importing the JAX package would import ``jax``.
"""

from __future__ import annotations

import numpy as np

MVN_MEAN = np.array([-0.6871, 0.8010])
MVN_COV = 5.0 * np.array([[0.2260, 0.1652], [0.1652, 0.6779]])


def flagship_mvn(num_particles: int, seed: int = 0, dtype=np.float64):
    """(mean, cov, x0) for the flagship workload; x0 ~ 3 * U(-1, 1)."""
    rng = np.random.default_rng(seed)
    x0 = 3.0 * rng.uniform(-1.0, 1.0, (num_particles, 2))
    return MVN_MEAN.astype(dtype), MVN_COV.astype(dtype), x0.astype(dtype)
