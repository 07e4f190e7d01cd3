"""Canonical SVGD workloads.

The flagship MVN configuration (the reference mvn_example target,
examples/multivariate_normal/mvn_example.cpp:9-35), with the same constants
and the same seeded x0 as ``svgdcpp_tpu.utils.workloads``, and its driver;
the large-N configurations (the flagship and the hierarchical BLR at the
sizes where the panel triangle sweeps run); the BLR
workloads of ``bench.py --config blr|hier`` (BASELINE configs 3-4) with the
bench's data, x0 and constants; and the anisotropic composed-kernel
posterior of ``scripts/check_aniso_posterior.py`` with its draws; and the
flagship and the hierarchical BLR on the sharded engine. They are
repeated here because importing the JAX package, the bench or the script
would import ``jax``.

The builders follow the drivers' rule: an ``x0`` that is a tensor keeps its
device, any other goes to ``device``, the card by default.
"""

from __future__ import annotations

import numpy as np

MVN_MEAN = np.array([-0.6871, 0.8010])
MVN_COV = 5.0 * np.array([[0.2260, 0.1652], [0.1652, 0.6779]])

#: The bench's BLR constants (bench.py:383-412): flat BLR's prior precision
#: (not the model's default of 0.01), Adam's learning rate and decays, and
#: the hierarchical config's constant kernel term 0.1 * I.
BLR_PRIOR_PRECISION = 0.1
BLR_ADAM = {"lr": 5e-2, "beta1": 0.9, "beta2": 0.999}
HIER_CONSTANT_SCALE = 0.1


def flagship_mvn(num_particles: int, seed: int = 0, dtype=np.float64):
    """(mean, cov, x0) for the flagship workload; x0 ~ 3 * U(-1, 1)."""
    rng = np.random.default_rng(seed)
    x0 = 3.0 * rng.uniform(-1.0, 1.0, (num_particles, 2))
    return MVN_MEAN.astype(dtype), MVN_COV.astype(dtype), x0.astype(dtype)


#: The flagship's AdaGrad learning rate (bench.py's default configuration).
FLAGSHIP_ADAGRAD_LR = 0.1


def build_mvn_svgd(x0, mean, cov, phi_impl="auto", num_iterations=100,
                   device="cuda", fused_sym=None, mesh=None,
                   fused_dot_dtype="float32"):
    """The flagship driver (``bench.py``'s default configuration and
    examples/large_scale_example.py), initialized: an MVN target with mean
    and cov in x0's dtype, an RBF kernel with the median bandwidth, AdaGrad
    lr 0.1. ``x0`` may be a tensor (its device and dtype are kept) or an
    array (it goes to ``device`` first, so the kernel's median is taken
    there, once). ``mesh`` is SVGDOptions.mesh (a ParticleGroup on
    ``device``), ``fused_dot_dtype`` SVGDOptions.fused_dot_dtype."""
    import torch

    import svgdcpp_tpu_torch as st

    from ..core.types import place_coords

    x0 = place_coords(x0, device)
    n, dim = x0.shape
    dtype = x0.dtype
    model = st.MultivariateNormal(torch.as_tensor(np.asarray(mean)).to(dtype),
                                  torch.as_tensor(np.asarray(cov)).to(dtype))
    kernel = st.GaussianRBFKernel(x0, st.ScaleMethod.MEDIAN, model)
    svgd = st.SVGD(
        st.SVGDOptions(
            dimension=dim, num_iterations=num_iterations,
            coordinate_matrix=x0, kernel=kernel, model=model,
            optimizer=st.AdaGrad(dim, n, FLAGSHIP_ADAGRAD_LR),
            phi_impl=phi_impl, device=device, fused_sym=fused_sym, mesh=mesh,
            fused_dot_dtype=fused_dot_dtype,
        )
    )
    return svgd.initialize()


#: The large-N configurations (examples/large_scale_example.py runs the
#: flagship at "10k-1M+" particles): path A is the flagship at
#: N = 262,144, with a short run at N = 1,048,576; path B the hierarchical
#: BLR of ``bench.py --config hier`` at N = 131,072. On them the JAX
#: package's rule takes the panel triangle sweeps (K3; K12).
LARGE_MVN_PARTICLES = 262144
LARGE_MVN_SHORT_PARTICLES = 1048576
LARGE_HIER_PARTICLES = 131072


def large_mvn_workload(num_particles: int = LARGE_MVN_PARTICLES,
                       seed: int = 0):
    """(mean, cov, x0) of path A: ``flagship_mvn`` at large N in float32,
    as examples/large_scale_example.py draws it."""
    return flagship_mvn(num_particles, seed, dtype=np.float32)


def large_hier_workload(particles: int = LARGE_HIER_PARTICLES,
                        seed: int = 0):
    """(features, labels, x0) of path B: ``blr_workload`` of the
    hierarchical configuration (d = 10, m = 11) at large N."""
    return blr_workload(particles, 10, hierarchical=True, seed=seed)


def blr_workload(particles: int, dim: int, n_data: int = 1024,
                 hierarchical: bool = False, seed: int = 0):
    """(features, labels, x0) as numpy arrays, equal to
    ``bench.make_blr_workload``: the synthetic data is drawn first, then x0
    ~ N(0, 1) of shape (particles, dim + 1 if hierarchical else dim), cast
    to float32 as the bench does. features and labels are float64."""
    from ..models.bayesian_logistic_regression import (
        make_synthetic_classification,
    )

    rng = np.random.default_rng(seed)
    features, labels, _ = make_synthetic_classification(
        rng, n_data=n_data, dim=dim
    )
    full_dim = dim + 1 if hierarchical else dim
    x0 = rng.normal(size=(particles, full_dim)).astype(np.float32)
    return features.numpy(), labels.numpy(), x0


def build_blr_svgd(x0, features, labels, hierarchical=False,
                   phi_impl="auto", num_iterations=100, device="cuda",
                   fused_sym=None, mesh=None, optimizer=None,
                   fused_dot_dtype="float32"):
    """The bench's BLR / hierarchical-BLR driver (bench.py:383-412), built
    on this package and initialized: flat BLR with prior precision 0.1 and
    a median RBF kernel, or hierarchical BLR with the composed kernel
    median RBF + 0.1 * I; Adam in both. ``x0`` may be a tensor (its device
    and dtype are kept) or an array (it goes to ``device`` first, so the
    kernel's median is taken there, once). ``fused_sym``, ``mesh`` and
    ``fused_dot_dtype`` are SVGDOptions'; ``optimizer`` replaces the
    bench's Adam."""
    import svgdcpp_tpu_torch as st

    from ..core.types import place_coords

    x0 = place_coords(x0, device)
    particles, full_dim = x0.shape
    if hierarchical:
        model = st.HierarchicalBayesianLogisticRegression(features, labels)
    else:
        model = st.BayesianLogisticRegression(
            features, labels, BLR_PRIOR_PRECISION
        )
    kernel = st.GaussianRBFKernel(x0, st.ScaleMethod.MEDIAN, model)
    if hierarchical:
        kernel = kernel + st.GaussianRBFKernel(
            x0, st.ScaleMethod.CONSTANT,
            constant_scale=HIER_CONSTANT_SCALE
            * np.eye(full_dim, dtype=np.float32),
        )
    svgd = st.SVGD(
        st.SVGDOptions(
            dimension=full_dim, num_iterations=num_iterations,
            coordinate_matrix=x0, kernel=kernel, model=model,
            optimizer=optimizer or st.Adam(
                full_dim, particles, BLR_ADAM["lr"], BLR_ADAM["beta1"],
                BLR_ADAM["beta2"],
            ),
            phi_impl=phi_impl, device=device, fused_sym=fused_sym, mesh=mesh,
            fused_dot_dtype=fused_dot_dtype,
        )
    )
    return svgd.initialize()


#: AdaGrad's learning rate of the anisotropic posterior check
#: (scripts/check_aniso_posterior.py:66).
ANISO_ADAGRAD_LR = 0.05


def aniso_mvn_workload(num_particles: int, seed: int = 7, dim: int = 11):
    """(mean, cov, x0, p_aniso) of scripts/check_aniso_posterior.py:76-89,
    drawn in its order from ``default_rng(seed)``: cov = I + A A^T with
    A ~ 0.3 N(0, 1); mean ~ N(0, 1); x0 ~ 2 N(0, 1) as float32; the
    constant kernel slot P = 0.05 I + B B^T with B ~ 0.1 N(0, 1), a full PD
    matrix. The script runs num_particles = 10240; P is drawn after x0, so
    it depends on the particle count."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(dim, dim)) * 0.3
    cov = np.eye(dim) + a @ a.T
    mean = rng.normal(size=dim)
    x0 = (rng.normal(size=(num_particles, dim)) * 2).astype(np.float32)
    b = rng.normal(size=(dim, dim)) * 0.1
    p_aniso = 0.05 * np.eye(dim) + b @ b.T
    return mean, cov, x0, p_aniso


def second_aniso_p(dim: int = 11, seed: int = 8):
    """A second constant kernel slot for the anisotropic driver,
    P_2 = 0.05 I + C C^T with C ~ 0.1 N(0, 1) (dim x dim) from
    ``default_rng(seed)``: the anisotropic script's P drawn again, so that
    median RBF + RBF(P) + RBF(P_2) has three gradient accumulators. No
    published configuration runs two anisotropic terms."""
    c = np.random.default_rng(seed).normal(size=(dim, dim)) * 0.1
    return 0.05 * np.eye(dim) + c @ c.T


def build_aniso_svgd(x0, mean, cov, p_aniso, phi_impl="auto",
                     num_iterations=100, device="cuda", kernel_scale=None,
                     extra_ps=()):
    """The anisotropic posterior check's driver
    (scripts/check_aniso_posterior.py:51-69), initialized: an MVN target
    (mean and cov as float32), the composed kernel median RBF + RBF with
    the constant full matrix ``p_aniso`` (float32), AdaGrad lr 0.05;
    ``extra_ps`` adds one RBF with each constant full matrix after it
    (float32; ``second_aniso_p``). ``kernel_scale`` replaces the median
    RBF by one with that scale method (a ScaleMethod) and no constant
    term. ``x0`` may be a tensor (its device and dtype are kept) or an
    array (it goes to ``device`` first, so the kernel's median is taken
    there, once)."""
    import svgdcpp_tpu_torch as st

    from ..core.types import place_coords

    x0 = place_coords(x0, device)
    particles, dim = x0.shape
    model = st.MultivariateNormal(
        np.asarray(mean, np.float32), np.asarray(cov, np.float32)
    )
    if kernel_scale is None:
        kernel = st.GaussianRBFKernel(
            x0, st.ScaleMethod.MEDIAN, model
        ) + st.GaussianRBFKernel(
            x0, st.ScaleMethod.CONSTANT,
            constant_scale=np.asarray(p_aniso, np.float32),
        )
        for p_extra in extra_ps:
            kernel = kernel + st.GaussianRBFKernel(
                x0, st.ScaleMethod.CONSTANT,
                constant_scale=np.asarray(p_extra, np.float32),
            )
    else:
        kernel = st.GaussianRBFKernel(x0, kernel_scale, model)
    svgd = st.SVGD(
        st.SVGDOptions(
            dimension=dim, num_iterations=num_iterations,
            coordinate_matrix=x0, kernel=kernel, model=model,
            optimizer=st.AdaGrad(dim, particles, ANISO_ADAGRAD_LR),
            phi_impl=phi_impl, device=device,
        )
    )
    return svgd.initialize()


def build_sharded_mvn_svgd(x0, mean, cov, group=None, **config):
    """The sharded example's engine (examples/sharded_example.py:56-66) on
    ``group`` (a ``parallel.ParticleGroup``; the default process group's
    when None): an MVN target with mean and cov, the built-in median RBF,
    AdaGrad lr 0.1, ``ShardedSVGDConfig(fused_phi=True, **config)``. x0
    (n, m) is the global set every rank holds; ``engine.run(x0, iters)``
    starts from it."""
    import torch

    import svgdcpp_tpu_torch as st

    from ..parallel import ShardedSVGD, ShardedSVGDConfig, make_particle_group

    group = group if group is not None else make_particle_group()
    n, dim = np.shape(x0)
    dtype = x0.dtype if torch.is_tensor(x0) else torch.from_numpy(
        np.asarray(x0)).dtype
    model = st.MultivariateNormal(
        torch.as_tensor(np.asarray(mean)).to(dtype),
        torch.as_tensor(np.asarray(cov)).to(dtype),
    )
    return ShardedSVGD(
        model, st.AdaGrad(dim, n, FLAGSHIP_ADAGRAD_LR), n, dim, mesh=group,
        config=ShardedSVGDConfig(**{"fused_phi": True, **config}),
    )


def build_sharded_hier_svgd(x0, features, labels, group=None, **config):
    """``bench.py --config hier``'s model and kernel on the sharded engine
    (the counterpart of ``build_blr_svgd(..., hierarchical=True)``):
    hierarchical BLR, the composed kernel median RBF + 0.1 * I, Adam,
    ``ShardedSVGDConfig(fused_phi=True, **config)`` on ``group``. x0 goes to
    the group's device before the kernel takes its median, once; the fused
    seed reuses it."""
    import svgdcpp_tpu_torch as st

    from ..parallel import (
        ShardedSVGD,
        ShardedSVGDConfig,
        make_particle_group,
        place_replicated,
    )

    group = group if group is not None else make_particle_group()
    x0 = place_replicated(x0, group)
    particles, full_dim = x0.shape
    model = st.HierarchicalBayesianLogisticRegression(features, labels)
    kernel = st.GaussianRBFKernel(x0, st.ScaleMethod.MEDIAN, model) + (
        st.GaussianRBFKernel(
            x0, st.ScaleMethod.CONSTANT,
            constant_scale=HIER_CONSTANT_SCALE
            * np.eye(full_dim, dtype=np.float32),
        )
    )
    return ShardedSVGD(
        model,
        st.Adam(full_dim, particles, BLR_ADAM["lr"], BLR_ADAM["beta1"],
                BLR_ADAM["beta2"]),
        particles, full_dim, mesh=group, kernel=kernel,
        config=ShardedSVGDConfig(**{"fused_phi": True, **config}),
    )
