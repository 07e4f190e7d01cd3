"""svgdcpp_tpu_torch: Stein Variational Gradient Descent in PyTorch + CUDA.

The PyTorch port of ``svgdcpp_tpu`` for an NVIDIA Hopper GPU (H100). It
keeps the JAX package's public surface, layout and names. It covers the
main path, the composed-kernel / BLR path, the anisotropic path, the
large-N paths, the generic (autodiff) route and the sharded engine:
MultivariateNormal, BinomialLikelihood and (hierarchical) Bayesian
logistic regression models (and ``+ - * /`` /
``mixture`` composition), Gaussian-RBF kernels with MEDIAN / HESSIAN /
CONSTANT bandwidth and their ``+ - * /`` compositions (kernels/algebra.py),
AdaGrad / Adam / RMSProp and ``TorchOptimizer`` (any ``torch.optim``
class, the counterpart of ``OptaxOptimizer``), the kernel Stein discrepancy (``ksd_rbf``), the
SVGD class's generic, dense, blocked, fused, fused_cuda, rbf_terms,
fused_terms, fused_terms_cuda, fused_aniso_terms_cuda and cuda routes
(with the intermediate-matrix debug dump, utils/logging.py), checkpoints
(utils/checkpoint.py), the driver's ``SVGDOptions.mesh`` and
``parallel.ShardedSVGD`` (gather mode and the ring schedule) over a
torch.distributed group (``initialize_distributed``,
``make_particle_mesh``). The CUDA routes run
hand-written CUDA kernels, one for each Pallas kernel of the JAX package
(``csrc/``), built with nvcc at their first launch.

The package imports torch and numpy only. Importing it builds nothing and
changes none of torch's global settings.
"""

from .core.exceptions import (
    DimensionMismatchError,
    SVGDError,
    UnsetError,
)
from .core.types import ParticleStore, PrecisionPolicy, as_coords
from .kernels.gaussian_rbf import GaussianRBFKernel, ScaleMethod
from .kernels.kernel import Kernel
from .models.bayesian_logistic_regression import (
    BayesianLogisticRegression,
    HierarchicalBayesianLogisticRegression,
)
from .models.binomial_likelihood import BinomialLikelihood
from .models.model import Model, mixture
from .models.multivariate_normal import MultivariateNormal
from .optimizers.adagrad import AdaGrad
from .optimizers.adam import Adam
from .optimizers.base import Optimizer
from .optimizers.optax_adapter import TorchOptimizer
from .optimizers.rmsprop import RMSProp
from .ops.ksd import ksd_rbf
from .parallel.mesh import initialize_distributed, make_particle_mesh
from .svgd import SVGD, SVGDOptions

__version__ = "1.0.0"  # keep in sync with pyproject.toml

__all__ = [
    "SVGD",
    "SVGDOptions",
    "Model",
    "mixture",
    "MultivariateNormal",
    "BinomialLikelihood",
    "BayesianLogisticRegression",
    "HierarchicalBayesianLogisticRegression",
    "Kernel",
    "GaussianRBFKernel",
    "ScaleMethod",
    "Optimizer",
    "Adam",
    "AdaGrad",
    "RMSProp",
    "TorchOptimizer",
    "ParticleStore",
    "PrecisionPolicy",
    "as_coords",
    "ksd_rbf",
    "initialize_distributed",
    "make_particle_mesh",
    "SVGDError",
    "DimensionMismatchError",
    "UnsetError",
]
