from .kernel import Kernel
from .gaussian_rbf import GaussianRBFKernel, ScaleMethod
