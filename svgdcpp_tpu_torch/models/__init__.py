from .model import Model, mixture
from .multivariate_normal import MultivariateNormal
