from .model import Model, mixture
from .multivariate_normal import MultivariateNormal
from .bayesian_logistic_regression import (
    BayesianLogisticRegression,
    HierarchicalBayesianLogisticRegression,
    make_synthetic_classification,
)
