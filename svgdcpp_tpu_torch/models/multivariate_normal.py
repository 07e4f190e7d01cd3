"""Multivariate normal model.

PyTorch port of ``svgdcpp_tpu.models.multivariate_normal`` (reference:
include/SVGDCpp/Model/MultivariateNormal.hpp). The density is the
reference's unnormalized ``exp(-0.5 (x-mu)^T Sigma^{-1} (x-mu))``
(MultivariateNormal.hpp:56-61), solved through a Cholesky factorization,
with a closed-form log-density so the score never goes through exp/log.

Parity surface kept from the reference:
  * params = (mean, covariance) (MultivariateNormal.hpp:49-50)
  * normalization constant 1/((2 pi)^{d/2} |Sigma|^{1/2}), from a host
    float64 slogdet (MultivariateNormal.hpp:182-186)
  * normalized evaluate variants (MultivariateNormal.hpp:143-168)
  * guarded ``update_parameters`` that re-derives the constant
    (MultivariateNormal.hpp:94-115)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.exceptions import DimensionMismatchError, compare_vector_sizes
from ..core.types import as_tensor
from .model import Model


def _mvn_quad(x, params):
    """0.5 (x-mu)^T Sigma^{-1} (x-mu) via Cholesky solve.

    ``cholesky_ex`` rather than ``cholesky``: the latter checks for a
    non-PD input on the host and so waits for the device on every score
    evaluation. ``update_parameters`` has already rejected non-PD input.
    """
    mean, cov = params[0], params[1]
    diff = x - mean.reshape(-1)
    chol, _ = torch.linalg.cholesky_ex(cov.to(diff.dtype))
    w = torch.linalg.solve_triangular(chol, diff[:, None], upper=False)[:, 0]
    return 0.5 * torch.dot(w, w)


def mvn_density(x, params):
    """Unnormalized gaussian density (reference MultivariateNormal.hpp:56-61)."""
    return torch.exp(-_mvn_quad(x, params))


def mvn_log_density(x, params):
    """Unnormalized gaussian log-density: -0.5 (x-mu)^T Sigma^{-1} (x-mu)."""
    return -_mvn_quad(x, params)


class MultivariateNormal(Model):
    """Multivariate normal target with unnormalized/normalized evaluators."""

    def __init__(self, mean, covariance):
        mean = as_tensor(mean).reshape(-1)
        covariance = as_tensor(covariance)
        if not (
            compare_vector_sizes(mean, covariance[:, 0])
            and compare_vector_sizes(mean, covariance[0, :])
        ):
            raise DimensionMismatchError(
                "Dimensions of parameter vectors/matrices do not match."
            )
        super().__init__(
            dimension=int(mean.shape[0]),
            density_fn=mvn_density,
            log_density_fn=mvn_log_density,
            parameters=(mean, covariance),
        )
        self._compute_normalization_constant()

    # ------------------------------------------------------------------
    def update_parameters(self, params):
        """Guarded parameter update (reference MultivariateNormal.hpp:94-115)."""
        mean = as_tensor(params[0]).reshape(-1)
        covariance = as_tensor(params[1])
        if not (
            compare_vector_sizes(mean, covariance[:, 0])
            and compare_vector_sizes(mean, covariance[0, :])
        ):
            raise DimensionMismatchError(
                "Dimensions of parameter vectors/matrices do not match each "
                "other (# of rows must be equal)."
            )
        if int(mean.shape[0]) != self.dimension:
            raise DimensionMismatchError(
                "Dimensions of parameter vectors/matrices do not match "
                "original dimension."
            )
        # Validate (slogdet raises on non-PD) BEFORE mutating any state so
        # a rejected update leaves the model fully on its old parameters.
        log_const = self._derive_log_norm_const(covariance)
        self.parameters = (mean, covariance)
        self._set_norm_const(log_const)

    def _derive_log_norm_const(self, covariance) -> float:
        """log of 1/((2 pi)^{d/2} |Sigma|^{1/2}) (reference
        MultivariateNormal.hpp:182-186), via a host float64 slogdet: a
        float32 determinant over/underflows around d ~ 50. Raises on non-PD
        input."""
        cov = np.asarray(as_tensor(covariance).detach().cpu(), dtype=np.float64)
        sign, logdet = np.linalg.slogdet(cov)
        if sign <= 0:
            raise ValueError("Covariance matrix must be positive definite.")
        return float(
            -0.5 * (self.dimension * math.log(2.0 * math.pi) + logdet)
        )

    def _set_norm_const(self, log_const: float):
        self._log_norm_const = log_const
        # may underflow to 0.0 for large d; use the log form then
        self.norm_const = math.exp(log_const)

    def _compute_normalization_constant(self):
        self._set_norm_const(self._derive_log_norm_const(self.parameters[1]))

    def get_normalization_constant(self) -> float:
        return self.norm_const

    def get_log_normalization_constant(self) -> float:
        """log of the constant, finite even where norm_const underflows."""
        return self._log_norm_const

    # Normalized variants (reference MultivariateNormal.hpp:143-168)
    def evaluate_model_normalized(self, x):
        return self.norm_const * self.evaluate_model(x)

    def evaluate_log_model_normalized(self, x):
        return self._log_norm_const + self.evaluate_log_model(x)

    def evaluate_model_grad_normalized(self, x):
        return self.norm_const * self.evaluate_model_grad(x)

    # CamelCase aliases
    UpdateParameters = update_parameters
    GetNormalizationConstant = get_normalization_constant
    GetLogNormalizationConstant = get_log_normalization_constant
    EvaluateModelNormalized = evaluate_model_normalized
    EvaluateLogModelNormalized = evaluate_log_model_normalized
    EvaluateModelGradNormalized = evaluate_model_grad_normalized
