"""Bayesian logistic regression targets.

PyTorch port of ``svgdcpp_tpu.models.bayesian_logistic_regression``
(BASELINE.md measurement configs 3-4). Two targets:

  * :class:`BayesianLogisticRegression` -- particles are weight vectors
    w in R^d; fixed Gaussian prior precision alpha:

        log p(w) = sum_i log sigmoid(y_i x_i . w) - alpha/2 ||w||^2

  * :class:`HierarchicalBayesianLogisticRegression` -- the Liu & Wang
    (2016) hierarchical setup: particles are [w, log alpha] in R^{d+1} with
    a Gamma(a0, b0) prior on the precision alpha:

        log p(w, log a) = sum_i log sigmoid(y_i x_i . w)
                          + d/2 log a - a/2 ||w||^2
                          + a0 log a - b0 a

Both override the score with its closed form (two contractions with the
data matrix instead of an autodiff pass), as the JAX package does. The
parameters keep the dtype they are given (float64 from numpy); the SVGD
class casts them to the coordinates' dtype where a step takes them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.exceptions import DimensionMismatchError
from ..core.types import as_tensor
from .model import Model


def blr_log_density(x, params):
    features, labels, alpha = params
    logits = features @ x  # (N_data,)
    loglik = torch.sum(F.logsigmoid(labels * logits))
    return loglik - 0.5 * alpha * torch.sum(x * x)


def _data(features, labels):
    features = as_tensor(features)
    labels = as_tensor(labels).reshape(-1).to(features.dtype)
    if features.shape[0] != labels.shape[0]:
        raise DimensionMismatchError(
            "features and labels must agree on the data axis."
        )
    return features, labels


class BayesianLogisticRegression(Model):
    """Logistic-regression posterior over weights with Gaussian prior."""

    def __init__(self, features, labels, prior_precision: float = 0.01):
        features, labels = _data(features, labels)
        super().__init__(
            dimension=int(features.shape[1]),
            density_fn=lambda x, p: torch.exp(blr_log_density(x, p)),
            log_density_fn=blr_log_density,
            parameters=(
                features, labels,
                torch.tensor(float(prior_precision), dtype=features.dtype),
            ),
        )

    def grad_log_density_pure(self, x, params):
        """Closed-form score (reference virtual-override pattern,
        Model.hpp:335-338):

            grad_w log p = sum_i sigmoid(-y_i z_i) y_i x_i - alpha w
        """
        features, labels, alpha = params
        logits = features @ x
        s = torch.sigmoid(-labels * logits)
        return ((s * labels) @ features - alpha * x).to(x.dtype)


def hier_blr_log_density(x, params):
    features, labels, a0, b0 = params
    d = features.shape[1]
    w = x[:d]
    log_alpha = x[d]
    alpha = torch.exp(log_alpha)
    logits = features @ w
    loglik = torch.sum(F.logsigmoid(labels * logits))
    log_prior_w = 0.5 * d * log_alpha - 0.5 * alpha * torch.sum(w * w)
    # Gamma(a0, b0) density on alpha plus the log-parametrization Jacobian
    # (d alpha = alpha d log_alpha): (a0 - 1) log a + log a = a0 log a.
    log_prior_alpha = a0 * log_alpha - b0 * alpha
    return loglik + log_prior_w + log_prior_alpha


class HierarchicalBayesianLogisticRegression(Model):
    """Hierarchical BLR: particles are [w (d), log alpha] in R^{d+1}."""

    def __init__(self, features, labels, a0: float = 1.0, b0: float = 0.01):
        features, labels = _data(features, labels)
        super().__init__(
            dimension=int(features.shape[1]) + 1,
            density_fn=lambda x, p: torch.exp(hier_blr_log_density(x, p)),
            log_density_fn=hier_blr_log_density,
            parameters=(
                features,
                labels,
                torch.tensor(float(a0), dtype=features.dtype),
                torch.tensor(float(b0), dtype=features.dtype),
            ),
        )

    def grad_log_density_pure(self, x, params):
        """Closed-form score in [w, log alpha] (see BayesianLogisticRegression;
        the log-alpha component is d/2 - a/2 ||w||^2 + a0 - b0 a)."""
        features, labels, a0, b0 = params
        d = features.shape[1]
        w, log_a = x[:d], x[d]
        a = torch.exp(log_a)
        logits = features @ w
        s = torch.sigmoid(-labels * logits)
        score_w = (s * labels) @ features - a * w
        score_la = 0.5 * d - 0.5 * a * torch.sum(w * w) + a0 - b0 * a
        return torch.cat(
            [score_w, score_la.to(score_w.dtype).reshape(1)]
        ).to(x.dtype)


def make_synthetic_classification(rng, n_data: int = 512, dim: int = 50,
                                  w_scale: float = 2.0):
    """Deterministic synthetic two-class data for examples and benchmarks:
    (features (n_data, dim), labels (n_data,) in {-1, 1}, true_w (dim,)),
    float64 tensors, drawing from the numpy Generator ``rng`` in the JAX
    package's order (true_w, features, then the label uniforms)."""
    true_w = w_scale * rng.standard_normal(dim) / (dim ** 0.5)
    features = rng.standard_normal((n_data, dim))
    logits = features @ true_w
    labels = np.where(
        rng.uniform(size=n_data) < 1.0 / (1.0 + np.exp(-logits)), 1.0, -1.0
    )
    return (
        torch.from_numpy(features), torch.from_numpy(labels),
        torch.from_numpy(true_w),
    )
