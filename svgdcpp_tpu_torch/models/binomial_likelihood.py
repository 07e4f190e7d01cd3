"""Binomial likelihood model.

PyTorch port of ``svgdcpp_tpu.models.binomial_likelihood``. The
reference's module header (``include/Model:15``) names a
``BinomialLikelihood.hpp`` that its snapshot lacks; this is a working
model of that intent. The target is the binomial likelihood over success
probabilities ``x in (0, 1)^m``:

    f(x) = prod_i C(n_i, k_i) x_i^{k_i} (1 - x_i)^{n_i - k_i}

with ``n`` trials and ``k`` observed successes per coordinate, its
log-density in closed form. Keeping the particles inside the domain is the
caller's job: pair it with SVGD bounds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.exceptions import DimensionMismatchError
from ..core.types import as_tensor
from .model import Model


def binomial_log_density(x, params):
    """log f(x) = sum_i [log C(n_i,k_i) + k_i log x_i + (n_i-k_i) log(1-x_i)]."""
    trials, successes = params[0], params[1]
    log_binom = (
        torch.lgamma(trials + 1.0)
        - torch.lgamma(successes + 1.0)
        - torch.lgamma(trials - successes + 1.0)
    )
    return torch.sum(
        log_binom + successes * torch.log(x)
        + (trials - successes) * torch.log1p(-x)
    )


def binomial_density(x, params):
    return torch.exp(binomial_log_density(x, params))


class BinomialLikelihood(Model):
    """Binomial likelihood over per-coordinate success probabilities."""

    def __init__(self, trials, successes):
        trials = as_tensor(trials).to(torch.float64).reshape(-1)
        successes = as_tensor(successes).to(torch.float64).reshape(-1)
        if trials.shape != successes.shape:
            raise DimensionMismatchError(
                "trials and successes must have the same shape."
            )
        # 0 <= k <= n and n >= 0, checked once here: otherwise
        # lgamma(n-k+1) = inf makes the log-density -inf everywhere while
        # the score stays finite and pushes particles to the boundary.
        t_np, s_np = trials.cpu().numpy(), successes.cpu().numpy()
        if np.any(t_np < 0) or np.any(s_np < 0) or np.any(s_np > t_np):
            raise ValueError(
                "BinomialLikelihood requires 0 <= successes <= trials "
                "(elementwise) and trials >= 0."
            )
        super().__init__(
            dimension=int(trials.shape[0]),
            density_fn=binomial_density,
            log_density_fn=binomial_log_density,
            parameters=(trials, successes),
        )
