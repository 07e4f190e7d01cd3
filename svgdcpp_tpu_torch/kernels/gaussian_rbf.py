"""Gaussian RBF kernel with adaptive bandwidth.

PyTorch port of ``svgdcpp_tpu.kernels.gaussian_rbf`` (reference:
include/SVGDCpp/Kernel/GaussianRBFKernel.hpp).

    k(x, x') = exp( -(x - x')^T P (x - x') )        (reference :75-81)

where P is the inverse-scale matrix, recomputed every SVGD step (reference
Step() :141-156) by one of:

  * MEDIAN   -- P = log(n) / median^2 * I, median over ALL n^2 pairwise
                distances including self-zeros (reference :164-187, :66).
  * HESSIAN  -- P = 1/(2 d n) * sum_i -hess log p(x_i) (reference :189-210;
                requires a model).
  * CONSTANT -- fixed user-provided P.
"""

from __future__ import annotations

import enum
import math
from typing import Optional

import torch
from torch.func import vmap

from ..core.exceptions import DimensionMismatchError, UnsetError
from ..core.types import ParticleStore, as_store, as_tensor
from ..models.model import Model, params_on
from ..ops.median import (
    EXACT_MEDIAN_MAX_PARTICLES,
    SELECT_DTYPE,
    fused_median_seed,
    pairwise_distance_median,
    pairwise_distance_median_warm,
)
from .kernel import Kernel


class ScaleMethod(enum.Enum):
    MEDIAN = 0
    HESSIAN = 1
    CONSTANT = 2


def rbf_kernel_fn(x, params, location):
    """k(x, x') = exp(-(x-x')^T P (x-x')) (reference GaussianRBFKernel.hpp:75-81)."""
    diff = x - location
    p = params[0]
    dt = torch.promote_types(diff.dtype, p.dtype)
    diff = diff.to(dt)
    return torch.exp(-(diff @ p.to(dt) @ diff))


def scale_from_median(med, n: int, m: int, dtype) -> torch.Tensor:
    """P = log(n) / median^2 * I, THE bandwidth formula (reference
    GaussianRBFKernel.hpp:187). The scalar is cast to ``dtype`` before the
    product, so a float64 median does not promote a float32 scale."""
    med = torch.as_tensor(med)
    gamma = (math.log(float(n)) / (med * med)).to(dtype)
    return gamma * torch.eye(m, dtype=dtype, device=med.device)


def median_scale(coords: torch.Tensor, median_method: str = "auto",
                 count_env=None) -> torch.Tensor:
    """P = log(n) / median^2 * I (reference GaussianRBFKernel.hpp:179-187);
    ``count_env`` as in ``ops/median.pairwise_distance_median``."""
    n, m = coords.shape
    med = pairwise_distance_median(coords, method=median_method,
                                   count_env=count_env)
    return scale_from_median(med, n, m, coords.dtype)


def hessian_scale(coords: torch.Tensor, hessian_fn, model_params) -> torch.Tensor:
    """P = 1/(2 d n) * sum_i -hess log p(x_i) (reference
    GaussianRBFKernel.hpp:199-209); ``hessian_fn`` is the model's
    ``hessian_log_density_pure``."""
    n, m = coords.shape
    hessians = vmap(lambda x: hessian_fn(x, model_params))(coords)
    return -torch.sum(hessians, dim=0) / (2.0 * m * n)


class GaussianRBFKernel(Kernel):
    """Gaussian RBF kernel sharing the particle store with SVGD."""

    ScaleMethod = ScaleMethod  # nested-enum parity with the reference

    def __init__(
        self,
        coords,
        method: ScaleMethod = ScaleMethod.MEDIAN,
        model: Optional[Model] = None,
        constant_scale=None,
        median_method: str = "auto",
    ):
        store = as_store(coords)
        super().__init__(dimension=store.dimension, kernel_fn=rbf_kernel_fn)
        self.scale_method = method
        self.store: ParticleStore = store
        self.target_model = model
        self.median_method = median_method

        if method == ScaleMethod.HESSIAN and model is None:
            # reference GaussianRBFKernel.hpp:55-58
            raise UnsetError("Hessian-based scale requires a model.")
        if method == ScaleMethod.CONSTANT:
            if constant_scale is None:
                raise UnsetError("Constant scale requires a constant_scale matrix.")
            constant_scale = as_tensor(constant_scale)
            if tuple(constant_scale.shape) != (self.dimension, self.dimension):
                raise DimensionMismatchError(
                    "constant_scale must be (dimension, dimension)."
                )
            self.constant_scale = constant_scale
        else:
            self.constant_scale = None

        #: (a copy of the coordinates, the median method, their median) of
        #: the last MEDIAN scale compute_scale() took, for init_fused_aux.
        self._last_median = None
        # Single inverse-scale parameter slot (reference :71).
        self.update_parameters((self.compute_scale(),))

    # ------------------------------------------------------------------
    @property
    def adaptive(self) -> bool:
        """True when the bandwidth must be recomputed each SVGD step."""
        return self.scale_method in (ScaleMethod.MEDIAN, ScaleMethod.HESSIAN)

    def adaptive_slots(self):
        """This kernel owns one inverse-scale slot (reference :71)."""
        if not self.adaptive:
            return []
        return [(0, self)]

    # -- warm-started median (temporal coherence across SVGD steps) -----
    def init_scale_aux(self, coords):
        """Aux state for warm-started bandwidth selection, or None (only
        the scalable median path uses it): the previous step's per-rank
        distance brackets (hi < lo marks a cold start) and the last
        update's max particle displacement."""
        n = coords.shape[0]
        if (
            self.scale_method != ScaleMethod.MEDIAN
            or self.median_method not in ("auto", "hybrid", "warm")
            or n <= EXACT_MEDIAN_MAX_PARTICLES
        ):
            return None

        def scalar(v):
            return torch.tensor(v, dtype=SELECT_DTYPE, device=coords.device)

        return {
            "lo1": scalar(0.0),
            "hi1": scalar(-1.0),
            "lo2": scalar(0.0),
            "hi2": scalar(-1.0),
            "disp": scalar(0.0),
        }

    def init_fused_aux(self, coords):
        """Aux for the fused phi+median-count pipeline: the initial
        positions' median seeds the lag-1 scale; the bracket starts tight
        around it and is expanded by the movement bound each step.

        The driver seeds it from the coordinates the constructor's scale
        was taken on, so the median compute_scale() kept is reused when
        the coordinates and the method are the same: at N = 10^6 one
        median is minutes of plain count passes on the card."""
        last = self._last_median
        if (
            last is not None
            and last[1] == self.median_method
            and last[0].shape == coords.shape
            and last[0].dtype == coords.dtype
            and last[0].device == coords.device
            and torch.equal(last[0], coords)
        ):
            return fused_median_seed(coords, self.median_method, med=last[2])
        return fused_median_seed(coords, self.median_method)

    def compute_scale_with_aux(self, coords, model_params=None, aux=None,
                               count_env=None):
        """Scale computation threading warm-start aux through the steps.
        ``count_env`` as in :meth:`compute_scale_pure`."""
        if aux is None:
            return self.compute_scale_pure(coords, model_params,
                                           count_env=count_env), None
        n, m = coords.shape
        med, lo1, hi1, lo2, hi2 = pairwise_distance_median_warm(
            coords, aux["lo1"], aux["hi1"], aux["lo2"], aux["hi2"],
            aux["disp"], count_env=count_env,
        )
        scale = scale_from_median(med, n, m, coords.dtype)
        return scale, {
            "lo1": lo1, "hi1": hi1, "lo2": lo2, "hi2": hi2,
            "disp": aux["disp"],
        }

    def compute_scale_pure(self, coords: torch.Tensor, model_params=None,
                           count_env=None) -> torch.Tensor:
        """Pure inverse-scale computation (reference
        GaussianRBFKernel.hpp:164-214). ``count_env`` (a MEDIAN scale on a
        particle group): ``coords`` is the gathered global set and the
        count passes sum the group's rows, see
        ``ops/median.pairwise_distance_median``."""
        if self.scale_method == ScaleMethod.MEDIAN:
            return median_scale(coords, self.median_method, count_env)
        if self.scale_method == ScaleMethod.HESSIAN:
            if model_params is None:
                model_params = params_on(
                    self.target_model.parameters, coords.device
                )
            return hessian_scale(
                coords, self.target_model.hessian_log_density_pure, model_params
            )
        if self.scale_method == ScaleMethod.CONSTANT:
            return self.constant_scale
        raise ValueError("Invalid scale method Enum provided.")

    def compute_scale(self) -> torch.Tensor:
        """Stateful variant reading the shared particle store. A MEDIAN
        scale keeps its median beside a copy of the coordinates
        (``init_fused_aux`` reuses it)."""
        coords = self.store.value
        if self.scale_method != ScaleMethod.MEDIAN:
            return self.compute_scale_pure(coords)
        med = pairwise_distance_median(coords, method=self.median_method)
        self._last_median = (coords.clone(), self.median_method, med)
        n, m = coords.shape
        return scale_from_median(med, n, m, coords.dtype)

    def step(self, coords: Optional[torch.Tensor] = None):
        """Recompute the scale and refill every parameter slot (reference
        Step(), GaussianRBFKernel.hpp:141-156)."""
        if coords is None:
            coords = self.store.value
        scale = self.compute_scale_pure(coords)
        self.update_parameters(tuple(scale for _ in self.parameters))

    ComputeScale = compute_scale
