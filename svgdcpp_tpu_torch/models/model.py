"""Model: a target density with autodiff and functional composition.

PyTorch port of ``svgdcpp_tpu.models.model`` (reference:
include/SVGDCpp/Model/Model.hpp). The user supplies plain torch functions

    density_fn(x, params)      -> scalar      (f(x; theta) >= 0)
    log_density_fn(x, params)  -> scalar      (optional; defaults to log(f))

with ``x`` an (m,) tensor and ``params`` a tuple of tensors. Derivatives come
from ``torch.func`` (``grad``, ``jacfwd``, ``hessian``) and batches from
``torch.func.vmap``, so the functions must be written in torch ops that
``torch.func`` can transform (no in-place updates, no ``.item()``).

API parity with the reference:
  * ``update_model``            <-> Model::UpdateModel (Model.hpp:421-424)
  * ``initialize``              <-> Model::Initialize (Model.hpp:268-278)
  * ``evaluate_model`` etc.     <-> Model::Evaluate* (Model.hpp:290-370)
  * ``update_parameters``/``get_parameters`` <-> Model.hpp:377-406
  * ``step``                    <-> per-iteration hook (Model.hpp:413)
  * ``+ - * /`` composition     <-> Model.hpp:55-227 (parameter tuples are
    concatenated and split inside the composed function, Model.hpp:80-81)
  * ``clone``                   <-> CloneUniquePointer/CloneSharedPointer
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

from ..core.exceptions import DimensionMismatchError, UnsetError
from ..core.types import as_tensor

DensityFn = Callable[[torch.Tensor, Tuple[torch.Tensor, ...]], torch.Tensor]


def _as_param_tuple(params) -> Tuple[torch.Tensor, ...]:
    return tuple(as_tensor(p) for p in params)


def params_on(params, device, dtype=None) -> Tuple[torch.Tensor, ...]:
    """The parameter tuple moved to ``device``; with ``dtype``, floating
    parameters are cast to it (integer ones keep theirs)."""
    return tuple(
        p.to(device=device, dtype=dtype)
        if dtype is not None and p.is_floating_point()
        else p.to(device)
        for p in params
    )


class Model:
    """A target density f(x; params) >= 0 with torch autodiff.

    Used directly by supplying a density function, or subclassed (see
    :class:`~svgdcpp_tpu_torch.models.multivariate_normal.MultivariateNormal`).
    Subclasses may pass a closed-form ``log_density_fn`` to bypass the
    ``log(f)`` composition, the analog of overriding the virtual
    ``Evaluate*`` methods in the reference (Model.hpp:282-370).
    """

    def __init__(
        self,
        dimension: int = -1,
        density_fn: Optional[DensityFn] = None,
        log_density_fn: Optional[DensityFn] = None,
        parameters: Sequence = (),
    ):
        self.dimension = int(dimension)
        self._density_fn = density_fn
        self._log_density_fn = log_density_fn
        self.parameters: Tuple[torch.Tensor, ...] = _as_param_tuple(parameters)

    # ------------------------------------------------------------------
    # Setup / mutation
    # ------------------------------------------------------------------
    def update_model(self, density_fn: DensityFn, log_density_fn: Optional[DensityFn] = None):
        """Set the model's density function (reference Model.hpp:421-424)."""
        self._density_fn = density_fn
        self._log_density_fn = log_density_fn

    def initialize(self):
        """Validate the model (reference Model.hpp:268-278)."""
        if self.dimension <= 0:
            raise UnsetError(
                f"Model dimension ({self.dimension}) is improperly or not set."
            )
        if self._density_fn is None and self._log_density_fn is None:
            raise UnsetError("Model function is unset.")
        return self

    def update_parameters(self, params: Sequence):
        """Replace model parameters (reference Model.hpp:377-388)."""
        self.parameters = _as_param_tuple(params)

    def get_parameters(self):
        """Return model parameters (reference Model.hpp:395-406)."""
        return list(self.parameters)

    def step(self):
        """Per-iteration hook; default no-op (reference Model.hpp:413)."""

    def clone(self) -> "Model":
        """Deep copy (reference CloneUnique/SharedPointer, Model.hpp:248-261)."""
        return copy.deepcopy(self)

    # ------------------------------------------------------------------
    # Pure functions (torch.func-transformable)
    # ------------------------------------------------------------------
    def density_pure(self, x: torch.Tensor, params) -> torch.Tensor:
        """f(x; params) as a pure scalar function of (x, params)."""
        if self._density_fn is None:
            if self._log_density_fn is None:
                raise UnsetError("Model function is unset.")
            return torch.exp(self._log_density_fn(x, params))
        return torch.as_tensor(self._density_fn(x, params)).squeeze()

    def log_density_pure(self, x: torch.Tensor, params) -> torch.Tensor:
        """log f(x; params) as a pure scalar function.

        Defaults to ``log(density)`` exactly like the reference's
        ``LogModelFun`` (Model.hpp:451-454).
        """
        if self._log_density_fn is not None:
            return torch.as_tensor(self._log_density_fn(x, params)).squeeze()
        return torch.log(self.density_pure(x, params))

    def grad_log_density_pure(self, x: torch.Tensor, params) -> torch.Tensor:
        """score: grad_x log f(x; params).

        Subclasses may override with a closed form; SVGD routes the
        score through this method, so an override takes effect there.
        """
        return grad(self.log_density_pure)(x, params)

    def hessian_log_density_pure(self, x: torch.Tensor, params) -> torch.Tensor:
        """hess_x log f(x; params), the Jacobian of the SCORE (so a
        closed-form score override propagates to every Hessian consumer)."""
        return jacfwd(self.grad_log_density_pure)(x, params)

    # ------------------------------------------------------------------
    # Evaluate*: stateful convenience API mirroring the reference.
    # Each accepts a single particle (m,) or a batch (n, m).
    # ------------------------------------------------------------------
    def _batched(self, fn, x):
        x = as_tensor(x)
        params = params_on(self.parameters, x.device)
        if x.ndim == 2:
            return vmap(lambda xi: fn(xi, params))(x)
        return fn(x, params)

    def evaluate_model(self, x):
        """f(x) (reference Model.hpp:290-293)."""
        return self._batched(self.density_pure, x)

    def evaluate_log_model(self, x):
        """log f(x) (reference Model.hpp:305-308)."""
        return self._batched(self.log_density_pure, x)

    def evaluate_model_grad(self, x):
        """grad f(x) (reference Model.hpp:320-323)."""
        return self._batched(grad(self.density_pure), x)

    def evaluate_log_model_grad(self, x):
        """grad log f(x) (reference Model.hpp:335-338)."""
        return self._batched(grad(self.log_density_pure), x)

    def evaluate_model_hessian(self, x):
        """hessian f(x) (reference Model.hpp:350-354)."""
        return self._batched(hessian(self.density_pure), x)

    def evaluate_log_model_hessian(self, x):
        """hessian log f(x) (reference Model.hpp:366-370)."""
        return self._batched(self.hessian_log_density_pure, x)

    # ------------------------------------------------------------------
    # Functional composition (reference Model.hpp:55-227)
    # ------------------------------------------------------------------
    def _compose(self, other: "Model", op, op_name: str, log_op=None) -> "Model":
        if not isinstance(other, Model):
            return NotImplemented
        if self.dimension != other.dimension:
            raise DimensionMismatchError(
                f"Only models with the same variable dimensions can be {op_name}."
            )
        if (self._density_fn is None and self._log_density_fn is None) or (
            other._density_fn is None and other._log_density_fn is None
        ):
            raise UnsetError(
                "One of the model functions is unset; functional composition "
                "requires both model functions to be set."
            )
        n1 = len(self.parameters)
        f1 = self.density_pure
        f2 = other.density_pure
        l1 = self.log_density_pure
        l2 = other.log_density_pure

        def fn(x, params):
            # Split the concatenated parameter tuple back into the two
            # operands' parameter sets (reference Model.hpp:80-81).
            return op(f1(x, tuple(params[:n1])), f2(x, tuple(params[n1:])))

        # Stable log-space composition: each operator has an exact log-space
        # form; '-' keeps the reference's NaN for a negative composed
        # density (log1p of a value <= -1).
        if log_op is not None:

            def log_fn(x, params):
                return log_op(
                    l1(x, tuple(params[:n1])), l2(x, tuple(params[n1:]))
                )

        else:
            log_fn = None

        return Model(
            self.dimension,
            density_fn=fn,
            log_density_fn=log_fn,
            parameters=self.parameters + other.parameters,
        )

    def __add__(self, other):
        return self._compose(other, lambda a, b: a + b, "added",
                             log_op=torch.logaddexp)

    def __sub__(self, other):
        return self._compose(
            other, lambda a, b: a - b, "subtracted",
            log_op=lambda a, b: a + torch.log1p(-torch.exp(b - a)),
        )

    def __mul__(self, other):
        return self._compose(other, lambda a, b: a * b, "multiplied",
                             log_op=lambda a, b: a + b)

    def __truediv__(self, other):
        return self._compose(other, lambda a, b: a / b, "divided",
                             log_op=lambda a, b: a - b)

    # ------------------------------------------------------------------
    # CamelCase aliases
    # ------------------------------------------------------------------
    UpdateModel = update_model
    Initialize = initialize
    UpdateParameters = update_parameters
    GetParameters = get_parameters

    def Step(self, *args, **kwargs):
        """CamelCase parity hook; dynamic so a snake_case ``step`` override
        is reachable through it (see Kernel.Step)."""
        return self.step(*args, **kwargs)

    EvaluateModel = evaluate_model
    EvaluateLogModel = evaluate_log_model
    EvaluateModelGrad = evaluate_model_grad
    EvaluateLogModelGrad = evaluate_log_model_grad
    EvaluateModelHessian = evaluate_model_hessian
    EvaluateLogModelHessian = evaluate_log_model_hessian


def mixture(models: Sequence[Model], weights: Optional[Sequence[float]] = None) -> Model:
    """Numerically stable mixture density in log-space (``logsumexp`` of the
    weighted component log-densities). Parameter tuples are concatenated in
    model order, like ``operator+``."""
    models = list(models)
    if not models:
        raise UnsetError("mixture() requires at least one model.")
    dim = models[0].dimension
    for m in models[1:]:
        if m.dimension != dim:
            raise DimensionMismatchError(
                "Only models with the same variable dimensions can be mixed."
            )
    sizes = [len(m.parameters) for m in models]
    offsets = [0]
    for s in sizes:
        offsets.append(offsets[-1] + s)
    log_fns = [m.log_density_pure for m in models]
    if weights is None:
        log_w_np = np.zeros(len(models))
    else:
        log_w_np = np.log(np.asarray(weights, dtype=np.float64))
    log_w = torch.from_numpy(log_w_np)

    def log_fn(x, params):
        logs = torch.stack(
            [
                f(x, tuple(params[offsets[i] : offsets[i + 1]]))
                for i, f in enumerate(log_fns)
            ]
        )
        return torch.logsumexp(logs + log_w.to(logs), dim=0)

    all_params = sum((m.parameters for m in models), ())
    return Model(dim, log_density_fn=log_fn, parameters=all_params)
