"""Kernel: k(x, x') with autodiff and functional composition.

PyTorch port of ``svgdcpp_tpu.kernels.kernel`` (reference:
include/SVGDCpp/Kernel/Kernel.hpp). The kernel is a pure torch function

    kernel_fn(x, params, location) -> scalar

so the reference's per-location tape re-recording (SVGD.hpp:441-442)
disappears: the location is data. Gradients come from ``torch.func.grad``,
batches from ``torch.func.vmap``.

API parity:
  * ``update_kernel``        <-> Kernel::UpdateKernel (Kernel.hpp:364-367)
  * ``initialize``           <-> Kernel::Initialize (Kernel.hpp:400-415)
  * ``update_location``      <-> Kernel::UpdateLocation (Kernel.hpp:322-330)
  * ``evaluate_kernel``      <-> Kernel.hpp:279-282
  * ``evaluate_kernel_grad`` <-> Kernel.hpp:294-297 (Jacobian w.r.t. x)
  * ``+ - * /`` composition  <-> Kernel.hpp:55-223 (a tree of pure RBF
    kernels runs the SVGD class's closed-form routes through
    kernels/algebra.py)
  * ``step`` hook            <-> Kernel.hpp:356
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.func import grad, vmap

from ..core.exceptions import DimensionMismatchError, UnsetError
from ..core.types import as_tensor
from ..models.model import params_on

KernelFn = Callable[
    [torch.Tensor, Tuple[torch.Tensor, ...], torch.Tensor], torch.Tensor
]


def _as_param_tuple(params) -> Tuple[torch.Tensor, ...]:
    return tuple(as_tensor(p) for p in params)


class Kernel:
    """A kernel function k(x, x'; params) with torch autodiff."""

    def __init__(
        self,
        dimension: int = -1,
        kernel_fn: Optional[KernelFn] = None,
        parameters: Sequence = (),
    ):
        self.dimension = int(dimension)
        self._kernel_fn = kernel_fn
        self.parameters: Tuple[torch.Tensor, ...] = _as_param_tuple(parameters)
        # Location x' (2nd kernel argument), zero-initialized like the
        # reference (Kernel.hpp:45 location_vec_ad_ = Zero(dim)).
        self.location = torch.zeros(max(self.dimension, 0), dtype=torch.float64)

    # ------------------------------------------------------------------
    # Setup / mutation
    # ------------------------------------------------------------------
    def update_kernel(self, kernel_fn: KernelFn):
        """Set the kernel function (reference Kernel.hpp:364-367). A
        replaced function invalidates the composition record and its
        adaptive slots."""
        self._kernel_fn = kernel_fn
        if hasattr(self, "_compose_info"):
            del self._compose_info
        if hasattr(self, "_composed_adaptive_slots"):
            del self._composed_adaptive_slots

    def initialize(self):
        """Validate the kernel (reference Kernel.hpp:400-415)."""
        if self.dimension <= 0:
            raise UnsetError(
                f"Kernel dimension ({self.dimension}) is improperly or not set."
            )
        if self._kernel_fn is None:
            raise UnsetError("Kernel function is unset.")
        return self

    def update_location(self, location):
        """Set the kernel location x' (reference Kernel.hpp:322-330)."""
        location = as_tensor(location).reshape(-1)
        if int(location.shape[0]) != self.dimension:
            raise DimensionMismatchError(
                "Dimension of location vector does not match the kernel's."
            )
        self.location = location

    def update_parameters(self, params: Sequence):
        """Replace kernel parameters (reference Kernel.hpp:334-350 analog)."""
        self.parameters = _as_param_tuple(params)

    def get_parameters(self):
        return list(self.parameters)

    def step(self, coords: Optional[torch.Tensor] = None):
        """Per-iteration hook; default no-op (reference Kernel.hpp:356)."""

    def adaptive_slots(self):
        """[(param_slot_index, owner_kernel)] for per-step bandwidth
        adaptation: base kernels adapt nothing, GaussianRBFKernel
        contributes ``(0, self)``, composed kernels concatenate their
        children's slots with offsets (reference
        GaussianRBFKernel.hpp:143-153)."""
        return list(getattr(self, "_composed_adaptive_slots", []))

    def clone(self) -> "Kernel":
        """Deep copy (reference CloneUnique/SharedPointer, Kernel.hpp:244-257)."""
        return copy.deepcopy(self)

    # ------------------------------------------------------------------
    # Pure functions (torch.func-transformable)
    # ------------------------------------------------------------------
    def kernel_pure(self, x: torch.Tensor, params, location: torch.Tensor) -> torch.Tensor:
        """k(x, location; params) as a pure scalar function."""
        if self._kernel_fn is None:
            raise UnsetError("Kernel function is unset.")
        return torch.as_tensor(self._kernel_fn(x, params, location)).squeeze()

    def kernel_grad_pure(self, x: torch.Tensor, params, location: torch.Tensor) -> torch.Tensor:
        """grad_x k(x, location; params)."""
        return grad(self.kernel_pure)(x, params, location)

    # ------------------------------------------------------------------
    # Evaluate API mirroring the reference (batch-friendly on x)
    # ------------------------------------------------------------------
    def _batched(self, fn, x):
        x = as_tensor(x)
        params = params_on(self.parameters, x.device)
        location = self.location.to(device=x.device, dtype=x.dtype)
        if x.ndim == 2:
            return vmap(lambda xi: fn(xi, params, location))(x)
        return fn(x, params, location)

    def evaluate_kernel(self, x):
        """k(x, x') (reference Kernel.hpp:279-282)."""
        return self._batched(self.kernel_pure, x)

    def evaluate_kernel_grad(self, x):
        """grad_x k(x, x') (reference Kernel.hpp:294-297)."""
        return self._batched(self.kernel_grad_pure, x)

    # ------------------------------------------------------------------
    # Functional composition (reference Kernel.hpp:55-223)
    # ------------------------------------------------------------------
    def _compose(self, other: "Kernel", op, op_name: str) -> "Kernel":
        if not isinstance(other, Kernel):
            return NotImplemented
        if self.dimension != other.dimension:
            raise DimensionMismatchError(
                f"Only kernels with the same variable dimensions can be {op_name}."
            )
        if self._kernel_fn is None or other._kernel_fn is None:
            raise UnsetError(
                "One of the kernel functions is unset; functional composition "
                "requires both kernel functions to be set."
            )
        n1 = len(self.parameters)
        f1 = self.kernel_pure
        f2 = other.kernel_pure

        def fn(x, params, location):
            # Split concatenated parameters (reference Kernel.hpp:77-81).
            return op(
                f1(x, tuple(params[:n1]), location),
                f2(x, tuple(params[n1:]), location),
            )

        composed = Kernel(
            self.dimension,
            kernel_fn=fn,
            parameters=self.parameters + other.parameters,
        )
        composed._composed_adaptive_slots = list(self.adaptive_slots()) + [
            (idx + n1, fn_) for idx, fn_ in other.adaptive_slots()
        ]
        # Structural record for the algebraic dispatch (kernels/algebra.py
        # flatten_rbf_terms); n1 pins the parameter split.
        composed._compose_info = (op_name, self, other, n1)
        return composed

    def __add__(self, other):
        return self._compose(other, lambda a, b: a + b, "added")

    def __sub__(self, other):
        return self._compose(other, lambda a, b: a - b, "subtracted")

    def __mul__(self, other):
        return self._compose(other, lambda a, b: a * b, "multiplied")

    def __truediv__(self, other):
        return self._compose(other, lambda a, b: a / b, "divided")

    # ------------------------------------------------------------------
    # CamelCase aliases
    # ------------------------------------------------------------------
    UpdateKernel = update_kernel
    Initialize = initialize
    UpdateLocation = update_location
    UpdateParameters = update_parameters
    GetParameters = get_parameters

    def Step(self, *args, **kwargs):
        """CamelCase parity spelling of the per-iteration hook; dynamic so a
        subclass overriding only snake_case ``step`` is reached too."""
        return self.step(*args, **kwargs)

    EvaluateKernel = evaluate_kernel
    EvaluateKernelGrad = evaluate_kernel_grad
