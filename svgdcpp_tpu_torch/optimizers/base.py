"""Optimizer interface.

PyTorch port of ``svgdcpp_tpu.optimizers.base`` (reference:
include/SVGDCpp/Optimizer/Optimizer.hpp). Optimizers are functional:
``init`` returns a state dict and ``step`` maps ``(state, grad) ->
(state, increment)``. The increment is the position update, applied by the
SVGD class as ``coords += increment`` (SVGD.hpp:393).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..core.types import as_tensor


class Optimizer:
    """Abstract optimizer (reference Optimizer.hpp:28-42)."""

    #: Set True in a subclass whose ``step`` takes a third ``params``
    #: argument (the current particle coordinates). SVGD then calls
    #: ``step(state, grad, coords)``.
    needs_params: bool = False

    def __init__(self, dimension: int, num_particles: int, lr: float,
                 epsilon: float = 1.0e-8):
        self.dimension = int(dimension)
        self.num_particles = int(num_particles)
        self.learning_rate = float(lr)
        self.stabilizer = float(epsilon)

    # Functional API ----------------------------------------------------
    def init(self, dtype=torch.float32, device=None) -> Any:
        """Return a zeroed optimizer state (reference Initialize())."""
        raise NotImplementedError

    def step(self, state: Any, grad: torch.Tensor) -> Tuple[Any, torch.Tensor]:
        """Map (state, grad (n, m)) -> (new_state, increment (n, m))."""
        raise NotImplementedError

    def state_is_particle_sharded(self, state) -> Any:
        """``state``'s structure with a bool per leaf: which leaves are
        particle-major (num_particles, dimension) arrays, split by rows
        over the ranks of the sharded engine (``parallel/sharded.py``).
        Scalars like Adam's step count stay whole on every rank. Override in
        an optimizer whose state carries other matrices."""
        expect = (self.num_particles, self.dimension)

        def mark(x):
            if isinstance(x, dict):
                return {k: mark(v) for k, v in x.items()}
            if isinstance(x, (tuple, list)):
                return type(x)(mark(v) for v in x)
            return tuple(getattr(x, "shape", ())) == expect

        return mark(state)

    def shard_state(self, state, rows: slice) -> Any:
        """One rank's share of a whole optimizer state: the rows ``rows``
        of each particle-major leaf (:meth:`state_is_particle_sharded`),
        every other leaf whole."""
        return _map_pair(
            state, self.state_is_particle_sharded(state),
            lambda x, sharded: x[rows].contiguous() if sharded else x,
        )

    # Convenience: stateful OO parity -----------------------------------
    def initialize(self, dtype=torch.float32, device=None):
        """Reset held state (reference Optimizer::Initialize)."""
        self._state = self.init(dtype, device)
        return self

    def apply(self, grad: torch.Tensor, params=None) -> torch.Tensor:
        """Stateful step for the OO API (reference Optimizer::Step)."""
        grad = as_tensor(grad)
        if not hasattr(self, "_state"):
            self._state = self.init(grad.dtype, grad.device)
        if self.needs_params:
            self._state, inc = self.step(self._state, grad, params)
        else:
            self._state, inc = self.step(self._state, grad)
        return inc

    Initialize = initialize
    Step = apply

    def _zeros(self, dtype, device=None):
        return torch.zeros(
            (self.num_particles, self.dimension), dtype=dtype, device=device
        )


def _map_pair(tree, flags, fn):
    if isinstance(tree, dict):
        return {k: _map_pair(v, flags[k], fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_pair(v, f, fn) for v, f in zip(tree, flags))
    return fn(tree, flags)
