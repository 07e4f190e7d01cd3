"""RMSProp optimizer (reference: include/SVGDCpp/Optimizer/RMSProp.hpp).

Update: ``s = beta s + (1-beta) g^2; inc = lr * g / (eps + sqrt(s))``
(RMSProp.hpp:71-73), with beta validated in [0, 1] (RMSProp.hpp:42-45).
"""

from __future__ import annotations

import torch

from ..core.exceptions import SVGDError
from .base import Optimizer


class RMSProp(Optimizer):
    def __init__(self, dimension, num_particles, lr, beta, epsilon=1.0e-8):
        super().__init__(dimension, num_particles, lr, epsilon)
        if beta > 1.0 or beta < 0.0:
            raise SVGDError("[Argument Error] Invalid value for decay parameter beta.")
        self.beta = float(beta)

    def init(self, dtype=torch.float32, device=None):
        return {"s": self._zeros(dtype, device)}

    def step(self, state, grad):
        s = self.beta * state["s"] + (1.0 - self.beta) * grad * grad
        inc = self.learning_rate * grad / (self.stabilizer + torch.sqrt(s))
        return {"s": s}, inc
