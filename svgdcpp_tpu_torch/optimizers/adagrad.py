"""AdaGrad optimizer (reference: include/SVGDCpp/Optimizer/AdaGrad.hpp).

Update: ``s += g^2; inc = lr * g / (eps + sqrt(s))`` (AdaGrad.hpp:60-65).
"""

from __future__ import annotations

import torch

from .base import Optimizer


class AdaGrad(Optimizer):
    def __init__(self, dimension, num_particles, lr, epsilon=1.0e-8):
        super().__init__(dimension, num_particles, lr, epsilon)

    def init(self, dtype=torch.float32, device=None):
        return {"s": self._zeros(dtype, device)}  # AdaGrad.hpp:49-52

    def step(self, state, grad):
        s = state["s"] + grad * grad
        inc = self.learning_rate * grad / (self.stabilizer + torch.sqrt(s))
        return {"s": s}, inc
