"""Adam optimizer (reference: include/SVGDCpp/Optimizer/Adam.hpp).

Replicates the reference formula EXACTLY, including epsilon BEFORE the
square root in the denominator, ``lr * m_hat / (eps + sqrt(v_hat))``
(Adam.hpp:82), so trajectories match the Eigen implementation.
"""

from __future__ import annotations

import torch

from ..core.exceptions import SVGDError
from .base import Optimizer


class Adam(Optimizer):
    def __init__(self, dimension, num_particles, lr, beta1, beta2, epsilon=1.0e-8):
        super().__init__(dimension, num_particles, lr, epsilon)
        # Validation mirrors Adam.hpp:45-48.
        if beta1 >= 1.0 or beta1 < 0.0 or beta2 >= 1.0 or beta2 < 0.0:
            raise SVGDError("[Argument Error] Invalid value for decay parameter beta.")
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)

    def init(self, dtype=torch.float32, device=None):
        # Zero 1st/2nd moment EMAs + step counter (Adam.hpp:61-67).
        return {
            "m": self._zeros(dtype, device),
            "v": self._zeros(dtype, device),
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    def step(self, state, grad):
        m = self.beta1 * state["m"] + (1.0 - self.beta1) * grad          # Adam.hpp:77
        v = self.beta2 * state["v"] + (1.0 - self.beta2) * grad * grad   # Adam.hpp:78
        count = state["count"] + 1                                       # Adam.hpp:80
        t = count.to(grad.dtype)
        m_hat = m / (1.0 - torch.pow(self.beta1, t))                     # Adam.hpp:93-96
        v_hat = v / (1.0 - torch.pow(self.beta2, t))
        inc = self.learning_rate * m_hat / (self.stabilizer + torch.sqrt(v_hat))  # Adam.hpp:82
        return {"m": m, "v": v, "count": count}, inc
