"""``torch.optim`` adapter: the counterpart of the JAX package's
``OptaxOptimizer``.

optax is JAX-only, so this adapter wraps a ``torch.optim`` class instead
(its schedules aside: Adam, AdamW, SGD with momentum, RMSprop, ...) behind
the ``init``/``step`` contract the driver uses.

Sign convention, as in the JAX adapter: SVGD moves the particles ALONG phi,
and a torch optimizer DESCENDS its gradient, so the adapter feeds it
``-phi`` and returns the position increment the optimizer made.

The adapter is functional: ``step`` builds a fresh optimizer around a fresh
leaf every call and loads a copy of the given state into it, so nothing
survives between calls inside the wrapper. Hot-swaps, checkpoints
(``utils/checkpoint.py``) and row-sharded states (``Optimizer.shard_state``)
see a plain dict of tensors.
"""

from __future__ import annotations

from typing import Any

import torch

from .base import Optimizer


def _copy(value):
    return value.clone() if torch.is_tensor(value) else value


class TorchOptimizer(Optimizer):
    """Wrap a ``torch.optim.Optimizer`` class as an SVGD optimizer.

    >>> opt = TorchOptimizer(torch.optim.Adam, dimension, num_particles,
    ...                      lr=1e-1)

    ``hyperparameters`` go to ``optimizer_cls`` as they are (``lr``,
    ``betas``, ``weight_decay``, ``foreach``, ``fused``, ...).

    The state is ``{"steps": int64 0-d CPU tensor, "param": {...}}``:
    ``param`` is the wrapped optimizer's per-parameter state (Adam's
    ``exp_avg``, ``exp_avg_sq`` and ``step``, ...). A torch optimizer makes
    that state at its first step, so ``init`` takes its structure from one
    step of a throwaway optimizer on a zero gradient, and ``steps`` = 0
    tells ``step`` to let the optimizer start afresh instead of loading
    those placeholders. The (num_particles, dimension) leaves are
    particle-major, every other leaf stays whole on every rank.
    """

    needs_params = True  # drivers pass the current coords through

    def __init__(self, optimizer_cls, dimension: int, num_particles: int,
                 **hyperparameters):
        # lr lives in the hyperparameters; base lr/stabilizer are unused.
        super().__init__(dimension, num_particles, lr=0.0)
        self.optimizer_cls = optimizer_cls
        self.hyperparameters = dict(hyperparameters)

    def _run(self, param_state, grad, params):
        """One step of a fresh optimizer from ``param_state`` (None: its
        own fresh state): (its new per-parameter state, leaf - params)."""
        leaf = params.detach().clone()
        opt = self.optimizer_cls([leaf], **self.hyperparameters)
        if param_state is not None:
            opt.state[leaf] = {k: _copy(v) for k, v in param_state.items()}
        # A torch optimizer descends its gradient; SVGD ascends along phi.
        leaf.grad = -grad.detach()
        opt.step()
        return dict(opt.state[leaf]), leaf.detach() - params.detach()

    def init(self, dtype=torch.float32, device=None) -> Any:
        zeros = self._zeros(dtype, device)
        placeholders, _ = self._run(None, zeros, zeros)
        return {"steps": torch.zeros((), dtype=torch.int64),
                "param": placeholders}

    def step(self, state, grad, params=None):
        """(state, phi (n, m), coords (n, m)) -> (new state, increment).
        ``params`` None takes a zero leaf, enough for an optimizer that
        does not read the coordinates (weight decay does)."""
        if params is None:
            params = torch.zeros_like(grad)
        started = int(state["steps"]) > 0
        param_state, inc = self._run(
            state["param"] if started else None, grad, params)
        return {"steps": state["steps"] + 1, "param": param_state}, inc
