"""Carry an SVGD state between the JAX package and this one.

``svgdcpp_tpu.SVGD.make_state()`` and ``svgdcpp_tpu_torch.SVGD.make_state()``
have the same keys: coords, opt_state, kernel_params, model_params,
scale_aux, slot_model_params and iteration. ``state_from_numpy`` takes the
JAX state after ``jax.device_get`` (numpy leaves) and returns this
package's; ``state_to_numpy`` goes back. So one step can be taken in each
package from the same state and the results compared.
``sharded_state_from_numpy`` takes the state of the JAX package's
``ShardedSVGD`` and returns one rank's state of this package's engine.

Floating leaves take ``dtype``, except ``scale_aux`` (the median selection
state), which stays float64 as in ops/median.SELECT_DTYPE. Integer leaves
(Adam's step count) keep their integer type. Tuples keep their length and
order, so a composed kernel's flat parameter tuple and a BLR model's
(features, labels, ...) carry across slot for slot.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import check_device
from ..ops.median import SELECT_DTYPE


def _leaf_to_torch(x, device, dtype):
    arr = np.asarray(x)
    t = torch.from_numpy(np.array(arr)).to(device)
    if arr.dtype.kind == "f":
        t = t.to(dtype)
    return t


def _map(tree, fn):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map(v, fn) for v in tree)
    return fn(tree)


def state_from_numpy(np_state, device="cuda", dtype=torch.float64) -> dict:
    """This package's SVGD state from a JAX ``make_state()`` pytree with
    numpy leaves, on ``device``: the card by default, as every entry point
    of the package; without a CUDA device that default raises (pass
    ``device="cpu"``)."""
    device = check_device(device, "state_from_numpy's device")

    def conv(dt):
        return lambda x: _leaf_to_torch(x, device, dt)

    return {
        "coords": conv(dtype)(np_state["coords"]),
        "opt_state": _map(np_state["opt_state"], conv(dtype)),
        "kernel_params": _map(np_state["kernel_params"], conv(dtype)),
        "model_params": _map(np_state["model_params"], conv(dtype)),
        "scale_aux": _map(np_state["scale_aux"], conv(SELECT_DTYPE)),
        "slot_model_params": _map(np_state["slot_model_params"], conv(dtype)),
        "iteration": int(np.asarray(np_state["iteration"])),
    }


def state_to_numpy(state) -> dict:
    """The reverse: every tensor leaf to a numpy array on the host."""

    def conv(x):
        if torch.is_tensor(x):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    out = {k: _map(v, conv) for k, v in state.items() if k != "iteration"}
    out["iteration"] = np.asarray(state["iteration"], dtype=np.int32)
    return out


def sharded_state_from_numpy(np_state, optimizer, rank: int, world_size: int,
                             device="cuda", dtype=torch.float64) -> dict:
    """One rank's state of ``parallel/sharded.ShardedSVGD`` from the JAX
    package's sharded state (``ShardedSVGD.init_state``/``run_state``,
    numpy leaves after ``jax.device_get``): the leaves as in
    :func:`state_from_numpy`, then this rank's contiguous rows of the
    coordinates and, through ``optimizer.shard_state`` (the engine's own
    split), of the engine optimizer's particle-major leaves; the other
    leaves, scalars and parameters, whole on every rank."""
    state = state_from_numpy(np_state, device, dtype)
    n = state["coords"].shape[0]
    if n % world_size or not 0 <= rank < world_size:
        raise ValueError(
            f"rank {rank} of {world_size}: {n} particles do not split evenly"
        )
    local = n // world_size
    rows = slice(rank * local, (rank + 1) * local)
    state["coords"] = state["coords"][rows].contiguous()
    state["opt_state"] = optimizer.shard_state(state["opt_state"], rows)
    return state
