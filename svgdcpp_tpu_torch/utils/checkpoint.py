"""Checkpoint / resume.

Port of ``svgdcpp_tpu.utils.checkpoint``. The whole SVGD state {coords,
opt_state, kernel_params, model_params, scale_aux, slot_model_params,
iteration} is saved as ``<path>.npz`` plus ``<path>.json`` metadata (the
step and the sorted keys), the JAX package's format: the npz keys are the
"/"-joined dict keys and sequence indices of each leaf, and ``None``
leaves have no key. A state saved by either package restores in the other.

A state of ``parallel.ShardedSVGD`` (its ``init_state``/``run_state``)
holds this rank's rows: saving gathers the rows over the group and rank 0
writes the global arrays; restoring into such an exemplar gives each rank
its own rows again (``ShardedState``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch


def _flatten_with_paths(tree, prefix=()) -> Dict[str, Any]:
    """{key: leaf}: dicts by key (sorted, as JAX orders them), tuples and
    lists by index, ``None`` skipped."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {"/".join(str(p) for p in prefix): tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten_with_paths(v, prefix + (k,)))
    return flat


def _rebuild(tree, fn, prefix=()):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, fn, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn("/".join(str(p) for p in prefix), tree)


def _to_host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _writes() -> bool:
    """Only rank 0 of a distributed run writes (a shared file system is
    assumed, as in the JAX package)."""
    return not (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_rank() != 0)


def save_checkpoint(path, state, step: int = 0):
    """Save an SVGD state and a step counter to ``<path>.npz``/``.json``.

    Leaves are copied to the host; ``iteration`` is saved as an int32 0-d
    array, as the JAX package saves it. A sharded engine's state is
    gathered over its group first (every rank calls this) and rank 0
    writes. Returns the npz path.
    """
    path = Path(path)
    sharded = state if hasattr(state, "to_global") else None
    if sharded is not None:
        state = sharded.to_global()
    flat = {}
    for key, leaf in _flatten_with_paths(state).items():
        arr = _to_host(leaf)
        if key == "iteration":
            arr = np.asarray(arr, dtype=np.int32)
        flat[key] = arr
    if _writes():
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(str(path.with_suffix(".npz")), **flat)
        meta = {"step": int(step), "keys": sorted(flat)}
        path.with_suffix(".json").write_text(json.dumps(meta))
    if sharded is not None:
        sharded.barrier()
    return str(path.with_suffix(".npz"))


def restore_checkpoint(path, state_like):
    """Restore into the structure of ``state_like``; returns (state, step).

    Each leaf takes the exemplar leaf's device and dtype; ``iteration``
    comes back as a Python int. A key of the exemplar missing from the
    file raises KeyError. Restoring into a sharded engine's state gives
    this rank its rows of the saved global arrays.
    """
    path = Path(path)
    data = np.load(str(path.with_suffix(".npz")))
    meta = json.loads(path.with_suffix(".json").read_text())
    flat_like = _flatten_with_paths(state_like)
    missing = set(flat_like) - set(data.files)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)}")

    def load(key, leaf):
        arr = data[key]
        if torch.is_tensor(leaf):
            return torch.from_numpy(np.array(arr)).to(device=leaf.device,
                                                      dtype=leaf.dtype)
        if isinstance(leaf, (bool, int, float)):
            return type(leaf)(arr)
        return np.array(arr)

    state = _rebuild(state_like, load)
    local = getattr(state_like, "from_global", None)
    if local is not None:
        state = local(state)
    return state, int(meta["step"])
