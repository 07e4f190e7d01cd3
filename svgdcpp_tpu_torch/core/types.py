"""Core array conventions and precision policy.

Particles are an (n, m) row-major tensor, as in ``svgdcpp_tpu`` (the
reference stores an m x n column-major Eigen matrix, SVGD.hpp:176-181).
Library code follows its inputs: the device and dtype of the coordinates
decide where and in which precision everything downstream runs. Nothing
here changes torch's global defaults.

Two precision modes:
  * parity: float64 (CPU tests against the JAX package)
  * perf:   float32 storage and accumulation (the card)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Array = torch.Tensor


def as_tensor(value, device=None) -> torch.Tensor:
    """Tensor from a tensor, an array or a (nested list of) Python numbers.

    Anything that is not a tensor goes through numpy, so Python floats
    become float64 and arrays keep their dtype: parameters and bounds match
    the JAX package's x64 values exactly (``torch.as_tensor`` would round a
    Python float list to float32).
    """
    if not torch.is_tensor(value):
        value = torch.from_numpy(np.array(value))
    return value if device is None else value.to(device)


def as_coords(x, dtype=None, device=None) -> Array:
    """Canonicalize a particle coordinate array to an (n, m) tensor.

    Accepts (n, m) tensors or array-likes; a tensor keeps its device unless
    ``device`` is given. 1-D input is treated as a single particle (1, m).
    """
    arr = as_tensor(x).to(dtype=dtype, device=device)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2:
        raise ValueError(
            f"coordinates must be 2-D (n, m), got shape {tuple(arr.shape)}"
        )
    return arr


def check_device(device, option="device") -> torch.device:
    """``device`` as a torch.device, the entry points' rule: the card is
    never swapped for the CPU quietly, so a CUDA device without one raises,
    naming ``option``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{option} is 'cuda' (the default) and no CUDA device is "
            "available: pass device=\"cpu\" to run on the CPU, or a "
            "coordinate tensor on the device of your choice."
        )
    return device


def place_coords(coords, device="cuda", option="device") -> Array:
    """Coordinates on the device they run on, the entry points' rule: a
    tensor keeps its device (the caller's choice), anything else goes to
    ``device`` (``check_device``)."""
    if torch.is_tensor(coords):
        return as_coords(coords)
    return as_coords(coords, device=check_device(device, option))


class ParticleStore:
    """Mutable holder for the particle coordinate tensor.

    The reference shares one Eigen matrix between SVGD, the kernel and the
    user (SVGD.hpp:176, GaussianRBFKernel.hpp:52). Components keep a
    reference to the store and SVGD swaps ``store.value`` after each
    run, so the shared-pointer contract holds here as in ``svgdcpp_tpu``.
    """

    def __init__(self, coords):
        self.value = as_coords(coords)

    @property
    def num_particles(self) -> int:
        return int(self.value.shape[0])

    @property
    def dimension(self) -> int:
        return int(self.value.shape[1])


def as_store(coords_or_store) -> ParticleStore:
    if isinstance(coords_or_store, ParticleStore):
        return coords_or_store
    return ParticleStore(coords_or_store)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Dtype policy for the SVGD compute path."""

    coords_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32  # accumulation / reductions

    @staticmethod
    def parity() -> "PrecisionPolicy":
        return PrecisionPolicy(torch.float64, torch.float64)

    @staticmethod
    def perf() -> "PrecisionPolicy":
        return PrecisionPolicy(torch.float32, torch.float32)
