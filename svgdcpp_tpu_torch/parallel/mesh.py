"""Particle groups: the ranks that share one particle set.

Port of ``svgdcpp_tpu.parallel.mesh``. The JAX package shards the particle
axis over a 1-D device mesh; here the counterpart is a ``torch.distributed``
process group in which each rank owns a contiguous block of the particles
on its own device. A ``ParticleGroup`` carries the process group, this
rank, the world size, the device and the collectives the sharded engine
needs (``parallel/sharded.py``): a row gather, a sum and a max, and the
ring schedule's rotation (``parallel/ring.py``).

Backends: NCCL for ranks on CUDA devices, one card each; gloo for the CPU,
and for ranks that share one card (NCCL refuses two ranks on one device).
gloo runs its collectives on host tensors, so a CUDA tensor goes through
the host on a gloo group; an NCCL group never does.

Nothing tells a process of a cluster: the caller gives
``initialize_distributed`` its rendezvous address (``tcp://host:port``),
the world size and the rank, or launches it with torchrun (``env://``);
with neither it makes a one-rank world.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.types import as_coords, check_device


@dataclasses.dataclass(frozen=True)
class ParticleGroup:
    """The ranks of one particle set (the counterpart of the JAX package's
    particle mesh): ``group`` the torch.distributed process group (None for
    the default group), this ``rank``, the ``world_size``, this rank's
    ``device`` and the group's ``backend``."""

    group: Any
    rank: int
    world_size: int
    device: torch.device
    backend: str

    @property
    def _through_host(self) -> bool:
        return self.backend == "gloo" and self.device.type != "cpu"

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group (a new tensor on t's device)."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the group."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def _all_reduce(self, t, op):
        out = t.detach().to("cpu" if self._through_host else t.device,
                            copy=True).contiguous()
        dist.all_reduce(out, op=op, group=self.group)
        return out.to(t.device)

    def all_gather_rows(self, t: torch.Tensor,
                        num_particles: Optional[int] = None) -> torch.Tensor:
        """Every rank's ``t`` (its rows, ...) stacked in rank order: the
        global (num_particles, ...) array. ``num_particles`` None: every
        rank holds as many rows as this one. Otherwise the ranks hold
        their :meth:`rows` of it, which may differ by one: the transport
        buffer is padded to the largest share and each part is trimmed to
        its rank's rows (the padding never reaches the result)."""
        src = t.detach().to("cpu" if self._through_host else t.device)
        src = src.contiguous()
        shares = [src.shape[0]] * self.world_size
        if num_particles is not None:
            shares = [self.share(num_particles, r)
                      for r in range(self.world_size)]
            if src.shape[0] != shares[self.rank]:
                raise ValueError(
                    f"rank {self.rank} holds {src.shape[0]} rows, its share "
                    f"of {num_particles} is {shares[self.rank]}")
        width = max(shares)
        if src.shape[0] < width:
            pad = src.new_zeros((width - src.shape[0],) + tuple(src.shape[1:]))
            src = torch.cat([src, pad], dim=0)
        if self.backend == "nccl":
            out = torch.empty((self.world_size * width,)
                              + tuple(src.shape[1:]),
                              dtype=src.dtype, device=src.device)
            dist.all_gather_into_tensor(out, src, group=self.group)
            parts = out.split(width, dim=0)
        else:
            parts = [torch.empty_like(src) for _ in range(self.world_size)]
            dist.all_gather(parts, src, group=self.group)
            out = None
        if out is None or min(shares) < width:
            out = torch.cat([p[:k] for p, k in zip(parts, shares)], dim=0)
        return out.to(t.device)

    def rotate(self, t: torch.Tensor) -> torch.Tensor:
        """One step of the ring (the JAX package's ``_rotate``): send ``t``
        to rank (rank + 1) % world_size and return what rank
        (rank - 1) % world_size sent, a tensor of the same shape and dtype
        on t's device. Every rank of the group calls it. The send and the
        receive go in one batch and both are waited on before the result
        is read (at world 2 they have the same peer). At world 1 it is
        ``t`` itself and nothing is sent."""
        if self.world_size == 1:
            return t
        src = t.detach().to("cpu" if self._through_host else t.device)
        src = src.contiguous()
        out = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, self._peer(self.rank + 1),
                          group=self.group),
               dist.P2POp(dist.irecv, out, self._peer(self.rank - 1),
                          group=self.group)]
        for request in dist.batch_isend_irecv(ops):
            request.wait()
        return out.to(t.device)

    def _peer(self, rank: int) -> int:
        """The global rank of this group's rank ``rank`` modulo its size
        (what a point-to-point op names)."""
        rank %= self.world_size
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)

    def share(self, num_particles: int, rank: Optional[int] = None) -> int:
        """How many rows of ``num_particles`` a rank (this one by default)
        holds: the split of :meth:`rows`."""
        rank = self.rank if rank is None else rank
        base, extra = divmod(num_particles, self.world_size)
        return base + (rank < extra)

    def rows(self, num_particles: int) -> slice:
        """This rank's rows of a global (num_particles, m) array.

        The one split of every row placement (``place_sharded``, the
        driver's state under ``SVGDOptions.mesh``, ``Optimizer.shard_state``,
        sharded checkpoints, the debug dump's gather): contiguous blocks in
        rank order, the first ``num_particles % world_size`` ranks one row
        more than the others (``numpy.array_split``'s rule), so no rank
        is left empty while another has two rows more. An even count
        gives every rank ``num_particles // world_size`` rows."""
        base, extra = divmod(num_particles, self.world_size)
        start = self.rank * base + min(self.rank, extra)
        return slice(start, start + self.share(num_particles))


def local_rank(rank: int) -> int:
    """This process's index among the ranks of its host: LOCAL_RANK when the
    launcher sets it, else the rank modulo the host's CUDA devices."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(1, torch.cuda.device_count())


#: The default process group initialize_distributed made, and its
#: ParticleGroup.
_initialized: Optional[tuple] = None


def make_particle_group(group=None, device=None) -> ParticleGroup:
    """The ParticleGroup of an initialized torch.distributed process group
    (the default group when ``group`` is None; the counterpart of
    ``make_particle_mesh``). ``device`` is this rank's device: by default
    the one :func:`initialize_distributed` gave the default group, else
    ``cuda:<local rank>``, which raises without a CUDA device; pass
    ``"cpu"`` to run on the CPU."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call initialize_distributed"
            "() first (a one-rank world without arguments)"
        )
    if (device is None and group is None and _initialized is not None
            and _initialized[0] is dist.group.WORLD):
        return _initialized[1]
    rank = dist.get_rank(group)
    world = dist.get_world_size(group)
    backend = str(dist.get_backend(group))
    if device is None:
        device = torch.device("cuda", local_rank(rank))
    device = check_device(device, "the particle group's device")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL group runs on CUDA devices; use gloo for "
                         f"the CPU (device {device})")
    return ParticleGroup(group, rank, world, device, backend)


def make_particle_mesh(group=None, device=None) -> ParticleGroup:
    """The JAX package's name for :func:`make_particle_group`, which, like
    the JAX mesh over the visible devices, needs no set-up: without a
    process group it makes a one-rank world (initialize_distributed)."""
    if group is None and not dist.is_initialized():
        return initialize_distributed(device=device)
    return make_particle_group(group, device)


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None) -> ParticleGroup:
    """Join this process to a world of ``world_size`` ranks as ``rank``
    (the counterpart of ``initialize_distributed``) and return its
    ParticleGroup.

    ``init_method`` is the rendezvous, e.g. ``tcp://localhost:<port>``,
    with ``world_size`` and ``rank``. Without it: torchrun's ``env://``
    when its RANK and WORLD_SIZE are set (``world_size`` and ``rank``
    default to them), else a one-rank world in this process. A call once
    the default group exists returns its ParticleGroup (on ``device`` if
    given). ``backend`` defaults to NCCL for a CUDA device and gloo for the
    CPU; ranks that share one card pass "gloo". ``device`` as in
    :func:`make_particle_group`."""
    global _initialized
    if dist.is_initialized():
        return make_particle_group(device=device)
    store = None
    if init_method is None and "RANK" in os.environ \
            and "WORLD_SIZE" in os.environ:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"] if world_size is None
                         else world_size)
        rank = int(os.environ["RANK"] if rank is None else rank)
    elif init_method is None:
        if world_size not in (None, 1) or rank not in (None, 0):
            raise ValueError(
                f"world_size={world_size}, rank={rank} without a rendezvous: "
                "pass init_method (a world of more than one rank must not "
                "fall back to one rank per process)"
            )
        store, world_size, rank = dist.HashStore(), 1, 0
    elif world_size is None or rank is None:
        raise ValueError(f"init_method {init_method!r} needs world_size and "
                         "rank")
    if device is None:
        device = torch.device("cuda", local_rank(rank))
    device = check_device(device, "the particle group's device")
    if device.type == "cuda" and device.index is None:
        # "cuda" names this rank's card, as the default does.
        device = torch.device("cuda", local_rank(rank))
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, store=store,
                            world_size=int(world_size), rank=int(rank))
    _initialized = (dist.group.WORLD, make_particle_group(device=device))
    return _initialized[1]


def place_replicated(x, group: ParticleGroup, dtype=None) -> torch.Tensor:
    """A whole (n, m) array on the group's device, as every rank holds it
    (the counterpart of placing under a replicated sharding). A tensor
    keeps its dtype, an array goes through numpy (float64 stays float64)
    unless ``dtype`` says otherwise."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x))
    return as_coords(x, dtype=dtype).to(group.device)


def place_sharded(x, group: ParticleGroup, dtype=None) -> torch.Tensor:
    """This rank's rows of a global (n, m) array on the group's device (the
    counterpart of ``place_sharded``), split by ``ParticleGroup.rows``
    (any n)."""
    x = place_replicated(x, group, dtype)
    return x[group.rows(x.shape[0])].contiguous()
