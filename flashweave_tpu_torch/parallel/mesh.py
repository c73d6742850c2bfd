"""Device meshes (PyTorch counterpart of ``flashweave_tpu/parallel/mesh.py``).

The reference scales through Julia Distributed worker processes sharing (or
copying) the data matrix (reference: src/interleaved.jl, README.md:185-216).
The JAX package expresses it as a ``jax.sharding.Mesh`` over one axis "d";
here a :class:`Mesh` is the same axis written out:

- the data table is REPLICATED, one copy per distinct device
  (:func:`put_replicated`);
- the univariate pass shards each block's Y-slab over the shards
  (``ops/univariate.py``), and the conditioning engine shards each batch
  over them (``ops/condtests.py``);
- shards are device-major: global shard g is local shard g - ``first`` of
  the process that holds it, and :func:`gather` concatenates in global
  shard order, as JAX's ``P("d")`` and tiled ``all_gather`` do.

Inside one process the shards are an explicit ordered list of devices,
which may repeat a device: ``["cpu"] * 8`` is the tests' counterpart of the
JAX package's 8 virtual CPU devices, ``["cuda:0"] * 2`` runs the sharded
expression on one card.  The shards of one process run one after another.
Across processes (``parallel.distributed.initialize_from_env``) the
collectives are ``all_gather`` (list form), ``all_reduce`` and
``broadcast`` on the process group, on tensors of the process's first
shard device; a failed collective raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    devices: Tuple[torch.device, ...]  # this process's shards, in order
    group: Optional[object]            # the process group; None: one process
    size: int                          # global shard count
    first: int                         # global index of this process's shard 0

    @property
    def primary(self) -> torch.device:
        """The device that holds gathered results: the first shard's."""
        return self.devices[0]

    def shard_ranges(self, total: int):
        """(local shard, start, stop) of ``total`` items split into ``size``
        contiguous device-major pieces of ceil(total / size) (the last
        pieces shorter or empty), for this process's shards."""
        per = -(-total // self.size)
        for i in range(len(self.devices)):
            g = self.first + i
            yield i, min(total, g * per), min(total, (g + 1) * per)


def get_mesh(n_devices: Optional[int] = None,
             devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device), cut to
    the first ``n_devices``.  A device may repeat.  In a process group every
    process passes its own shards and the mesh spans them all, in rank
    order."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("get_mesh: no CUDA device is visible; pass "
                               "devices=[...] to build a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(resolve_device(d) for d in devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"get_mesh: {n_devices} shards asked for, "
                             f"{len(devs)} devices given")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("get_mesh: a mesh needs at least one device")
    if not dist.is_initialized():
        return Mesh(devs, None, len(devs), 0)
    group = dist.group.WORLD
    mine = torch.tensor([len(devs)], dtype=torch.int64, device=devs[0])
    counts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(counts, mine, group=group)
    counts = [int(c) for c in counts]
    return Mesh(devs, group, sum(counts), sum(counts[:dist.get_rank()]))


def put_replicated(x, mesh: Mesh) -> List:
    """``x`` (a tensor, or anything with ``.to(device)``) on every local
    shard: one copy per distinct device, shared by the shards on it."""
    copies = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = x.to(dev)
    return [copies[dev] for dev in mesh.devices]


def bcast_scalar_from_rank0(mesh: Mesh, value: float) -> float:
    """Every process passes its local value; all receive PROCESS 0's.

    Used for the multi-process deterministic clock: wall-clock decisions
    (convergence, time-limit checkpoints) must be identical on every process
    or their request streams fork and the collectives desync (reference
    contract: src/interleaved.jl:203-230 runs convergence on the single
    master).  One float64 broadcast a scheduler round."""
    if mesh.group is None:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=mesh.primary)
    dist.broadcast(t, src=0, group=mesh.group)
    return float(t.item())


def _local(parts: Sequence[torch.Tensor], mesh: Mesh, dim: int):
    parts = [t.to(mesh.primary) for t in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def gather(mesh: Mesh, parts: Sequence[torch.Tensor],
           dim: int = 0) -> torch.Tensor:
    """Concatenate the local shards' tensors ``parts`` and every other
    process's along ``dim`` in device-major order, on the primary device.
    Sizes along ``dim`` may differ: the processes gather their sizes first,
    pad to the largest, gather, and strip the padding."""
    local = _local(parts, mesh, dim)
    if mesh.group is None:
        return local
    x = local.movedim(dim, 0).contiguous()
    is_bool = x.dtype == torch.bool
    if is_bool:                                  # gloo has no bool type
        x = x.to(torch.uint8)
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    sizes = [torch.empty_like(n) for _ in range(dist.get_world_size())]
    dist.all_gather(sizes, n, group=mesh.group)
    sizes = [int(s) for s in sizes]
    top = max(sizes)
    if x.shape[0] < top:
        x = torch.cat([x, x.new_zeros((top - x.shape[0],) + x.shape[1:])])
    bufs = [torch.empty_like(x) for _ in sizes]
    dist.all_gather(bufs, x, group=mesh.group)
    out = torch.cat([b[:s] for b, s in zip(bufs, sizes)])
    if is_bool:
        out = out.to(torch.bool)
    return out.movedim(0, dim)


def psum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This process's total ``x`` summed with every other process's, on the
    primary device."""
    total = x.to(mesh.primary)
    if mesh.group is not None:
        total = total.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
    return total


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int,
                    value=0) -> np.ndarray:
    size = x.shape[axis]
    pad = (-size) % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value)
