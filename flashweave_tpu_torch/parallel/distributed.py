"""Multi-process runtime plumbing (PyTorch counterpart of
``flashweave_tpu/parallel/distributed.py``).

The reference scales to remote workers through Julia Distributed
(reference: README.md:185-216, src/interleaved.jl:90-93).  Here every
process runs the same program, joins one ``torch.distributed`` process group
and builds its mesh with :func:`..parallel.mesh.get_mesh`, which spans every
process's shards; the sharded univariate pass and the engine's sharded
batches then run unchanged, their cross-process collectives being
``all_gather`` (list form), ``all_reduce`` and ``broadcast``.

Launch contract (the JAX package's variables): every process runs with

  FLASHWEAVE_COORDINATOR   host:port of process 0
  FLASHWEAVE_NUM_PROCESSES total process count
  FLASHWEAVE_PROCESS_ID    this process's rank

and calls :func:`initialize_from_env` before it builds a mesh.  The backend
is the caller's choice and nothing picks another one: ``"gloo"`` on the CPU,
``"nccl"`` when each rank has a card of its own, and ``"gloo"`` with CUDA
tensors when ranks share one card (NCCL refuses two ranks on one GPU).
``tests/test_torch_distributed.py`` runs two CPU processes over gloo.
"""

from __future__ import annotations

import os

import torch.distributed as dist


def initialize_from_env(*, backend: str) -> bool:
    """Join the process group if the launch variables are set.

    Returns True when multi-process mode was initialized, False when
    ``FLASHWEAVE_COORDINATOR`` is unset.  A failed
    ``init_process_group`` raises."""
    coord = os.environ.get("FLASHWEAVE_COORDINATOR")
    if not coord:
        return False
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coord}",
        world_size=int(os.environ["FLASHWEAVE_NUM_PROCESSES"]),
        rank=int(os.environ["FLASHWEAVE_PROCESS_ID"]))
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that should perform I/O / result assembly."""
    return process_index() == 0
