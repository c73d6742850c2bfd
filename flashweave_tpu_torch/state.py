"""The port's device state: the prepared data table.

FlashWeave learns no weights.  What a run keeps on the device is the data
table; the univariate kernel and the conditioning engine both read this one
upload.

- Discrete tests (mi, mi_nz): the int8 table (int16 when a value exceeds
  127) with its per-variable ``levels``, ``max_vals`` and level marginals
  (:func:`from_numpy_state`).
- Continuous tests (fz_nz): one contiguous float64 (n, p) tensor
  (:func:`from_numpy_continuous`).

Both turn the JAX package's table, as numpy arrays, into the port's state,
so tests feed both packages the same prepared table.  On a device mesh
``parallel.mesh.put_replicated`` puts either one on every shard, one copy
per distinct device (:meth:`DiscreteState.to`; the JAX package's
``put_replicated`` of the table, ``ops/condtests.py:862-866`` and
``ops/univariate.py:225-228``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .ops.kernels import level_marginals


@dataclass
class DiscreteState:
    data: torch.Tensor        # (n, p) int8 (int16 past 127), values 0..L-1
    dataT: torch.Tensor       # (p, n) contiguous: the kernels' layout
    levels: torch.Tensor      # (p,) int32 distinct values per variable
    max_vals: torch.Tensor    # (p,) int32 largest value per variable
    marg: torch.Tensor        # (L, p) int32 per-variable level counts
    levels_np: np.ndarray
    max_vals_np: np.ndarray
    L: int

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "DiscreteState":
        """This state on ``device``: itself where it is there already."""
        dev = torch.device(device)
        if dev == self.device:
            return self
        return DiscreteState(
            data=self.data.to(dev), dataT=self.dataT.to(dev),
            levels=self.levels.to(dev), max_vals=self.max_vals.to(dev),
            marg=self.marg.to(dev), levels_np=self.levels_np,
            max_vals_np=self.max_vals_np, L=self.L)


def from_numpy_state(data, levels: Optional[np.ndarray] = None,
                     max_vals: Optional[np.ndarray] = None,
                     device="cuda") -> DiscreteState:
    """Upload a discrete (n, p) table once, with its level bookkeeping.

    ``levels`` / ``max_vals`` default to ``utils.misc``'s
    ``get_levels`` / ``get_max_vals`` on the host.  Values must be integers
    in 0..32767, anything else raises ValueError.  The table is int8, the
    kernels' type, when its values fit in 0..127, else int16 (which only
    the plain pair-table route of the univariate pass reads)."""
    from .utils.misc import get_levels, get_max_vals

    dev = resolve_device(device)
    data = np.asarray(data)
    if levels is None:
        levels = get_levels(data)
    if max_vals is None:
        max_vals = get_max_vals(data)
    dtype = np.int8 if data.max(initial=0) <= 127 else np.int16
    dint = data.astype(dtype)
    if dint.min(initial=0) < 0 or not np.array_equal(dint, data):
        raise ValueError("discrete tables must hold integers in 0..32767")
    levels_np = np.asarray(levels, dtype=np.int32)
    max_vals_np = np.asarray(max_vals, dtype=np.int32)
    L = int(max_vals_np.max(initial=0)) + 1
    data_t = torch.from_numpy(dint).to(dev)
    return DiscreteState(
        data=data_t,
        dataT=data_t.T.contiguous(),
        levels=torch.from_numpy(levels_np).to(dev),
        max_vals=torch.from_numpy(max_vals_np).to(dev),
        marg=level_marginals(data_t, L),
        levels_np=levels_np,
        max_vals_np=max_vals_np,
        L=L,
    )


def from_numpy_continuous(data, device="cuda") -> torch.Tensor:
    """Upload a continuous (n, p) table once, as the contiguous float64
    tensor the fz_nz kernel and the conditioning engine read.  (The JAX
    package's float16 upload for large tables was a transfer device of its
    TPU; float64 keeps the card's decisions equal to the CPU's.)"""
    dev = resolve_device(device)
    arr = np.ascontiguousarray(np.asarray(data), dtype=np.float64)
    return torch.from_numpy(arr).to(dev)
