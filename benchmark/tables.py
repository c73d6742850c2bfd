"""The cells' OTU tables, drawn on the device from the seed.

One generator for every configuration (its ``table`` parameters) and
traffic mix (its ``tables``, ``transform``):

- ``grouped``: bench.py's ``_synth_table`` grouping (bench.py:265-271)
  rewritten in torch, at an OTU table's sparsity: ``otus / group`` base
  columns, each repeated ``group`` times side by side, then every value
  replaced, with probability ``noise``, by a fresh draw.  Every draw is 0
  (absent) with probability ``zero_share``, else a level drawn uniformly
  from ``1 .. levels - 1``: FlashWeave's nz binning splits each OTU's
  nonzero abundances at their median, so its nonzero levels are equally
  common.  The values are the nz-binned levels that mi_nz takes.
- the transform ``log1p``: ``log1p`` of the values (0 stays 0), the
  continuous table that fz_nz takes, as bench.py's scale cells make it.
- ``tables``: the first table and ``tables - 1`` seeded column
  permutations of it, so that no call sees the array the call before it
  saw, while every call does the same work.

All draws come from one ``torch.Generator`` on the device, seeded with
``--seed``, in a few large calls; the tables then cross to the host once,
in the dtype users hand the port (``dtype``), as plain pageable numpy
arrays."""

from __future__ import annotations

import torch

TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def sparse_levels(shape, levels: int, zero_share: float,
                  gen: torch.Generator) -> torch.Tensor:
    """int8 draws: 0 with probability ``zero_share``, else uniform over
    ``1 .. levels - 1``, from one uniform draw each."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    nz = ((u - zero_share) / (1.0 - zero_share) * (levels - 1)).floor()
    out = torch.where(u < zero_share, 0.0, 1.0 + nz.clamp_(0, levels - 2))
    return out.to(torch.int8)


def grouped_levels(n: int, p: int, group: int, levels: int, noise: float,
                   zero_share: float, gen: torch.Generator) -> torch.Tensor:
    """(n, p) int8 levels by the grouped rule, on ``gen``'s device."""
    if p % group:
        raise ValueError(f"otus ({p}) must be a multiple of group ({group})")
    if not 0.0 <= zero_share < 1.0:
        raise ValueError(f"zero_share ({zero_share}) must lie in [0, 1)")
    dev = gen.device
    base = sparse_levels((n, p // group), levels, zero_share, gen)
    data = base.repeat_interleave(group, dim=1)
    del base
    flip = torch.rand((n, p), generator=gen, device=dev) < noise
    fresh = sparse_levels((n, p), levels, zero_share, gen)
    return torch.where(flip, fresh, data)


def transform(data: torch.Tensor, name: str, dtype) -> torch.Tensor:
    if name == "none":
        return data.to(dtype)
    if name == "log1p":
        return torch.log1p(data.to(dtype))
    raise ValueError(f"unknown transform {name!r}")


def device_tables(config: dict, traffic: dict, seed: int, device):
    """(tables, perms) on the device: tables[k] = tables[0][:, perms[k]],
    perms[0] the identity."""
    tb = config["table"]
    if tb["kind"] != "grouped":
        raise ValueError(f"unknown table kind {tb['kind']!r}")
    gen = generator(seed, device)
    levels = grouped_levels(
        int(config["samples"]), int(config["otus"]), int(tb["group"]),
        int(tb["levels"]), float(tb["noise"]), float(tb["zero_share"]), gen)
    first = transform(levels, traffic.get("transform", "none"),
                      TORCH_DTYPES[tb["dtype"]])
    del levels
    p = first.shape[1]
    perms = [torch.arange(p, device=first.device)]
    for _ in range(int(traffic.get("tables", 1)) - 1):
        perms.append(torch.randperm(p, generator=gen, device=first.device))
    return first, perms


def host_tables(config: dict, traffic: dict, seed: int, device):
    """The cell's tables on the host (numpy, C order) and their column
    permutations of the first (numpy int64), made on ``device``."""
    first, perms = device_tables(config, traffic, seed, device)
    tables = [first.cpu().numpy()]
    for perm in perms[1:]:
        tables.append(first[:, perm].cpu().numpy())
    perms = [q.cpu().numpy() for q in perms]
    del first
    return tables, perms
