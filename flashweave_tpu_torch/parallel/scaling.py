"""Scaling harness: per-shard throughput and efficiency over mesh sizes
(PyTorch counterpart of ``flashweave_tpu/parallel/scaling.py``).

The reference scales over cluster workers and documents only qualitative
behavior (reference: README.md:185-216).  This harness runs the sharded
univariate pass and a sharded conditional batch over meshes of growing
shard counts and reports throughput and efficiency against the smallest
count.  On distinct cards the numbers measure scaling; on a mesh that
repeats one device (the CPU, or one card) the shards run one after another,
so the harness checks the sharded expression and the parity of its results,
not speed-up.

    python -m flashweave_tpu_torch.parallel.scaling [n] [p] [device]
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .mesh import get_mesh


def _mesh(ndev: int, device):
    """None for one shard; ``ndev`` CPU shards on the CPU; the first
    ``ndev`` cards on CUDA (None past the visible count: skipped)."""
    dev = resolve_device(device)
    if ndev == 1:
        return None, True
    if dev.type == "cpu":
        return get_mesh(devices=["cpu"] * ndev), True
    if ndev > torch.cuda.device_count():
        return None, False
    return get_mesh(ndev), True


def _sync(device):
    if resolve_device(device).type == "cuda":
        torch.cuda.synchronize()


def _efficiency(results: Dict[int, dict]) -> None:
    base = results.get(min(results), {}).get("tests_per_sec") if results \
        else None
    for ndev, r in results.items():
        r["efficiency"] = (
            r["tests_per_sec"] / (base * ndev / min(results)) if base else None
        )


def univar_scaling(
    data: np.ndarray,
    test_name: str = "mi_nz",
    device_counts: Sequence[int] = (1, 2, 4, 8),
    repeats: int = 3,
    device="cuda",
    **kwargs,
) -> Dict[int, dict]:
    """Time the sharded univariate pass at each mesh size.

    Returns {ndev: {seconds, tests_per_sec, n_significant, efficiency}};
    efficiency is throughput / (ndev * 1-shard throughput)."""
    from ..ops.univariate import pw_univar_neighbors
    from ..utils.misc import get_levels, get_max_vals, isdiscrete

    data = np.asarray(data)
    n, p = data.shape
    n_tests = p * (p - 1) // 2
    levels = max_vals = None
    if isdiscrete(test_name):
        levels = get_levels(data)
        max_vals = get_max_vals(data)

    results: Dict[int, dict] = {}
    for ndev in device_counts:
        mesh, ok = _mesh(ndev, device)
        if not ok:
            continue
        kw = dict(levels=levels, max_vals=max_vals, mesh=mesh, device=device,
                  **kwargs)
        pw_univar_neighbors(data, test_name, **kw)          # warm-up
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(repeats):
            nbrs = pw_univar_neighbors(data, test_name, **kw)
        _sync(device)
        dt = (time.perf_counter() - t0) / repeats
        results[ndev] = {
            "seconds": dt,
            "tests_per_sec": n_tests / dt,
            "n_significant": sum(len(v) for v in nbrs.values()) // 2,
        }
    _efficiency(results)
    return results


def cond_scaling(
    data: np.ndarray,
    test_name: str = "mi_nz",
    B: int = 8192,
    max_k: int = 3,
    device_counts: Sequence[int] = (1, 2, 4, 8),
    repeats: int = 3,
    seed: int = 0,
    device="cuda",
) -> Dict[int, dict]:
    """Time a fixed batch of sharded conditional MI tests at each mesh size."""
    from ..ops.condtests import CondTestEngine
    from ..utils.misc import get_levels, get_max_vals

    data = np.asarray(data)
    p = data.shape[1]
    rng = np.random.default_rng(seed)
    X = rng.integers(0, p, B).astype(np.int32)
    Y = (X + 1 + rng.integers(0, p - 2, B)).astype(np.int32) % p
    Zs = rng.integers(0, p, (B, max_k)).astype(np.int32)
    kv = rng.integers(1, max_k + 1, B).astype(np.int32)
    lv, mx = get_levels(data.astype(int)), get_max_vals(data.astype(int))

    results: Dict[int, dict] = {}
    for ndev in device_counts:
        mesh, ok = _mesh(ndev, device)
        if not ok:
            continue
        eng = CondTestEngine(data, test_name, max_k, levels=lv, max_vals=mx,
                             mesh=mesh, device=device)
        eng.mi_tests_raw(X, Y, Zs, kv)                      # warm-up
        t0 = time.perf_counter()
        for _ in range(repeats):
            eng.mi_tests_raw(X, Y, Zs, kv)
        dt = (time.perf_counter() - t0) / repeats
        results[ndev] = {"seconds": dt, "tests_per_sec": B / dt}
    _efficiency(results)
    return results


def report(results: Dict[int, dict], label: str) -> str:
    lines = [f"Scaling: {label}"]
    for ndev, r in sorted(results.items()):
        eff = r.get("efficiency")
        eff_s = f"{eff * 100:5.1f}%" if eff is not None else "  n/a"
        lines.append(
            f"\t{ndev} device(s): {r['tests_per_sec']:.3e} tests/s "
            f"({r['seconds'] * 1e3:.1f} ms, efficiency {eff_s})"
        )
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI: python -m flashweave_tpu_torch.parallel.scaling [n] [p] [device]"""
    import sys

    args = list(argv if argv is not None else sys.argv[1:])
    n = int(args[0]) if args else 1024
    p = int(args[1]) if len(args) > 1 else 512
    device = args[2] if len(args) > 2 else "cuda"
    rng = np.random.default_rng(0)
    data = rng.integers(0, 3, (n, p)).astype(np.float32)
    data[rng.random((n, p)) < 0.4] = 0.0
    print(report(univar_scaling(data, device=device),
                 f"univariate mi_nz (n={n}, p={p})"))
    print(report(cond_scaling(data, device=device),
                 f"conditional mi_nz batch (n={n}, p={p})"))


if __name__ == "__main__":
    main()
