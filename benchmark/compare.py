"""The comparison that decides ``correct``: each network a timed call
returned against the reference's network of the same table.

A network is its edge set and weights, as sorted arrays: the key
``X * p + Y`` of each edge X < Y and its weight.  Two numbers are compared,
each against the cell's limit (``workloads/<cell>.json``):

- ``edge_diff``: the edges in one network and not in the other, the worst
  network's count (an exact comparison: limit 0);
- ``weight_gap``: over the edges both hold, the widest gap between the
  program's weight and the reference's, as a share of the reference's
  magnitude, the worst network's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

Network = Tuple[np.ndarray, np.ndarray]     # (sorted int64 keys, weights)


def graph_network(graph, p: int) -> Network:
    """(keys, weights) of a port ``Graph`` with ``p`` nodes."""
    us, vs, ws = [], [], []
    for u, nbrs in graph.adj.items():
        for v, w in nbrs.items():
            if u < v:
                us.append(u)
                vs.append(v)
                ws.append(w)
    keys = np.asarray(us, np.int64) * p + np.asarray(vs, np.int64)
    order = np.argsort(keys, kind="stable")
    return keys[order], np.asarray(ws, np.float64)[order]


def permuted(net: Network, perm: np.ndarray, p: int) -> Network:
    """The network of ``table[:, perm]`` from the network of ``table``:
    column j of the permuted table is column perm[j] of the first."""
    keys, w = net
    inv = np.empty(p, np.int64)
    inv[perm] = np.arange(p, dtype=np.int64)
    a, b = inv[keys // p], inv[keys % p]
    k2 = np.minimum(a, b) * p + np.maximum(a, b)
    order = np.argsort(k2, kind="stable")
    return k2[order], w[order]


def compare(net: Network, ref: Network) -> Dict[str, float]:
    keys, w = net
    rkeys, rw = ref
    common, i, j = np.intersect1d(keys, rkeys, assume_unique=True,
                                  return_indices=True)
    diff = len(keys) + len(rkeys) - 2 * len(common)
    if len(common):
        scale = np.maximum(np.abs(rw[j]), np.finfo(np.float64).tiny)
        with np.errstate(invalid="ignore"):
            gaps = np.abs(w[i] - rw[j]) / scale
        gap = float(np.inf if np.isnan(gaps).any() else gaps.max())
    else:
        gap = 0.0
    return {"edge_diff": int(diff), "weight_gap": gap}


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def verdict(readings: List[Dict[str, float]], limits: Dict[str, float],
            failed: int) -> Tuple[bool, Dict[str, dict]]:
    """(correct, checks): every network read within every limit, and no
    call failed.  ``checks`` holds each number beside its limit."""
    w = worst(readings)
    checks = {k: {"value": w.get(k), "limit": lim}
              for k, lim in limits.items()}
    ok = (failed == 0 and bool(readings)
          and all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values()))
    return ok, checks
