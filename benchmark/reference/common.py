"""What the references share: the X-blocks of the all-pairs sweep,
exact pair counts as matrix products, and the Benjamini-Hochberg cut."""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Tuple

import numpy as np
import torch

# device memory the references may hold for one X-block's tensors
BLOCK_BYTES = 12 << 30


def blocks(p: int, bytes_per_pair: int, device) -> Iterator[Tuple[int, int]]:
    """(s, e) of the X-blocks [s, e) of the sweep over every pair X < Y,
    each against the Y-slab [s, p): as many rows as keep a block's
    ``bytes_per_pair`` within ``BLOCK_BYTES`` (a multiple of 64, at least
    64; the whole table on the CPU)."""
    if torch.device(device).type == "cpu":
        rows = p
    else:
        rows = max(64, BLOCK_BYTES // (bytes_per_pair * max(p, 1)) // 64 * 64)
    for s in range(0, p, rows):
        yield s, min(s + rows, p)


def upper(s: int, e: int, p: int, device) -> torch.Tensor:
    """(e - s, p - s) bool: X = s + i < Y = s + j."""
    i = torch.arange(s, e, device=device)[:, None]
    j = torch.arange(s, p, device=device)[None, :]
    return i < j


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    r, c = x.shape
    if r == rows and c == cols:
        return x
    out = torch.zeros((rows, cols), dtype=x.dtype, device=x.device)
    out[:r, :c] = x
    return out


def count_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T as exact int32 counts, for 0/1 int8 matrices a (r, n) and
    b (q, n): ``torch._int_mm`` on the card (padded to its shapes), float64
    on the CPU."""
    r, n = a.shape
    q = b.shape[0]
    if a.device.type != "cuda":
        return (a.double() @ b.double().T).to(torch.int32)
    up = (lambda v, m: -(-v // m) * m)
    nn = up(n, 8)
    out = torch._int_mm(_pad(a, max(r, 17), nn),
                        _pad(b, up(q, 8), nn).T)
    return out[:r, :q]


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32 (the control's precision)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


class Sweep:
    """The pairs of the sweep that a network needs: counts of the pairs
    with power and of the reliable ones, and the reliable pairs with
    p < alpha (the candidates of the BH cut) with their statistic."""

    def __init__(self, p: int, alpha: float):
        self.p = p
        self.alpha = alpha
        self.powered = 0
        self.reliable = 0
        self.candidates = 0
        self.parts: List[tuple] = []

    def add(self, s: int, valid, suff, pval, stat) -> None:
        """One X-block's (r, q) tensors: ``valid`` (X < Y), ``suff`` (the
        power check passed), the p-value (NaN: unreliable) and the
        statistic."""
        suff = suff & valid
        rel = suff & ~torch.isnan(pval)
        cand = rel & (pval < self.alpha)
        self.powered += int(suff.sum())
        self.reliable += int(rel.sum())
        i, j = torch.nonzero(cand, as_tuple=True)
        self.candidates += int(i.numel())
        self.parts.append(((i + s).to(torch.int32), (j + s).to(torch.int32),
                           pval[i, j], stat[i, j]))

    def facts(self) -> dict:
        p = self.p
        return {"pairs": p * (p - 1) // 2, "powered": self.powered,
                "reliable": self.reliable, "candidates": self.candidates}

    def network(self):
        """(keys, weights) of the BH-significant candidates over the
        reliable pairs, alpha as given: the ranks 1..k of the p-values in
        ascending order, k the last rank whose p * m / rank is below
        alpha; weights the statistic, as float64 numpy."""
        if not self.parts:
            return np.zeros(0, np.int64), np.zeros(0, np.float64)
        X, Y, pv, st = (torch.cat([x[k] for x in self.parts])
                        for k in range(4))
        self.parts = []
        ps, order = torch.sort(pv, stable=True)
        ranks = torch.arange(1, len(ps) + 1, dtype=ps.dtype, device=ps.device)
        below = torch.nonzero(ps * self.reliable / ranks < self.alpha)
        n_sig = int(below.max()) + 1 if below.numel() else 0
        keep = order[:n_sig]
        keys = (X[keep].long() * self.p + Y[keep].long()).cpu().numpy()
        w = st[keep].double().cpu().numpy()
        srt = np.argsort(keys, kind="stable")
        return keys[srt], w[srt]
