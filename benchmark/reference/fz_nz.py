"""Reference network of the univariate fz_nz test (FlashWeaveHE-S,
``sensitive=true, heterogeneous=true``, ``max_k=0``).

The semantics, from FlashWeave.jl (src/statfuns.jl:3-17, :91-123,
src/tests.jl:121-125, :436-532) as the port documents them:

- a pair's Pearson correlation r over the rows where both variables are
  nonzero, N of them, from the moments over those rows: r = (Sxy - Sx Sy
  / N) / sqrt((Sxx - Sx^2 / N)(Syy - Sy^2 / N)), clamped to [-1, 1]
  (NaN where a variance is 0; 0 where N = 0);
- power: N >= n_obs_min, else the statistic is 0 and the pair unreliable;
- the Fisher z = sqrt(N - 3) / 2 log((1 + r) / (1 - r)) (0 where N <= 3)
  and the two-sided normal p = erfc(|z| / sqrt 2);
- a pair without power, or with a NaN p-value, is unreliable: never an
  edge, not counted in BH's m; Benjamini-Hochberg at alpha over the
  reliable pairs; the edges are the significant pairs, weighted by r.

The moments are products of the table, its squares and its nonzero mask
in ``dtype`` (float32 with TF32 off for the control)."""

from __future__ import annotations

import math

import torch

from .common import Sweep, blocks, exact_float32, upper


def network(table: torch.Tensor, params: dict, dtype=torch.float64):
    """((keys, weights), facts) of the network of the continuous table
    ``table`` (n, p), on its device."""
    with exact_float32():
        return _network(table, params, dtype)


def _network(table, params, dtype):
    dev = table.device
    n_obs_min = float(params["n_obs_min"])
    x = table.to(dtype)
    p = x.shape[1]
    m = (x != 0).to(dtype)
    x2 = x * x
    sweep = Sweep(p, float(params["alpha"]))
    for s, e in blocks(p, 8 * 16, dev):
        xs, ms, x2s = x[:, s:e].T, m[:, s:e].T, x2[:, s:e].T
        N = ms @ m[:, s:]
        sx = xs @ m[:, s:]
        sy = ms @ x[:, s:]
        sxx = x2s @ m[:, s:]
        syy = ms @ x2[:, s:]
        sxy = xs @ x[:, s:]
        safe = torch.where(N > 0, N, 1.0)
        cov = sxy - sx * sy / safe
        vx = sxx - sx * sx / safe
        vy = syy - sy * sy / safe
        del sx, sy, sxx, syy, sxy
        r = torch.clamp(cov / torch.sqrt(vx * vy), -1.0, 1.0)
        r = torch.where(N > 0, r, 0.0)
        del cov, vx, vy
        suff = N >= n_obs_min
        stat = torch.where(suff, r, 0.0)
        z = torch.where(N > 3, torch.sqrt(torch.clamp(N - 3, min=0.0)) / 2
                        * torch.log((1 + stat) / (1 - stat)), 0.0)
        pval = torch.special.erfc(torch.abs(z) / math.sqrt(2.0))
        sweep.add(s, upper(s, e, p, dev), suff, pval, stat)
    return sweep.network(), sweep.facts()
