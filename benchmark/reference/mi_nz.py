"""Reference network of the univariate mi_nz test (FlashWeaveHE-F,
``sensitive=false, heterogeneous=true``, ``max_k=0``).

The semantics, from FlashWeave.jl (src/tests.jl:5-103, src/statfuns.jl:
157-323, src/misc.jl:137-218) as the port documents them:

- a table of integer levels 0 .. L-1; a variable's ``levels`` counts the
  levels it takes, its ``max`` is the largest;
- zero-adjustment: a variable whose max exceeds 1 drops its level 0 (the
  offset o = 1), so a pair's table keeps the cells a >= o_X, b >= o_Y;
- over the kept cells N_ab: n_obs = sum N, margins r_a, s_b, and the mutual
  information mi = sum N_ab log(n_obs N_ab / (r_a s_b)) / n_obs over the
  cells with N_ab > 0; its sign is negative where the off-diagonal cells'
  share (sum of terms off (a - o_X) == (b - o_Y), times their count) is
  larger than the diagonal's;
- df = (rows with r_a > 0, at least 1, - 1)(columns with s_b > 0, at
  least 1, - 1); p = Q(df / 2, n_obs |mi|), the chi-square survival of
  the G statistic 2 n_obs |mi| (1 where df = 0);
- power: the rows with X >= o_X number n_view >= n_obs_min and, where
  c = (levels_X - (2 if levels_X > 1 else 1)) (the same of Y) is positive,
  n_view / c > hps; n_obs >= n_obs_min and n_obs / ((L - o_X)(L - o_Y))
  > hps; levels_X >= 2.  A pair without power, or with a NaN p-value, is
  unreliable: it is never an edge and does not count in BH's m;
- Benjamini-Hochberg at alpha over the reliable pairs; the network's
  edges are the significant pairs, each weighted by its signed mi.

Counts are exact: the joint counts of the levels >= 1 are products of
0/1 level indicators (``common.count_products``), the level-0 cells follow
from the variables' level counts.  Everything after the counts is in
``dtype``."""

from __future__ import annotations

import torch

from .common import Sweep, blocks, count_products, upper

NZ = True


def network(table: torch.Tensor, params: dict, dtype=torch.float64):
    """((keys, weights), facts) of the network of ``table`` (n, p), whose
    values are integer levels, on its device."""
    return discrete_network(table, params, dtype, NZ)


def discrete_network(table, params, dtype, nz):
    dev = table.device
    hps = float(params["hps"])
    n_obs_min = float(params["n_obs_min"])
    tt = table.to(torch.int8).T.contiguous()          # (p, n)
    p, n = tt.shape
    L = int(tt.max()) + 1
    count = torch.stack([(tt == a).sum(dim=1) for a in range(L)])  # (L, p)
    lv = torch.arange(L, device=dev)
    levels = (count > 0).sum(dim=0)
    top = torch.where(count > 0, lv[:, None], 0).amax(dim=0)
    off = (top > 1).long() if nz else torch.zeros_like(top)
    lo = 1 if bool(off.all()) else 0                  # level 0 never kept
    planes = {a: (tt == a).to(torch.int8) for a in range(1, L)}
    del tt
    cells = [(a, b) for a in range(lo, L) for b in range(lo, L)]
    count = count.to(dtype)
    sweep = Sweep(p, float(params["alpha"]))
    for s, e in blocks(p, 8 * (3 * len(cells) + 16), dev):
        q = p - s
        ox, oy = off[s:e, None], off[None, s:]
        cx, cy = count[:, s:e, None], count[:, None, s:]
        N = {(a, b): count_products(planes[a][s:e], planes[b][s:]).to(dtype)
             for a in range(1, L) for b in range(1, L)}
        if lo == 0:
            for a in range(1, L):
                N[a, 0] = cx[a] - sum(N[a, b] for b in range(1, L))
            for b in range(1, L):
                N[0, b] = cy[b] - sum(N[a, b] for a in range(1, L))
            N[0, 0] = (n - sum(cx[a] for a in range(1, L))
                       - sum(N[0, b] for b in range(1, L)))
        K = {}
        for a, b in cells:
            kept = (a >= ox) & (b >= oy)
            K[a, b] = torch.where(kept, N.pop((a, b)), 0.0)
        del N
        r = {a: sum(K[a, b] for b in range(lo, L)) for a in range(lo, L)}
        c = {b: sum(K[a, b] for a in range(lo, L)) for b in range(lo, L)}
        n_obs = sum(r.values())
        pos = torch.zeros((e - s, q), dtype=dtype, device=dev)
        neg = torch.zeros_like(pos)
        n_pos = torch.zeros_like(pos)
        for a, b in cells:
            k = K[a, b]
            t = torch.where(k > 0, k * torch.log(
                torch.where(k > 0, n_obs * k / (r[a] * c[b]), 1.0)), 0.0)
            diag = (a - ox) == (b - oy)
            pos += torch.where(diag, t, 0.0)
            neg += torch.where(diag, 0.0, t)
            n_pos += torch.where(diag, k, 0.0)
        mi = torch.where(n_obs > 0, (pos + neg) / n_obs, 0.0)
        mi = torch.where(neg * (n_obs - n_pos) > pos * n_pos, -mi, mi)
        del K, pos, neg, n_pos
        alx = torch.clamp(sum((r[a] > 0).long() for a in r), min=1)
        aly = torch.clamp(sum((c[b] > 0).long() for b in c), min=1)
        df = (alx - 1) * (aly - 1)
        del r, c
        # power
        lx, ly = levels[s:e, None], levels[None, s:]
        n_view = sum(torch.where(a >= ox, cx[a], 0.0) for a in range(L))
        pre_x = lx - torch.where(lx > 1, 2, 1)
        pre_y = ly - torch.where(ly > 1, 2, 1)
        cpre = (pre_x * pre_y).to(dtype)
        pre = (n_view >= n_obs_min) & ((cpre <= 0) | (
            n_view / torch.where(cpre > 0, cpre, 1.0) > hps))
        cpost = ((L - ox) * (L - oy)).to(dtype)
        post = (n_obs >= n_obs_min) & (n_obs / cpost > hps)
        suff = pre & post & (lx >= 2)
        stat = torch.where(suff, mi, 0.0)
        x = n_obs * torch.abs(stat)
        pval = torch.where(
            df > 0, torch.special.gammaincc(
                torch.clamp(df, min=1).to(dtype) / 2, x), 1.0)
        sweep.add(s, upper(s, e, p, dev), suff, pval, stat)
    return sweep.network(), sweep.facts()
