"""Each reference against a plain numpy computation, a pair at a time,
at a tiny size: the same edges, the same weights to rounding."""

import math

import numpy as np
import pytest
import torch
from scipy.special import erfc, gammaincc

from benchmark.spec import load_module

PARAMS = {"alpha": 0.01, "hps": 5, "n_obs_min": 20}


def bh(pvals, alpha):
    """Indices significant under Benjamini-Hochberg (NaN: not tested)."""
    idx = np.flatnonzero(~np.isnan(pvals))
    m = len(idx)
    order = idx[np.argsort(pvals[idx], kind="stable")]
    ok = pvals[order] * m / np.arange(1, m + 1) < alpha
    k = np.flatnonzero(ok).max() + 1 if ok.any() else 0
    return set(order[:k].tolist())


def mi_pair(x, y, L, hps, n_obs_min):
    """(stat, p) of one mi_nz pair, or (0, nan) without power."""
    ox, oy = int(x.max() > 1), int(y.max() > 1)
    tab = np.zeros((L, L))
    np.add.at(tab, (x, y), 1)
    sub = tab[ox:, oy:]
    n_obs = sub.sum()
    r, c = sub.sum(1), sub.sum(0)
    terms = np.zeros_like(sub)
    nz = sub > 0
    terms[nz] = sub[nz] * np.log(n_obs * sub[nz] / np.outer(r, c)[nz])
    diag = np.eye(*sub.shape, dtype=bool)
    mi = terms.sum() / n_obs if n_obs else 0.0
    pos, neg = terms[diag].sum(), terms[~diag].sum()
    npos = sub[diag].sum()
    if neg * (n_obs - npos) > pos * npos:
        mi = -mi
    df = (max((r > 0).sum(), 1) - 1) * (max((c > 0).sum(), 1) - 1)
    lx, ly = len(np.unique(x)), len(np.unique(y))
    n_view = (x >= ox).sum()
    cpre = (lx - (2 if lx > 1 else 1)) * (ly - (2 if ly > 1 else 1))
    pre = n_view >= n_obs_min and (cpre <= 0 or n_view / cpre > hps)
    post = n_obs >= n_obs_min and n_obs / ((L - ox) * (L - oy)) > hps
    if not (pre and post and lx >= 2):
        return 0.0, math.nan
    p = gammaincc(df / 2, n_obs * abs(mi)) if df > 0 else 1.0
    return mi, p


def fz_pair(x, y, n_obs_min):
    m = (x != 0) & (y != 0)
    N = int(m.sum())
    if N < n_obs_min:
        return 0.0, math.nan
    r = float(np.clip(np.corrcoef(x[m], y[m])[0, 1], -1, 1))
    z = math.sqrt(N - 3) / 2 * math.log((1 + r) / (1 - r)) if N > 3 else 0
    return r, erfc(abs(z) / math.sqrt(2))


def numpy_network(table, pair_fn):
    p = table.shape[1]
    pairs = [(i, j) for i in range(p) for j in range(i + 1, p)]
    sp = [pair_fn(table[:, i], table[:, j]) for i, j in pairs]
    pv = np.array([s[1] for s in sp])
    sig = sorted(bh(pv, PARAMS["alpha"]))
    return ({pairs[k][0] * p + pairs[k][1]: sp[k][0] for k in sig},
            {"powered": int((~np.isnan(pv)).sum()),
             "candidates": int((pv < PARAMS["alpha"]).sum())})


def grouped(rng, n, groups, size, levels, noise):
    base = rng.integers(0, levels, (n, groups))
    t = np.repeat(base, size, axis=1)
    flip = rng.random(t.shape) < noise
    return np.where(flip, rng.integers(0, levels, t.shape), t)


def check(table, name, pair_fn, dtype=torch.float64):
    (keys, w), facts = load_module("reference", name).network(
        torch.from_numpy(table), PARAMS, dtype)
    want, wfacts = numpy_network(table, pair_fn)
    assert keys.tolist() == sorted(want)
    assert np.allclose(w, [want[k] for k in keys], rtol=1e-12, atol=0)
    assert facts["powered"] == wfacts["powered"]
    assert facts["candidates"] == wfacts["candidates"]
    return len(keys)


@pytest.mark.parametrize("seed", [0, 1])
def test_mi_nz(seed):
    rng = np.random.default_rng(seed)
    t = grouped(rng, 300, 6, 4, 3, 0.4)
    t[:, 1] = np.minimum(t[:, 1], 1)          # a 0/1 variable: level 0 kept
    t[:, 5] = 2                               # a constant: never tested
    t[:30, 9] = 0                             # sparse, few joint samples
    t[30:, 9] = 0
    t[:40, 9] = rng.integers(1, 3, 40)
    L = 3
    edges = check(t.astype(np.float32), "mi_nz",
                  lambda x, y: mi_pair(x.astype(int), y.astype(int), L,
                                       PARAMS["hps"], PARAMS["n_obs_min"]))
    assert edges > 10


@pytest.mark.parametrize("seed", [0, 1])
def test_fz_nz(seed):
    rng = np.random.default_rng(seed)
    t = grouped(rng, 300, 6, 4, 3, 0.4).astype(np.float64)
    t[rng.random(300) < 0.5, 3] = 0           # a sparse variable
    t[:280, 7] = 0                            # too few joint samples
    t = np.log1p(t).astype(np.float32)
    edges = check(t, "fz_nz", lambda x, y: fz_pair(
        x.astype(np.float64), y.astype(np.float64), PARAMS["n_obs_min"]))
    assert edges > 10
