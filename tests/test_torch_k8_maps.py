"""The work split of K8, the univariate extraction sweep
(``csrc/mi_univar_extract.cu``), replayed in numpy on the CPU.

The CUDA kernel runs only on the card.  These tests replay, with the
kernel's constants read from its source, how it splits a block: a grid of
blocks striding over chunks of CHUNK consecutive pairs of one row, ITEMS
pairs a thread at stride THREADS; each pair's rules (X < Y, power, NaN,
reliable) and log p (the plain chain's, ``statfuns.mi_logpval_smalldf``,
or the given front's); a warp's candidates counted by ballots, the warps'
counts scanned in shared memory and one global atomic a chunk taking the
slots, in an order of the blocks drawn at random; the slots below the
budget written; each block's histogram of bins (the edges a candidate's log
p is below) folded into the counts below each edge at its end, with its
unreliable pairs.  The replay's tally must equal the plain version's
(``kernels.univar_extract_ref``) exactly and its candidates be the plain
version's as a set, bit for bit; past a cut budget its slots hold distinct
candidates and the cursor counts on.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from flashweave_tpu_torch.ops import kernels as K
from flashweave_tpu_torch.ops import statfuns as sf
from flashweave_tpu_torch.ops import univariate as U
from flashweave_tpu_torch.state import from_numpy_state

CSRC = Path(K.SRC_DIR)


def _constants(name):
    """The ``constexpr int`` values of a csrc file, in C's integer
    arithmetic, evaluated in order."""
    ns = {}
    text = (CSRC / name).read_text()
    for key, expr in re.findall(r"constexpr int (\w+)\s*=\s*([^;]+);", text):
        ns[key] = int(eval(expr.replace("/", "//"), {}, dict(ns)))
    return ns


C8 = _constants("mi_univar_extract.cu")


def test_constants_match_the_wrapper():
    c = C8
    assert c["N_EDGES"] == K.K8_EDGES == U.N_EXTRACT_BINS
    assert c["TALLY"] == K.K8_TALLY == 2 + K.K8_EDGES
    assert c["CHUNK"] == c["THREADS"] * c["ITEMS"]
    assert c["THREADS"] % 32 == 0 and c["WARPS"] == c["THREADS"] // 32
    # the histogram has a bin for every count of edges, 0..N_EDGES, and the
    # block folds it with a thread an edge
    assert c["N_EDGES"] < c["THREADS"]


def _pair_values(front, outs, s, y0, reliable, max_df):
    """Each slot's (in block, log p after the rules, stat, unreliable), as
    a thread of K8 computes them: log p only where the pair has power."""
    if front == "mi":
        stat, df, nobs, suff = (o.numpy() for o in outs)
        v = sf.mi_logpval_smalldf(outs[0], outs[1], outs[2], max_df).numpy()
    else:
        v, stat, suff = (o.numpy() for o in outs)
    t, q = stat.shape
    suff = np.broadcast_to(suff, (t, q))
    pair = (np.arange(s, s + t)[:, None] < np.arange(y0, y0 + q)[None, :])
    v = np.where(suff, v, np.nan)
    unrel = pair & (~suff | np.isnan(v))
    lp = np.where(unrel, math.inf if reliable else 0.0, v)
    return pair, np.where(pair, lp, math.inf), stat, unrel


def _replay(front, outs, s, y0, thresh, reliable, max_df, edges, cap, grid,
            seed):
    """K8's launch on one block, replayed: returns (tally, slots)."""
    c = C8
    T, ITEMS, CHUNK, W = c["THREADS"], c["ITEMS"], c["CHUNK"], c["WARPS"]
    pair, lp, stat, unrel = _pair_values(front, outs, s, y0, reliable,
                                         max_df)
    t, q = lp.shape
    chunks_row = -(-q // CHUNK)
    chunks = t * chunks_row
    grid = min(grid, chunks)
    tally = np.zeros(c["TALLY"], np.int64)
    X = np.full(cap, -1, np.int64)
    Y = np.full(cap, -1, np.int64)
    LP = np.zeros(cap)
    ST = np.zeros(cap)
    # each block's chunks in order; the blocks' chunks interleaved at random
    queues = [list(range(b, chunks, grid)) for b in range(grid)]
    hist = np.zeros((grid, c["N_EDGES"] + 1), np.int64)
    unrel_b = np.zeros(grid, np.int64)
    rng = np.random.default_rng(seed)
    live = [b for b in range(grid) if queues[b]]
    atomics = 0
    while live:
        b = live[rng.integers(len(live))]
        ch = queues[b].pop(0)
        if not queues[b]:
            live.remove(b)
        row, col0 = ch // chunks_row, (ch % chunks_row) * CHUNK
        tid = np.arange(T)
        cols = col0 + np.arange(ITEMS)[:, None] * T + tid[None, :]  # (k, tid)
        inside = cols < q
        cc = np.minimum(cols, q - 1)
        ok = inside & pair[row, cc]
        cand = ok & (lp[row, cc] < thresh)
        unrel_b[b] += int((ok & unrel[row, cc]).sum())
        # a warp's ballots, item by item; its count; the block's scan
        lane_cand = cand.reshape(ITEMS, W, 32)
        warp_n = lane_cand.sum(axis=(0, 2))
        total = int(warp_n.sum())
        base = tally[0]
        if total:
            atomics += 1
            tally[0] += total
        warp_base = base + np.concatenate([[0], np.cumsum(warp_n)[:-1]])
        for w in range(W):
            slot = int(warp_base[w])
            for k in range(ITEMS):
                mask = lane_cand[k, w]
                for lane in np.flatnonzero(mask):
                    at = slot + int(mask[:lane].sum())
                    col = int(cols[k, w * 32 + lane])
                    v = lp[row, col]
                    if at < cap:
                        X[at], Y[at] = s + row, y0 + col
                        LP[at], ST[at] = v, stat[row, col]
                    if edges is not None:
                        hist[b, int((v < edges).sum())] += 1
                slot += int(mask.sum())
    tally[1] = unrel_b.sum()
    if edges is not None:
        for j in range(c["N_EDGES"]):
            tally[2 + j] = hist[:, j + 1:].sum()
    kept = min(int(tally[0]), cap)
    return tally, (X[:kept], Y[:kept], LP[:kept], ST[:kept]), atomics


def _mi_block(nz, seed=5, shape=(400, 1300), block=(20, 24, 5, 1295)):
    """K1's plain outputs on a grouped 3-level table's block."""
    rng = np.random.default_rng(seed)
    n, p = shape
    base = rng.integers(0, 3, (n, p // 5))
    data = np.repeat(base, 5, axis=1)
    data = np.where(rng.random(data.shape) < 0.35,
                    rng.integers(0, 3, data.shape), data).astype(np.float64)
    if nz == 1:
        data[:, ::3] = np.minimum(data[:, ::3], 1.0)
    st = from_numpy_state(data, None, None, "cpu")
    s, t, y0, q = block
    q = min(q, p - y0)
    outs = K.mi_univar_stats_ref(st.dataT, st.marg, st.levels, st.max_vals,
                                 s, t, st.L, y0, q, nz, 5.0, 20.0)
    return outs, s, y0, p


CASES = [("mi nz 2", True), ("mi nz 1, NaN stats", False),
         ("given, fz 0-dim power", True), ("mi nz 2, budget cut", True)]


@pytest.mark.parametrize("case,reliable", CASES)
def test_replay_equals_the_plain_version(case, reliable):
    """The replayed launch against ``univar_extract_ref`` on the same
    block: the tally exactly, the candidates as a set bit for bit (or,
    past the cut, distinct candidates of the plain version's in every
    slot), at a small grid (several chunks a block) and a large one."""
    if case.startswith("given"):
        rng = np.random.default_rng(2)
        data = np.log1p(rng.poisson(3.0, (300, 1200))
                        + rng.random((300, 1200)))
        data[:, 7::11] = 0.5                                  # NaN r
        xc, ssd = U._fz_center(torch.from_numpy(data))
        r = U.fz_block(xc, ssd, 30, 20, 10, 1190)
        front, outs = "given", U._given_scores(
            (r, torch.tensor(300.0, dtype=torch.float64)), 20.0)
        s, y0, p, max_df = 30, 10, 1200, 0
        assert torch.isnan(outs[0]).any()
    else:
        nz = 1 if "nz 1" in case else 2
        (stat, df, nobs, suff), s, y0, p = _mi_block(nz)
        if "NaN" in case:
            stat = stat.clone()
            stat[::3] = math.nan
        front, outs, max_df = "mi", (stat, df, nobs, suff), 4
    edges = U._extract_edges(0.05, p * (p - 1) // 2)
    thresh = math.log(0.05)
    t, q = outs[0].shape
    want = K.ExtractBuffers(t * q, "cpu", edges, max_df)
    K.univar_extract_ref(want, front, outs, s, y0, thresh, reliable, max_df)
    kept = int(want.tally[0])
    assert kept > 50
    wx, wy, wl, ws = (c.numpy() for c in want.candidates(kept))
    wkey = wx.astype(np.int64) * (1 << 32) + wy
    cap = kept // 3 if "cut" in case else t * q
    for grid, seed in ((3, 0), (1 << 20, 1)):
        tally, (gx, gy, gl, gs), atomics = _replay(
            front, outs, s, y0, thresh, reliable, max_df, edges, cap, grid,
            seed)
        np.testing.assert_array_equal(tally, want.tally.numpy())
        gkey = gx * (1 << 32) + gy
        assert len(np.unique(gkey)) == len(gkey) == min(cap, kept)
        at = np.searchsorted(wkey, gkey)
        np.testing.assert_array_equal(wkey[at], gkey)
        np.testing.assert_array_equal(wl[at].view(np.int64),
                                      gl.view(np.int64))
        np.testing.assert_array_equal(ws[at].view(np.int64),
                                      gs.view(np.int64))
        # one global atomic for each chunk that holds a candidate; the
        # block's rows run past one chunk
        assert q > C8["CHUNK"]
        assert 0 < atomics <= -(-q // C8["CHUNK"]) * t
    if "NaN" in case:
        assert want.tally[1] > 0
