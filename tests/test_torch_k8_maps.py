"""The work split of K8, the univariate extraction sweep
(``csrc/mi_univar_extract.cu``), replayed in numpy on the CPU.

The CUDA kernel runs only on the card.  These tests replay, with the
kernel's constants read from its source, how it splits a block: a grid of
blocks striding over tiles of TILE consecutive pairs of one row, a tile
wholly at X >= Y skipped; each tile staged (NaN for a pair without power,
+inf for a position that holds no pair); front "mi" counting-sorts the
tile by chain class, each pair ranked within its class by warp-aggregated
atomics (the warps' steps interleaved at random), the classes' first places
by a scan and the tile positions in ``order[]``, and a warp runs 32
neighbouring sorted chains (the groups dealt in snake order); then the
compaction in tile order: a warp's candidates by ballots, the warps' counts
scanned and one global atomic a tile taking the slots, in an order of the
blocks drawn at random; the slots below the budget written; each block's
histogram of bins (the edges a candidate's log p is below) folded into the
counts below each edge at its end, with its unreliable pairs.  The replay's
tally must equal the plain version's (``kernels.univar_extract_ref``)
exactly and its candidates be the plain version's as a set, bit for bit;
past a cut budget its slots hold distinct candidates and the cursor counts
on.
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
from flashweave_tpu_torch.state import from_numpy_continuous, from_numpy_state

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
# the shared memory of an SM that its blocks may use (H100: 228 KB, 1 KB of
# it reserved a block) and its registers
SM_SMEM, BLOCK_RESERVED, SM_REGS = 233_472, 1024, 65_536


def _static_smem():
    """K8's static shared memory in bytes, from the ``__shared__`` arrays
    of its kernel."""
    text = (CSRC / "mi_univar_extract.cu").read_text()
    size = {"double": 8, "unsigned short": 2, "unsigned char": 1, "int": 4,
            "unsigned": 4, "unsigned long long": 8}
    total = 0
    for typ, name, dims in re.findall(
            r"__shared__ ([\w ]+?) (\w+)((?:\[[^\]]+\])*);", text):
        n = 1
        for dim in re.findall(r"\[([^\]]+)\]", dims):
            n *= int(eval(dim.replace("/", "//"), {}, dict(C8)))
        total += size[typ] * n
    return total


def test_constants_match_the_wrapper():
    c = C8
    assert c["N_EDGES"] == K.K8_EDGES == U.N_EXTRACT_BINS
    assert c["TALLY"] == K.K8_TALLY == 2 + K.K8_EDGES
    assert c["TILE"] == K.K8_TILE
    assert c["THREADS"] % 32 == 0 and c["WARPS"] == c["THREADS"] // 32
    # a tile is whole rows of the block, whole wide loads a thread
    assert c["TILE"] % (c["THREADS"] * c["VEC"]) == 0
    assert c["ITEMS"] * c["THREADS"] == c["TILE"]
    assert c["GROUPS"] * c["VEC"] == c["ITEMS"]
    # the class scan takes a class a thread; order[] holds 16-bit places
    assert c["THREADS"] == c["CLASSES"] == 2 * c["HALF"]
    assert c["PAD"] == c["CLASSES"] - 1 and c["TILE"] <= 1 << 16
    # the histogram has a bin for every count of edges, 0..N_EDGES, and the
    # block folds it with a thread an edge
    assert c["N_EDGES"] < c["THREADS"]
    # MIN_BLOCKS blocks an SM: their shared memory (static, under the 48 KB
    # a block may hold without opting in) and 64 registers a thread
    smem = _static_smem()
    assert c["TILE"] * 10 < smem <= 48 * 1024
    assert c["MIN_BLOCKS"] * (smem + BLOCK_RESERVED) <= SM_SMEM
    assert c["MIN_BLOCKS"] * c["THREADS"] * 64 <= SM_REGS


def chain_class(d):
    """mi_digest.cuh's chain_class<HALF>: df / 2, evens first."""
    half = C8["HALF"]
    return np.where(d & 1, half + np.minimum(d >> 1, half - 2),
                    np.minimum(d >> 1, half - 1))


def _staged(front, outs, s, y0, max_df):
    """Each pair's value after the staging and the chains, as K8 leaves it
    in shared memory (the plain chain's log p, 0 for a pair with power and
    df outside 1..max_df, NaN without power, +inf where no pair), its chain
    df (0: none) and its stat."""
    if front == "mi":
        stat, df, nobs, suff = (o.numpy() for o in outs)
        v = sf.mi_logpval_smalldf(outs[0], outs[1], outs[2], max_df).numpy()
    else:
        v, stat, suff = (o.numpy() for o in outs)
        df = np.zeros(stat.shape, np.int64)
    t, q = stat.shape
    pair = (np.arange(s, s + t)[:, None] < np.arange(y0, y0 + q)[None, :])
    power = pair & np.broadcast_to(suff, (t, q))
    chain = power & (df >= 1) & (df <= max_df) if front == "mi" else \
        np.zeros((t, q), bool)
    if front == "mi":
        v = np.where(chain, v, 0.0)
    v = np.where(pair, np.where(power, v, np.nan), math.inf)
    return v, np.where(chain, df, 0), stat


def _interleaved(rng, warps, steps):
    """A random order of every warp's steps that keeps each warp's own
    order: (warp, step) pairs."""
    left = [steps] * warps
    out = []
    while any(left):
        w = rng.choice([i for i in range(warps) if left[i]])
        out.append((w, steps - left[w]))
        left[w] -= 1
    return out


def _warp_classes(rng, cls, each):
    """A pass over the tile in the kernel's order, item k of thread tid at
    position k THREADS + tid, the warps' steps interleaved at random: for
    every step, each class among the warp's lanes and its lanes' positions
    (in lane order) to ``each``."""
    T = C8["THREADS"]
    for w, k in _interleaved(rng, C8["WARPS"], C8["ITEMS"]):
        p = k * T + 32 * w + np.arange(32)
        for u in np.unique(cls[p]):
            each(u, p[cls[p] == u])


def _sort_tile(cls, rng, checks):
    """The tile's counting sort by chain class, replayed: a pass counting
    each class (a warp's lanes of a class with one add), the classes'
    first places by an exclusive scan, a pass scattering each position to
    its class's next places (one add a warp's lanes of a class, the lanes
    in order behind it), ``order[]``.  Returns (order, chains) and records
    the checks."""
    c = C8
    W, PAD = c["WARPS"], c["PAD"]
    count = np.zeros(c["CLASSES"], np.int64)

    def add(u, peers):
        count[u] += len(peers)

    _warp_classes(rng, cls, add)
    at = np.concatenate([[0], np.cumsum(count)[:-1]])
    chains = int(at[PAD])
    order = np.full(c["TILE"], -1, np.int64)

    def scatter(u, peers):
        order[at[u] + np.arange(len(peers))] = peers
        at[u] += len(peers)

    _warp_classes(rng, cls, scatter)
    # order[] is a permutation of the tile: its chains first, by class
    assert np.array_equal(np.sort(order), np.arange(c["TILE"]))
    sc = cls[order[:chains]]
    assert (np.diff(sc) >= 0).all() and (cls[order[chains:]] == PAD).all()
    # a warp 32 sorted chains, the groups dealt in snake order; its lanes
    # share one class but where the group holds a class boundary
    groups = -(-chains // 32)
    ran = np.zeros(W, np.int64)
    for g in range(groups):
        w = g % W if (g // W) % 2 == 0 else W - 1 - g % W
        ran[w] += 1
        lanes = sc[32 * g:32 * g + 32]
        checks["mixed"] += bool((np.diff(lanes) != 0).any())
        checks["groups"] += 1
    assert ran.max() - ran.min() <= 1
    checks["boundaries"] += int((np.diff(sc) != 0).sum())
    checks["classes"] |= set(sc.tolist())
    return order, chains


def _replay(front, outs, s, y0, thresh, reliable, max_df, edges, cap, grid,
            seed, checks=None):
    """K8's launch on one block, replayed: returns (tally, slots, atomics,
    skipped tiles)."""
    c = C8
    T, TILE, W, ITEMS = c["THREADS"], c["TILE"], c["WARPS"], c["ITEMS"]
    PAD = c["PAD"]
    checks = {} if checks is None else checks
    for key in ("mixed", "groups", "boundaries", "sorted", "one_class"):
        checks.setdefault(key, 0)
    checks.setdefault("classes", set())
    val, dchain, stat = _staged(front, outs, s, y0, max_df)
    t, q = val.shape
    tiles_row = -(-q // TILE)
    tiles = t * tiles_row
    grid = min(grid, tiles)
    tally = np.zeros(c["TALLY"], np.int64)
    X = np.full(cap, -1, np.int64)
    Y = np.full(cap, -1, np.int64)
    LP = np.zeros(cap)
    ST = np.zeros(cap)
    # the tile counter: each block asks for one tile at its start and one
    # more as it starts each tile; a random block finishes its tile next
    sched = [0, 0]

    def ask():
        sched[0] += 1
        return sched[0] - 1

    current = {b: ask() for b in range(grid)}
    hist = np.zeros((grid, c["N_EDGES"] + 1), np.int64)
    unrel_b = np.zeros(grid, np.int64)
    rng = np.random.default_rng(seed)
    atomics = skipped = 0
    pos = np.arange(TILE)
    while current:
        b = list(current)[rng.integers(len(current))]
        tile = current[b]
        if tile >= tiles:                    # the block is done
            del current[b]
            sched[1] += 1
            if sched[1] == grid:             # the last one resets both
                sched[:] = [0, 0]
            continue
        current[b] = ask()
        row, col0 = tile // tiles_row, (tile % tiles_row) * TILE
        x = s + row
        n = min(TILE, q - col0)
        lo = x - y0 - col0
        if lo >= n - 1:                      # wholly at X >= Y
            assert np.isinf(val[row, col0:col0 + n]).all()
            skipped += 1
            continue
        inside = (pos < n) & (pos > lo)
        cols = col0 + np.minimum(pos, n - 1)
        lp = np.where(inside, val[row, cols], math.inf)
        if front == "mi":
            dch = np.where(inside, dchain[row, cols], 0)
            cls = np.where(dch > 0, chain_class(dch), PAD)
            classes = np.unique(cls[cls != PAD])
            if len(classes) == 1:            # the chains in tile order
                checks["one_class"] += 1
            elif len(classes) > 1:
                checks["sorted"] += 1
                _sort_tile(cls, rng, checks)
        # the compaction in tile order: item k of thread tid at k T + tid
        P = np.arange(ITEMS)[:, None] * T + np.arange(T)[None, :]
        v = lp[P]
        nan = np.isnan(v)
        unrel_b[b] += int(nan.sum())
        v = np.where(nan, math.inf if reliable else 0.0, v)
        cand = (v < thresh).reshape(ITEMS, W, 32)
        warp_n = cand.sum(axis=(0, 2))
        inc = np.cumsum(warp_n)              # warp 0's shuffle scan
        base = tally[0]
        if inc[-1]:
            atomics += 1
            tally[0] += inc[-1]
        for w in range(W):
            slot = int(base + inc[w] - warp_n[w])
            for k in range(ITEMS):
                lanes = np.flatnonzero(cand[k, w])
                at = slot + np.arange(len(lanes))
                p = k * T + 32 * w + lanes
                keep = at < cap
                X[at[keep]], Y[at[keep]] = x, y0 + col0 + p[keep]
                LP[at[keep]] = v[k, 32 * w + lanes[keep]]
                ST[at[keep]] = stat[row, col0 + p[keep]]
                if edges is not None:
                    bins = (v[k, 32 * w + lanes][:, None]
                            < edges[None, :]).sum(axis=1)
                    np.add.at(hist[b], bins, 1)
                slot += len(lanes)
    # each launch leaves the tile counters at 0
    assert sched == [0, 0]
    tally[1] = unrel_b.sum()
    if edges is not None:
        for j in range(c["N_EDGES"]):
            tally[2 + j] = hist[:, j + 1:].sum()
    kept = min(int(tally[0]), cap)
    return tally, (X[:kept], Y[:kept], LP[:kept], ST[:kept]), atomics, skipped


def _grouped(n, p, levels, seed, nz1=False):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, levels, (n, p // 5))
    data = np.repeat(base, 5, axis=1)
    data = np.where(rng.random(data.shape) < 0.35,
                    rng.integers(0, levels, data.shape), data)
    if nz1:
        data[:, ::3] = np.minimum(data[:, ::3], 1)
    return data.astype(np.float64)


# a block whose rows' first tiles lie wholly at X >= Y, the next cut by
# the diagonal, the last ragged; P columns, the block's (s, t, y0, q)
P = 5200
BLOCK = (4100, 24, 5, 5190)


def _mi_block(nz, levels=3, seed=5, n=400):
    """K1's (or, past 4 levels, K4's) plain outputs on a grouped table's
    block of ``n`` observations, and its max_df."""
    data = _grouped(n, P, levels, seed, nz1=nz == 1)
    st = from_numpy_state(data, None, None, "cpu")
    s, t, y0, q = BLOCK
    fn = K.mi_univar_stats_ref if levels <= 4 else \
        K.mi_univar_stats_planes_ref
    outs = fn(st.dataT, st.marg, st.levels, st.max_vals, s, t, st.L, y0, q,
              nz, 5.0, 20.0)
    return outs, (min(st.L, int(st.levels_np.max())) - 1) ** 2


def _given_block(kind):
    rng = np.random.default_rng(2)
    s, t, y0, q = BLOCK
    if kind == "fz_nz":
        data = np.where(rng.random((300, P)) < 0.4, 0.0,
                        np.log1p(rng.poisson(3.0, (300, P))
                                 + rng.random((300, P))))
        r, N = K.fz_nz_stats_ref(from_numpy_continuous(data, "cpu"), s, t,
                                 y0, q)
        return U._given_scores((r, N), 20.0)
    data = np.log1p(rng.poisson(3.0, (300, P)) + rng.random((300, P)))
    data[:, 7::11] = 0.5                                  # NaN r
    xc, ssd = U._fz_center(torch.from_numpy(data))
    r = U.fz_block(xc, ssd, s, t, y0, q)
    return U._given_scores((r, torch.tensor(300.0, dtype=torch.float64)),
                           20.0)


def _check(front, outs, s, y0, reliable, max_df, cut,
           grids=((3, 0), (1 << 20, 1))):
    """The replayed launch against ``univar_extract_ref`` on the same
    block: the tally exactly, the candidates as a set bit for bit (or,
    past the cut, distinct candidates of the plain version's in every
    slot), at a small grid (several tiles a block) and a large one.
    Returns the plain version's buffers and the replay's checks of the
    sort."""
    edges = U._extract_edges(0.05, P * (P - 1) // 2)
    thresh = math.log(0.05)
    t, q = outs[0].shape
    want = K.ExtractBuffers(t * q, "cpu", edges, max_df)
    K.univar_extract_ref(want, front, outs, s, y0, thresh, reliable, max_df)
    kept = int(want.tally[0])
    assert kept > 50
    wx, wy, wl, ws = (c.numpy() for c in want.candidates(kept))
    wkey = wx.astype(np.int64) * (1 << 32) + wy
    cap = kept // 3 if cut else t * q
    checks = {}
    for grid, seed in grids:
        tally, (gx, gy, gl, gs), atomics, skipped = _replay(
            front, outs, s, y0, thresh, reliable, max_df, edges, cap, grid,
            seed, checks)
        np.testing.assert_array_equal(tally, want.tally.numpy())
        gkey = gx * (1 << 32) + gy
        assert len(np.unique(gkey)) == len(gkey) == min(cap, kept)
        at = np.searchsorted(wkey, gkey)
        np.testing.assert_array_equal(wkey[at], gkey)
        np.testing.assert_array_equal(wl[at].view(np.int64),
                                      gl.view(np.int64))
        np.testing.assert_array_equal(ws[at].view(np.int64),
                                      gs.view(np.int64))
        # one global atomic for each tile that holds a candidate; the rows
        # run past one tile; the tiles wholly at X >= Y skipped
        TILE = C8["TILE"]
        tiles_row = -(-q // TILE)
        col0 = np.arange(tiles_row) * TILE
        last = y0 + np.minimum(col0 + TILE, q) - 1      # a tile's last Y
        skips = int((np.arange(s, s + t)[:, None] >= last[None, :]).sum())
        assert tiles_row > 1 and skipped == skips
        assert 0 < atomics <= t * tiles_row - skipped
    return want, checks


CASES = [("mi nz 2", True), ("mi nz 1, NaN stats", False),
         ("given, fz 0-dim power", True), ("mi nz 2, budget cut", True),
         ("mi L 12", True), ("given, fz_nz", False),
         ("mi nz 1, NaN stats", True)]


@pytest.mark.parametrize("case,reliable", CASES)
def test_replay_equals_the_plain_version(case, reliable):
    """The replayed launch against ``univar_extract_ref`` on the same
    block (:func:`_check`): mi at L = 3 with nz 1 and 2, L = 12 (max_df
    121), fz with constant columns (NaN r, one power flag), fz_nz,
    reliable both ways, NaN stats with pairs without power, and a cut
    inside the block."""
    s, _, y0, _ = BLOCK
    if case.startswith("given"):
        front, max_df = "given", 0
        outs = _given_block("fz_nz" if "fz_nz" in case else "fz")
        if "fz 0-dim" in case:
            assert outs[2].dim() == 0 and torch.isnan(outs[0]).any()
    else:
        front = "mi"
        if "L 12" in case:
            (stat, df, nobs, suff), max_df = _mi_block(1, levels=12,
                                                       n=2000)
            assert max_df == 121 and int(df.max()) > 20
        else:
            (stat, df, nobs, suff), max_df = _mi_block(
                1 if "nz 1" in case else 2)
        if "NaN" in case:
            stat = stat.clone()
            stat[::3] = math.nan
            rng = np.random.default_rng(3)
            suff = suff & torch.from_numpy(rng.random(tuple(suff.shape))
                                           > 0.1)
        outs = (stat, df, nobs, suff)
    want, checks = _check(front, outs, s, y0, reliable, max_df,
                          "cut" in case)
    if "NaN" in case:
        assert want.tally[1] > 0
    if front == "mi":
        # a tile of one chain class runs its chains in tile order, the
        # others sorted; the warps that meet two classes are at most the
        # boundaries
        assert checks["one_class"] + checks["sorted"] > 0
        if "L 12" in case:                   # df 1..121 in a tile
            assert checks["sorted"] > 0
        assert checks["mixed"] <= checks["boundaries"]
        assert checks["mixed"] < max(checks["groups"], 1)


def test_tile_sort_every_class():
    """A tile that holds every chain class (df 1..300 past both classes'
    shared last class at max_df 300), df 0 and past max_df, and pairs
    without power: ``order[]`` a permutation of the tile, its chains first
    and sorted by class, each warp's lanes one class but at a boundary, the
    replay equal to the plain version."""
    rng = np.random.default_rng(11)
    s, t, y0, q = 0, 2, 0, 4500
    max_df = 300
    df = rng.integers(1, max_df + 1, (t, q))
    df[:, :max_df] = np.arange(1, max_df + 1)
    df[:, 7::97] = 0
    df[:, 11::89] = max_df + 5
    nobs = rng.integers(30, 400, (t, q))
    x = 10.0 ** rng.uniform(-1, np.log10(3 * max_df), (t, q))
    stat = x / nobs * rng.choice([-1.0, 1.0], (t, q))
    suff = rng.random((t, q)) > 0.05
    outs = (torch.from_numpy(stat), torch.from_numpy(df.astype(np.int32)),
            torch.from_numpy(nobs.astype(np.int32)), torch.from_numpy(suff))
    want, checks = _check("mi", outs, s, y0, True, max_df, False,
                          grids=((2, 4),))
    assert want.tally[1] > 0
    # every chain class: evens 1..HALF-1, odds HALF..2 HALF-2
    assert checks["classes"] == set(range(1, C8["PAD"]))
    assert 0 < checks["mixed"] <= checks["boundaries"]


def test_grid_is_asked_once_a_device(monkeypatch):
    """K8's grid: the SMs times the resident blocks, each asked once a
    device and kept."""
    calls = []

    def sms(index):
        calls.append(("sms", index))
        return 132

    def per_sm(index):
        calls.append(("blocks", index))
        return 4

    monkeypatch.setattr(K, "_K8_GRID", {})
    monkeypatch.setattr(K, "_sm_count", sms)
    monkeypatch.setattr(K, "k8_blocks_per_sm", per_sm)
    assert K.k8_grid("cuda:0") == K.k8_grid(torch.device("cuda", 0)) == 528
    assert calls == [("sms", 0), ("blocks", 0)]
    assert K.k8_grid("cuda:1") == 528
    assert calls[2:] == [("sms", 1), ("blocks", 1)]
