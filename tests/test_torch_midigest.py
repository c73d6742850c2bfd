"""The mi / mi_nz device digests of the PyTorch port against the JAX
package's and against the port's host digest, on the CPU in float64 (the
JAX package under x64), on tables made from a seed with numpy.

- The shared per-candidate reduction (``condtests._digest_reduce``) on hand
  cases: ties on the largest log p (the last index wins), a candidate whose
  every test is significant, one that exits at its first test, single-test
  candidates.
- The log-p chain (``statfuns.mi_logpval_smalldf``, two chains advanced
  together) against a where over the whole batch for every df: bit for
  bit, max_df 1..121.
- X2, the window digest (``mi_tests_begin_digest`` /
  ``mi_tests_finish_digest``), against the JAX engine's on the same round,
  in one chunk and in several (``CHUNK_ELEMS``): exit_e equal, wstat rtol
  1e-12, wpval rtol 1e-9 where the JAX package's log erfc is exact
  (sqrt(|mi| n_obs) of the weakest test below 7.9), elsewhere against
  scipy's chi2 survival function of the weakest test (the JAX package's
  series past 8, ROADMAP queue 3).  And against the port's host digest
  (``scheduler._scan_digest``) on the same per-test results: exit_e equal;
  wstat equal and wpval rtol 1e-9 for the candidates without an exit (the
  only ones the consumer reads).
- X1, the turbo window digest (``turbo_tests_begin`` /
  ``turbo_tests_finish``), against the JAX engine's with the same
  template, at m = 3 and 6, nz-uniform, generic nz and plain mi, with the
  windows' tables in one chunk and in several (``TURBO_PLANE_BYTES``),
  with X2's tolerances (wstat where a slot has a significant test); and
  against X2 over the same tests laid out flat (the histogram's tables).
- Networks (max_k 3, multi_il, convergence_threshold 0, no feed-forward,
  n_obs_min 20) on a 400 x 60 grouped table (mi_nz at 3 levels, mi at 2)
  and on a table of 2- and 3-level variables (mi_nz through the generic nz
  branch, mi at 3 levels): the device window digest equals the host
  digest (edges identical, weights rtol 1e-9, tests dispatched equal); the
  turbo digest equals the histogram windows (edges identical, weights rtol
  1e-12); both on equal the JAX package's device digests (edges identical,
  weights rtol 1e-9).  Spies show that each path ran.
- The flags follow their gates; the hooks force either way inside them.
"""

import math

import numpy as np
import pytest
import torch
from scipy.stats import chi2

from flashweave_tpu.learning.lgl import LGL as jLGL
from flashweave_tpu.ops import condtests as jct
from flashweave_tpu_torch.learning import hiton as thiton
from flashweave_tpu_torch.learning.hiton import (_combo_template,
                                                 _turbo_mxu_template,
                                                 _turbo_template)
from flashweave_tpu_torch.learning.lgl import LGL as tLGL
from flashweave_tpu_torch.learning.scheduler import _scan_digest
from flashweave_tpu_torch.ops import condtests as tct
from flashweave_tpu_torch.ops import statfuns as tsf
from flashweave_tpu_torch.utils.misc import get_levels, get_max_vals

ALPHA = 0.01


def _chain_table(levels, n=400, p=48, seed=3, flip=0.3):
    """Columns in chains of three: column 3j + 1 is a noisy copy of 3j and
    3j + 2 a noisy copy of 3j + 1, so 3j and 3j + 2 are independent given
    3j + 1.  ``levels`` 2 or 3, or "mixed": every third chain binary, the
    others 3-level (the generic nz branch)."""
    rng = np.random.default_rng(seed)
    cols = []
    for j in range(p // 3):
        L = (2 if j % 3 == 0 else 3) if levels == "mixed" else levels
        c = rng.integers(0, L, n)
        for _ in range(3):
            cols.append(c)
            c = np.where(rng.random(n) < flip, rng.integers(0, L, n), c)
    return np.stack(cols, axis=1).astype(np.float64)


def _grouped(levels=3, n=400, p=60, group=5, seed=1):
    """A grouped table (chip_smoke.py's synth_table at 400 x 60)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, levels, (n, p // group))
    data = np.repeat(base, group, axis=1)
    flip = rng.random((n, p)) < 0.35
    return np.where(flip, rng.integers(0, levels, (n, p)),
                    data).astype(np.float64)


def _turbo_synth(n=2000, seed=5):
    """The table of ``tests/test_learning.py``'s turbo tests: blocks of
    noisy copies of a latent (full windows hold), chains Z -> X -> Y
    (interleaving rejections) and determined children T = A + B of binary
    A, B with a noisy copy of T (elimination mispredicts); binary and
    3-level variables mixed."""
    rng = np.random.default_rng(seed)

    def noisy(src, frac):
        c = src.copy()
        fl = rng.random(n) < frac
        c[fl] = rng.integers(0, 3, int(fl.sum()))
        return c

    cols = []
    for _ in range(4):
        z = rng.integers(0, 3, n)
        cols.extend(noisy(z, 0.15) for _ in range(4))
    for _ in range(3):
        z = rng.integers(0, 3, n)
        x = noisy(z, 0.2)
        y = noisy(x, 0.2)
        cols.extend([z, x, y])
    for _ in range(3):
        a = rng.integers(0, 2, n)
        b = rng.integers(0, 2, n)
        t = a + b
        cols.extend([a, b, t, noisy(t, 0.1)])
    return np.stack(cols, axis=1).astype(np.float64)


TABLES = {"uniform": lambda: _chain_table(3), "binary": lambda: _chain_table(2),
          "mixed": lambda: _chain_table("mixed")}


def _engines(test, table, max_k, monkeypatch):
    data = TABLES[table]()
    levels, maxv = get_levels(data), get_max_vals(data)
    monkeypatch.setattr(tct, "FORCE_DEV_DIGEST", True)
    teng = tct.CondTestEngine(data, test, max_k, levels=levels,
                              max_vals=maxv, hps=5, device="cpu")
    jeng = jct.CondTestEngine(data, test, max_k, levels=levels,
                              max_vals=maxv, hps=5)
    assert teng.dev_digest and teng.turbo_mxu and jeng.turbo_mxu
    assert teng.nzu == (table == "uniform" and test == "mi_nz")
    assert teng.L == (2 if table == "binary" else 3)
    return data, teng, jeng


def _round(p, NC, max_k, seed):
    """A round of NC candidate windows as the scheduler ships them: target,
    candidate and a list of 1..5 Zs whose subsets (``_combo_template``) are
    the candidate's tests.  A quarter of the candidates are T's neighbour
    in a chain (3j, 3j + 1), so most pass every test; a quarter the chain's
    far end (3j, 3j + 2) with the middle among the Zs, so they exit at the
    first subset that holds it; the rest are drawn at random."""
    rng = np.random.default_rng(seed)
    X, Y, Zs, kv, counts = [], [], [], [], []
    for c in range(NC):
        a = int(rng.integers(1, 6))
        j = 3 * int(rng.integers(0, p // 3))
        rest = np.setdiff1d(np.arange(p), [j, j + 1, j + 2])
        if c % 4 == 0:
            t, y, zs = j, j + 1, list(rng.choice(rest, a, replace=False))
        elif c % 4 == 1:
            t, y = j, j + 2
            zs = list(rng.choice(rest, a - 1, replace=False))
            zs.insert(int(rng.integers(0, a)), j + 1)
        else:
            t, y, *zs = (int(v) for v in rng.choice(p, a + 2, replace=False))
        pos, k = _combo_template(a, max_k)
        Z = np.asarray(zs, np.int64)[pos]
        Z[np.arange(max_k)[None, :] >= k[:, None]] = 0
        X.append(np.full(len(k), t))
        Y.append(np.full(len(k), y))
        Zs.append(Z)
        kv.append(k)
        counts.append(len(k))
    return (np.concatenate(X), np.concatenate(Y), np.concatenate(Zs),
            np.concatenate(kv).astype(np.int64), np.asarray(counts, np.int64))


def _weakest(per_test, counts, max_df):
    """Per candidate: whether a test is significant, and |mi| * n_obs and
    df of the weakest significant test (the last with the largest log p),
    from the per-test results and the port's log p."""
    stat, df, n_obs, suff = per_test
    logp = tsf.mi_logpval_smalldf(torch.from_numpy(stat),
                                  torch.from_numpy(df),
                                  torch.from_numpy(n_obs), max_df).numpy()
    sig = suff & (logp < np.log(ALPHA))
    NC = len(counts)
    has, x, d = np.zeros(NC, bool), np.zeros(NC), np.zeros(NC, np.int64)
    o = 0
    for c, k in enumerate(counts):
        ls = np.where(sig[o:o + k], logp[o:o + k], -np.inf)
        if sig[o:o + k].any():
            w = o + np.flatnonzero(ls == ls.max())[-1]
            has[c], x[c], d[c] = True, abs(stat[w]) * n_obs[w], df[w]
        o += k
    return has, x, d


def _check_wpval(wp, jwp, weak):
    """wpval: against the JAX digest's where its log erfc is exact, else
    against scipy's chi2 survival function of the weakest test; 0 without a
    significant test."""
    has, x, d = weak
    exact = has & (np.sqrt(x) < 7.9)
    far = has & ~exact
    assert exact.any() and far.any()
    np.testing.assert_allclose(wp[exact], jwp[exact], rtol=1e-9)
    np.testing.assert_allclose(wp[far], chi2.sf(2 * x[far], d[far]),
                               rtol=1e-9, atol=1e-300)
    np.testing.assert_array_equal(wp[~has], 0.0)
    np.testing.assert_array_equal(jwp[~has], 0.0)


# ---------------------------------------------------------------------------
# the shared reduction
# ---------------------------------------------------------------------------

def test_digest_reduce_hand_cases():
    """Five candidates: every test significant with a tie on the largest
    log p (-5 at local 1 and 2: the last wins); every test significant;
    an exit at local 0 with a significant test after it; one significant
    test; one non-significant test."""
    logp = torch.tensor([-10.0, -5.0, -5.0, -8.0,  -9.0, -7.0,
                         -1.0, -9.0,  -6.0,  -0.5], dtype=torch.float64)
    stat = torch.arange(10, dtype=torch.float64) + 0.5
    counts = torch.tensor([4, 2, 2, 1, 1])
    cand, offs, loc = tct._segments(counts, 10)
    assert cand.tolist() == [0, 0, 0, 0, 1, 1, 2, 2, 3, 4]
    assert loc.tolist() == [0, 1, 2, 3, 0, 1, 0, 1, 0, 0]
    out = tct._digest_reduce(logp, stat, logp < np.log(ALPHA), cand, loc,
                             offs, 5, 10).numpy()
    np.testing.assert_array_equal(out[0], [-1, -1, 0, -1, 0])
    np.testing.assert_array_equal(out[1], [2.5, 5.5, 7.5, 8.5, 9.5])
    np.testing.assert_array_equal(out[2], np.exp([-5.0, -7.0, -9.0, -6.0,
                                                  -np.inf]))


# ---------------------------------------------------------------------------
# the log-p chain
# ---------------------------------------------------------------------------

def _logpval_per_df(mi, df, n_obs, max_df):
    """``statfuns.mi_logpval_smalldf`` as one where over the whole batch
    for every df, each branch's logsumexp chain extended in the JAX
    package's order: the reference the two-chain loop is held to."""
    def lse2(a, b):
        m = torch.maximum(a, b)
        m = torch.where(torch.isfinite(m), m, 0.0)
        return m + torch.log(torch.exp(a - m) + torch.exp(b - m))

    x = torch.abs(mi) * n_obs.to(mi.dtype)
    logx = torch.log(torch.clamp(x, min=1e-300))
    ler = tsf.log_erfc(torch.sqrt(x))
    out = torch.zeros_like(x)
    acc_e = torch.zeros_like(x)
    acc_o = None
    for d in range(1, max_df + 1):
        k = d // 2
        if d % 2 == 0:
            logq = -x + acc_e if k > 1 else -x
            acc_e = lse2(acc_e, k * logx - math.lgamma(k + 1))
        elif k == 0:
            logq = ler
        else:
            t = (k - 0.5) * logx - math.lgamma(k + 0.5)
            acc_o = t if acc_o is None else lse2(acc_o, t)
            logq = lse2(ler, -x + acc_o)
        out = torch.where(df == d, logq, out)
    return torch.clamp(out, max=0.0)


@pytest.mark.parametrize("max_df", [1, 2, 5, 8, 36, 108, 121])
def test_logpval_chain_equals_per_df_loop(max_df):
    """The two-chain loop gives every element the per-df loop's value bit
    for bit (signed zeros included), for df from -1 past max_df, with
    x = 0, NaN, inf, subnormal and large, in one and two dimensions."""
    rng = np.random.default_rng(max_df)
    B = 20_000
    x = np.concatenate([rng.exponential(50, B // 2), rng.uniform(0, 2000, B // 4),
                        np.zeros(B // 8), np.full(B - B // 2 - B // 4 - B // 8,
                                                  1e-320)])
    mi = x / 100.0 * rng.choice([-1, 1], B)
    mi[:6] = [np.nan, np.inf, 0.0, -0.0, 1e300, 5e-324]
    n_obs = np.full(B, 100.0)
    n_obs[6:20] = 0.0
    df = rng.integers(-1, max_df + 3, B)
    for shape in ((B,), (100, B // 100)):
        args = [torch.from_numpy(a.reshape(shape)) for a in (mi, df, n_obs)]
        got = tsf.mi_logpval_smalldf(*args, max_df).numpy()
        want = _logpval_per_df(*args, max_df).numpy()
        same = ((got.view(np.int64) == want.view(np.int64))
                | (np.isnan(got) & np.isnan(want)))
        assert same.all()


# ---------------------------------------------------------------------------
# X2: the window digest
# ---------------------------------------------------------------------------

X2_CASES = [
    # test, table, max_k, chunked
    ("mi_nz", "uniform", 2, False),
    ("mi_nz", "uniform", 2, True),
    ("mi_nz", "mixed", 2, True),
    ("mi", "binary", 3, False),
    ("mi", "binary", 3, True),
]


def _port_x2(teng, rnd, chunked, monkeypatch):
    calls = []
    kernel = tct._mi_cond_kernel

    def spy(*args, **kw):
        calls.append(len(args[3]))
        return kernel(*args, **kw)

    monkeypatch.setattr(tct, "_mi_cond_kernel", spy)
    if chunked:
        monkeypatch.setattr(tct, "CHUNK_ELEMS", teng.n * 100)
    before = tct.N_TESTS_DISPATCHED
    got = teng.mi_tests_finish_digest(
        teng.mi_tests_begin_digest(*rnd, ALPHA))
    assert tct.N_TESTS_DISPATCHED == before + len(rnd[0])
    assert sum(calls) == len(rnd[0]) and (len(calls) > 2) == chunked
    return got


@pytest.mark.parametrize("test,table,max_k,chunked", X2_CASES)
def test_mi_digest_matches_jax(test, table, max_k, chunked, monkeypatch):
    data, teng, jeng = _engines(test, table, max_k, monkeypatch)
    rnd = _round(data.shape[1], 160, max_k, seed=max_k + chunked)
    ex, ws, wp = _port_x2(teng, rnd, chunked, monkeypatch)
    jex, jws, jwp = jeng.mi_tests_finish_digest(
        jeng.mi_tests_begin_digest(*rnd, ALPHA))
    assert ex.dtype == np.int64 and ws.dtype == wp.dtype == np.float64
    assert ex.shape == ws.shape == wp.shape == (160,)
    np.testing.assert_array_equal(ex, jex)
    # every outcome is there: an exit at the first test, a later exit, none
    assert (ex == 0).any() and (ex > 0).any() and (ex == -1).any()
    np.testing.assert_allclose(ws, jws, rtol=1e-12, atol=0)
    per_test = teng.mi_tests_finish_lazy(teng.mi_tests_begin(*rnd[:4]))
    _check_wpval(wp, jwp, _weakest(per_test, rnd[4],
                                   (teng.L - 1) ** 2 * teng.S_hist))


@pytest.mark.parametrize("test,table,max_k,chunked", X2_CASES)
def test_mi_digest_matches_host_digest(test, table, max_k, chunked,
                                       monkeypatch):
    data, teng, _ = _engines(test, table, max_k, monkeypatch)
    rnd = _round(data.shape[1], 160, max_k, seed=7 + max_k)
    ex, ws, wp = _port_x2(teng, rnd, chunked, monkeypatch)
    counts = rnd[4]
    stat, df, n_obs, suff = teng.mi_tests_finish_lazy(
        teng.mi_tests_begin(*rnd[:4]))
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    hex_, w_loc, maxp, _ = _scan_digest(stat, df, n_obs, suff, offs, counts,
                                        ALPHA)
    np.testing.assert_array_equal(ex, hex_)
    noex = ex == -1
    assert noex.sum() >= 10 and (counts[noex] > 1).any()
    np.testing.assert_array_equal(ws[noex], stat[offs + w_loc][noex])
    np.testing.assert_allclose(wp[noex], maxp[noex], rtol=1e-9, atol=1e-300)


# ---------------------------------------------------------------------------
# X1: the turbo window digest
# ---------------------------------------------------------------------------

X1_CASES = [
    # test, table, max_k, m, chunked
    ("mi_nz", "uniform", 3, 3, False),
    ("mi_nz", "uniform", 2, 6, True),
    ("mi_nz", "mixed", 2, 3, True),
    ("mi_nz", "mixed", 2, 6, False),
    ("mi", "binary", 3, 3, True),
    ("mi", "binary", 3, 6, False),
    ("mi", "mixed", 2, 6, True),
]


def _windows(p, W, m, seed):
    """W full-target windows of m candidates: a target 3j, its chain's two
    other columns in random places among the candidates, the rest drawn at
    random, so that windows hold, exit in the interleaving or eliminate."""
    rng = np.random.default_rng(seed)
    Ts, cands = [], []
    for _ in range(W):
        j = 3 * int(rng.integers(0, p // 3))
        rest = np.setdiff1d(np.arange(p), [j, j + 1, j + 2])
        c = [j + 1, j + 2] + list(rng.choice(rest, m - 2, replace=False))
        Ts.append(j)
        cands.append(rng.permutation(c))
    return np.asarray(Ts, np.int64), np.asarray(cands, np.int64)


def _flat_windows(Ts, cands, max_k):
    """The windows' tests laid out as the histogram path ships them (the
    "miwin" request of ``hiton._turbo_target``): slots candidates[1:] +
    candidates, each with ``_turbo_template``'s subsets."""
    IDX, KV, COUNTS = _turbo_template(cands.shape[1], max_k)
    X, Y, Zs = [], [], []
    for T, c in zip(Ts, cands):
        X.append(np.full(len(KV), T))
        Y.append(np.repeat(np.concatenate([c[1:], c]), COUNTS))
        Z = c[IDX]
        Z[np.arange(max_k)[None, :] >= KV[:, None]] = 0
        Zs.append(Z)
    W = len(Ts)
    return (np.concatenate(X), np.concatenate(Y), np.concatenate(Zs),
            np.tile(KV, W).astype(np.int64), np.tile(COUNTS, W))


@pytest.mark.parametrize("test,table,max_k,m,chunked", X1_CASES)
def test_turbo_digest_matches_jax(test, table, max_k, m, chunked,
                                  monkeypatch):
    data, teng, jeng = _engines(test, table, max_k, monkeypatch)
    tpl = _turbo_mxu_template(m, max_k)
    W = 40
    Ts, cands = _windows(data.shape[1], W, m, seed=m + max_k)
    calls = []
    pair_stats = tct._turbo_pair_stats

    def spy(*args):
        calls.append(len(args[3]))
        return pair_stats(*args)

    monkeypatch.setattr(tct, "_turbo_pair_stats", spy)
    if chunked:
        monkeypatch.setattr(tct, "TURBO_PLANE_BYTES",
                            7 * 4 * teng.n * tpl["U"] * teng.S)
    before = tct.N_TESTS_DISPATCHED
    handle = teng.turbo_tests_begin(m, Ts, cands, ALPHA, tpl)
    assert tct.N_TESTS_DISPATCHED == before + W * tpl["B"]
    assert calls == ([7] * 5 + [5] if chunked else [W])
    ex, ws, wp = teng.turbo_tests_finish(handle)
    jex, jws, jwp = jeng.turbo_tests_finish(
        jeng.turbo_tests_begin(m, Ts, cands, ALPHA, tpl))
    NC = tpl["NC"]
    assert ex.dtype == np.int64 and ws.dtype == wp.dtype == np.float64
    assert ex.shape == ws.shape == wp.shape == (W, NC)
    np.testing.assert_array_equal(ex, jex)
    assert (ex == 0).any() and (ex > 0).any() and (ex == -1).any()
    # the same tests through the histogram and the window digest
    flat = _flat_windows(Ts, cands, max_k)
    fex, fws, fwp = teng.mi_tests_finish_digest(
        teng.mi_tests_begin_digest(*flat, ALPHA))
    np.testing.assert_array_equal(ex.reshape(-1), fex)
    np.testing.assert_allclose(ws.reshape(-1), fws, rtol=1e-12, atol=0)
    np.testing.assert_allclose(wp.reshape(-1), fwp, rtol=1e-9, atol=1e-300)
    per_test = teng.mi_tests_finish_lazy(teng.mi_tests_begin(*flat[:4]))
    weak = _weakest(per_test, flat[4], (teng.L - 1) ** 2 * teng.S)
    _check_wpval(wp.reshape(-1), jwp.reshape(-1), weak)
    # wstat of a slot without a significant test is never read: the JAX
    # turbo digest writes 0 there, the shared reduction the slot's first
    # stat (as the JAX window digest does)
    has = weak[0].reshape(W, NC)
    assert (~has).any()
    np.testing.assert_allclose(ws[has], jws[has], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(jws[~has], 0.0)


def test_turbo_template_cached(monkeypatch):
    """The template's device tensors are built once for each m."""
    _, teng, _ = _engines("mi_nz", "uniform", 2, monkeypatch)
    Ts, cands = _windows(48, 4, 4, seed=0)
    tpl = _turbo_mxu_template(4, 2)
    first = teng.turbo_tests_finish(teng.turbo_tests_begin(4, Ts, cands,
                                                           ALPHA, tpl))
    const = teng._turbo_dev_cache[4]
    again = teng.turbo_tests_finish(teng.turbo_tests_begin(4, Ts, cands,
                                                           ALPHA, tpl))
    assert teng._turbo_dev_cache[4] is const and list(teng._turbo_dev_cache) == [4]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------

KW = dict(max_k=3, parallel="multi_il", time_limit=0.0,
          convergence_threshold=0.0, feed_forward=False, verbose=False,
          n_obs_min=20)

NETS = [
    # test, table
    ("mi_nz", "grouped"),          # nz-uniform, 3 levels
    ("mi", "grouped2"),            # mi's default binary tables
    ("mi_nz", "synth"),            # generic nz
    ("mi", "synth"),               # plain mi at 3 levels
]


def _net_table(table):
    return {"grouped": lambda: _grouped(3), "grouped2": lambda: _grouped(2),
            "synth": _turbo_synth}[table]()


def _edges(g):
    return sorted((u, v, w) for u, v, w in g.edges())


def _port_net(data, test, monkeypatch, dev_digest=None, turbo=None):
    monkeypatch.setattr(tct, "FORCE_DEV_DIGEST", dev_digest)
    monkeypatch.setattr(tct, "FORCE_TURBO_MXU", turbo)
    stats = {}
    monkeypatch.setattr(thiton, "WINDOW_STATS", stats)
    before = tct.N_TESTS_DISPATCHED
    edges = _edges(tLGL(data, test_name=test, device="cpu", **KW).graph)
    return edges, tct.N_TESTS_DISPATCHED - before, stats


def _same(got, want, rtol):
    assert len(want) > 20
    assert [e[:2] for e in got] == [e[:2] for e in want]
    np.testing.assert_allclose([e[2] for e in got], [e[2] for e in want],
                               rtol=rtol, atol=0)


def _digest_spy(monkeypatch):
    calls = []
    begin = tct.CondTestEngine.mi_tests_begin_digest

    def spy(self, *args):
        calls.append(len(args[0]))
        return begin(self, *args)

    monkeypatch.setattr(tct.CondTestEngine, "mi_tests_begin_digest", spy)
    return calls


@pytest.mark.parametrize("test,table", NETS)
def test_network_device_digest_equals_host_digest(test, table, monkeypatch):
    data = _net_table(table)
    calls = _digest_spy(monkeypatch)
    host, n_host, _ = _port_net(data, test, monkeypatch, dev_digest=False)
    assert not calls
    dev, n_dev, stats = _port_net(data, test, monkeypatch, dev_digest=True)
    assert sum(calls) >= 50 and stats.get("turbo_mxu", 0) > 0
    assert n_dev == n_host
    _same(dev, host, rtol=1e-9)


@pytest.mark.parametrize("test,table", NETS)
def test_network_turbo_equals_histogram_windows(test, table, monkeypatch):
    data = _net_table(table)
    on, _, stats = _port_net(data, test, monkeypatch)
    assert stats.get("turbo_mxu", 0) > 0, stats
    off, _, stats2 = _port_net(data, test, monkeypatch, turbo=False)
    assert stats2.get("turbo_mxu", 0) == 0 and stats2.get("turbo", 0) > 0
    _same(on, off, rtol=1e-12)


@pytest.mark.parametrize("test,table", NETS)
def test_network_equals_jax_device_digests(test, table, monkeypatch):
    data = _net_table(table)
    calls = _digest_spy(monkeypatch)
    got, _, stats = _port_net(data, test, monkeypatch, dev_digest=True)
    assert calls and stats.get("turbo_mxu", 0) > 0
    monkeypatch.setattr(jct, "FORCE_DEV_DIGEST", True)
    want = _edges(jLGL(data, test_name=test, **KW).graph)
    _same(got, want, rtol=1e-9)


# ---------------------------------------------------------------------------
# the flags
# ---------------------------------------------------------------------------

def test_digest_flags(monkeypatch):
    three = _chain_table(3, n=200, p=12)
    binary = _chain_table(2, n=200, p=12)
    twelve = _chain_table(12, n=200, p=12)

    def flags(data, test="mi_nz", max_k=3):
        eng = tct.CondTestEngine(data, test, max_k, hps=5, device="cpu")
        return eng.dev_digest, eng.turbo_mxu

    # the defaults off the card: the window digest on the host, turbo on
    assert flags(three) == (False, True)
    assert flags(three, "mi") == (False, True)
    assert flags(binary, "mi") == (False, True)
    assert flags(_chain_table("mixed", n=200, p=12)) == (False, True)
    monkeypatch.setattr(tct, "FORCE_DEV_DIGEST", True)
    assert flags(three) == (True, True)
    assert flags(binary, "mi") == (True, True)
    # strata compaction (n // hps + 1 = 21 < 27): the window digest only
    assert flags(three[:100]) == (True, False)
    # outside the gate the hooks change nothing
    monkeypatch.setattr(tct, "FORCE_TURBO_MXU", True)
    assert flags(twelve, "mi") == (False, False)
    assert flags(three, max_k=0) == (False, False)
    assert flags(_chain_table(4, n=200, p=12), max_k=3) == (False, False)
    assert flags(three[:100]) == (True, False)
    for test in ("fz", "fz_nz"):
        assert flags(three, test) == (False, False)
    monkeypatch.setattr(tct, "FORCE_TURBO_MXU", False)
    monkeypatch.setattr(tct, "FORCE_DEV_DIGEST", False)
    assert flags(three) == (False, False)
    assert flags(binary, "mi") == (False, False)
