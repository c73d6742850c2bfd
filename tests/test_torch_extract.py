"""The univariate device extraction of the PyTorch port (log-space p-values,
the BH-safe candidate sweep and log-space Benjamini-Hochberg) against the
JAX package and against the port's own host path.

- The log-space p-values (``statfuns.log_erfc``, ``mi_logpval_smalldf``,
  ``fz_logpval``) against the JAX package's under x64, rtol 1e-12 / atol
  1e-13 on the log values, wherever the JAX package evaluates erfc directly
  (z < 8).  Past z = 8 the JAX package takes a 3-term asymptotic series,
  exact for float32 but up to 7e-6 off in float64; there both are held
  against mpmath, the port at rtol 1e-12 and the JAX package within its
  series' first omitted term.  exp(log p) equals the port's host p-values
  (scipy) within rtol 1e-9 where p > 1e-290.
- The neighbor dicts of ``pw_univar_neighbors`` (the extraction) against
  the JAX package's ``_extract_scan`` on a one-device CPU mesh (same keys
  in the same insertion order, stats within rtol 1e-12, p within rtol 1e-9
  where p >= 1e-20, the region in which the JAX package's log p-values
  are exact; see ``_P_EXACT``) and against the port's host path
  (``return_result=True``: same keys, stats, p within rtol 1e-9).
"""

import math
import warnings

import jax.numpy as jnp
import mpmath
import numpy as np
import pytest
import torch

from flashweave_tpu.ops import statfuns as jsf
from flashweave_tpu.ops import univariate as juv
from flashweave_tpu.parallel.mesh import get_mesh
from flashweave_tpu_torch.ops import statfuns as sf
from flashweave_tpu_torch.ops import univariate as U
from flashweave_tpu_torch.types import PSortedNbrs

RTOL_LOG, ATOL_LOG = 1e-12, 1e-13
RTOL_P = 1e-9
# below this adjusted p the JAX package's p-value may come from its 3-term
# erfc series (z >= 8: p <= erfc(8) = 1.1e-29 for fz and df = 1, and BH's
# m <= 7.4e4 here scales that by at most 1e5)
_P_EXACT = 1e-20


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=RTOL_LOG, atol=ATOL_LOG):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _mp_log_erfc(z):
    return float(mpmath.log(mpmath.erfc(mpmath.mpf(float(z)))))


# ---------------------------------------------------------------------------
# X4: log-space p-values
# ---------------------------------------------------------------------------

def test_log_erfc_matches_jax_and_mpmath():
    z = np.concatenate([np.linspace(0.0, 8.0, 321)[:-1],
                        np.linspace(8.0, 40.0, 161)])
    got = sf.log_erfc(_t(z)).numpy()
    want = np.asarray(jsf.log_erfc(jnp.asarray(z)))
    direct = z < 8.0
    _close(got[direct], want[direct])
    ref = np.array([_mp_log_erfc(v) for v in z])
    _close(got, ref)
    # the JAX package's series past z = 8: within its first omitted term
    zt = z[~direct]
    assert (np.abs(want[~direct] - ref[~direct])
            <= 15.0 / (8.0 * zt ** 6) * 1.01).all()
    assert np.isnan(sf.log_erfc(torch.tensor([math.nan])).item())


def _mi_x():
    return np.concatenate([[0.0], np.geomspace(1e-6, 1e5, 40)])


@pytest.mark.parametrize("L", [3, 12])
def test_mi_logpval_smalldf_matches_jax(L):
    max_df = (L - 1) ** 2
    x = _mi_x()
    n_obs = np.full(x.shape, 1000.0)
    mi = x / n_obs
    for d in range(max_df + 1):
        df = np.full(x.shape, d)
        got = sf.mi_logpval_smalldf(_t(mi), _t(df), _t(n_obs), max_df).numpy()
        want = np.asarray(jsf.mi_logpval_smalldf(
            jnp.asarray(mi), jnp.asarray(df), jnp.asarray(n_obs), max_df))
        # odd df reach erfc(sqrt(x)), which the JAX package takes from its
        # series once sqrt(x) >= 8
        same = (x < 64.0) | (d % 2 == 0)
        _close(got[same], want[same])
        if d == 0:
            assert (got == 0.0).all()
            continue
        # exp(log p) against the host p-values (scipy gammaincc)
        host = sf.mi_pval(mi, df, n_obs)
        live = host > 1e-290
        np.testing.assert_allclose(np.exp(got[live]), host[live], rtol=RTOL_P)
        assert np.isfinite(got).all() and (got <= 0.0).all()
        # on past float64 underflow (x > 745), finite and decreasing in x
        assert (np.diff(got[x > 1e3]) < 0).all()


@pytest.mark.parametrize("d", [1, 2, 3, 5, 10, 121])
def test_mi_logpval_smalldf_matches_mpmath(d):
    x = np.array([1e-3, 0.7, 5.0, 63.0, 64.0, 100.0, 330.0, 900.0, 1e4, 1e5])
    got = sf.mi_logpval_smalldf(_t(x), _t(np.full(x.shape, d)),
                                _t(np.ones(x.shape)), 121).numpy()
    ref = [float(mpmath.log(mpmath.gammainc(d / 2.0, v, regularized=True)))
           for v in x]
    _close(got, ref)


def test_fz_logpval_matches_jax():
    rng = np.random.default_rng(0)
    r = np.concatenate([[1.0, -1.0, 0.0, math.nan, 0.999999, -0.5],
                        rng.uniform(-1.0, 1.0, 200)])
    N = np.array([0, 1, 2, 3, 4, 5, 30, 300, 2048, 100_000])
    rr, NN = (a.ravel() for a in np.meshgrid(r, N))
    NN = NN.astype(np.int32)
    got = sf.fz_logpval(_t(rr), _t(NN), 0).numpy()
    want = np.asarray(jsf.fz_logpval(jnp.asarray(rr),
                                     jnp.asarray(NN.astype(np.float64)), 0))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).sum() == ((NN > 3) & np.isnan(rr)).sum()
    z = np.abs(sf.fisher_z_transform(rr, NN, 0)) / math.sqrt(2.0)
    same = ~np.isnan(got) & (z < 8.0)
    _close(got[same], want[same])
    # r = +-1 with N > 3: log p = -inf on both sides; N <= 3: z = 0, p = 1
    edge = np.isin(rr, (1.0, -1.0))
    assert (got[edge & (NN > 3)] == -np.inf).all()
    assert (got[NN <= 3] == 0.0).all()
    tail = np.isfinite(got) & (z >= 8.0)
    _close(got[tail], [_mp_log_erfc(v) for v in z[tail]])
    host = sf.fz_pval(rr, NN, 0)
    live = ~np.isnan(got) & (host > 1e-290)
    np.testing.assert_allclose(np.exp(got[live]), host[live], rtol=RTOL_P)


# ---------------------------------------------------------------------------
# edges and bin choice
# ---------------------------------------------------------------------------

def test_extract_edges_and_select_bin_match_jax():
    rng = np.random.default_rng(1)
    assert U.N_EXTRACT_BINS == juv.N_EXTRACT_BINS
    assert U.EXTRACT_BUDGET == juv.EXTRACT_BUDGET
    for alpha in (0.01, 0.05, 1e-4):
        for n_pairs in (1, 2, 73_536, 2_147_450_880):
            edges = U._extract_edges(alpha, n_pairs)
            np.testing.assert_array_equal(edges,
                                          juv._extract_edges(alpha, n_pairs))
            for _ in range(20):
                counts = np.sort(rng.integers(0, n_pairs + 1,
                                              len(edges)))[::-1]
                counts[rng.integers(0, len(edges)):] = 0
                m = float(rng.integers(1, n_pairs + 1))
                assert (U._select_bin(counts, m, alpha, edges)
                        == juv._select_bin(counts, m, alpha, edges))


def _bh_trial(trial):
    """Trial ``trial`` of tests/test_univariate.py's BH-safety property:
    the same generator, seed 11, drawn in the same order."""
    rng = np.random.default_rng(11)
    for _ in range(trial + 1):
        m = int(rng.integers(500, 20000))
        n_signal = int(rng.integers(0, 200))
        pv = np.concatenate([rng.random(m - n_signal),
                             10 ** (-rng.random(n_signal) * 40)])
    return m, pv


@pytest.mark.parametrize("trial", range(40))
def test_select_bin_bh_safety_property(trial):
    """Every BH-significant p lies strictly below the selected edge, and the
    extracted superset stays within one geometric bin of the significant
    set."""
    alpha = 0.05
    m, pv = _bh_trial(trial)
    edges = U._extract_edges(alpha, m)
    logp = np.log(np.maximum(pv, 1e-300))
    counts = np.array([(logp < e).sum() for e in edges], dtype=np.int64)
    b = U._select_bin(counts, m, alpha, edges)
    adj = sf.benjamini_hochberg(pv, alpha=alpha, m=m)
    with np.errstate(invalid="ignore"):
        sig = np.nonzero(adj < alpha)[0]
    assert (logp[sig] < edges[b]).all(), (b, len(sig))
    if len(sig) and b + 1 < len(edges):
        surplus = int(counts[b]) - len(sig)
        bin_width_pairs = int(counts[max(b - 1, 0)]) - int(
            counts[b + 1]) + len(sig)
        assert surplus <= max(bin_width_pairs, 64), surplus


# ---------------------------------------------------------------------------
# the extraction against the JAX package's and the port's host path
# ---------------------------------------------------------------------------

def _grouped(n, p, L, seed=7):
    """tests/test_univariate.py's multi-block table: groups of 4 copies with
    40% of the entries redrawn, L levels."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, L, (n, p // 4))
    data = np.repeat(base, 4, axis=1).astype(np.float64)
    flip = rng.random((n, p)) < 0.4
    return np.where(flip, rng.integers(0, L, (n, p)).astype(np.float64), data)


def _case(name):
    """(test_name, data) of an extraction case."""
    if name == "mi_L3":
        return "mi", _grouped(256, 384, 3)
    if name == "mi_nz_nz2":           # every variable 3-level: nz-uniform
        return "mi_nz", _grouped(256, 384, 3)
    if name == "mi_nz_nz1":           # binary variables: per-variable offsets
        data = _grouped(256, 384, 3)
        data[:, ::3] = np.minimum(data[:, ::3], 1.0)
        return "mi_nz", data
    if name == "mi_L10":
        # K4's range (plain on the CPU); n = 800 gives a 10 x 10 table the
        # power (n / 64 > hps in the pre-check)
        return "mi", _grouped(800, 384, 10)
    rng = np.random.default_rng(8)
    data = _grouped(256, 384, 3)
    if name == "fz":                  # every entry nonzero: all rows count
        return "fz", np.log1p(data + rng.random(data.shape))
    return "fz_nz", np.where(data > 0, np.log1p(data + rng.random(data.shape)),
                             0.0)


CASES = ["mi_L3", "mi_nz_nz1", "mi_nz_nz2", "mi_L10", "fz_nz", "fz"]
FLAGS = [(True, True), (True, False), (False, True), (False, False)]
# the JAX package compiles its sweep for each Y-slab length and flag set,
# 10-50 s a run at L = 10 (81 df branches), so L = 10 is held against it at
# one block; at several blocks it is held against the port's host path
JAX_RUNS = [(c, f, t) for c in CASES for f in (FLAGS[0], FLAGS[3])
            for t in (None, 64) if c != "mi_L10" or (t is None and f[0])]


def _levels(test_name, data):
    if not test_name.startswith("mi"):
        return {}
    from flashweave_tpu_torch.utils.misc import get_levels, get_max_vals

    return dict(levels=get_levels(data), max_vals=get_max_vals(data))


def _kw(case, FDR, reliable, tile):
    test_name, data = _case(case)
    return data, dict(test_name=test_name, alpha=0.05, FDR=FDR, n_obs_min=20,
                      correct_reliable_only=reliable, tile=tile,
                      **_levels(test_name, data))


def _extract(data, kw):
    """The port's extraction on the CPU, checked for its route and n_sig."""
    info = {}
    got = U.pw_univar_neighbors(data, device="cpu", info=info, **kw)
    n_sig = sum(map(len, got.values())) // 2
    assert n_sig > 50
    assert info == dict(route="one sweep", K=info["K"], n_sig=n_sig)
    return got


def _assert_same_as_jax(got, want):
    assert len(got) == len(want)
    for v in want:
        assert isinstance(got[v], PSortedNbrs)
        assert list(got[v]) == list(want[v]), v
        if not got[v]:
            continue
        g = np.array(list(got[v].values()))
        w = np.array(list(want[v].values()))
        np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=1e-12, atol=0)
        exact = w[:, 1] >= _P_EXACT
        np.testing.assert_allclose(g[exact, 1], w[exact, 1], rtol=RTOL_P,
                                   atol=0)


def _assert_same_as_host(got, host):
    assert len(got) == len(host)
    for v in host:
        assert set(got[v]) == set(host[v]), v
        for y, (st, pv) in host[v].items():
            gst, gpv = got[v][y]
            assert math.isclose(gst, st, rel_tol=1e-12), (v, y)
            assert math.isclose(gpv, pv, rel_tol=RTOL_P, abs_tol=1e-300), (v, y)


@pytest.mark.parametrize("case,flags,tile", JAX_RUNS,
                         ids=[f"{c}-{f[0]}-{f[1]}-{t}" for c, f, t in JAX_RUNS])
def test_extract_matches_jax(case, flags, tile):
    """The JAX package's ``_extract_scan`` on a one-device CPU mesh (its
    XLA blocks, x64): same keys in the same order, stats and p."""
    data, kw = _kw(case, *flags, tile)
    got = _extract(data, kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = juv.pw_univar_neighbors(data, mesh=get_mesh(1), **kw)
    _assert_same_as_jax(got, want)


@pytest.mark.parametrize("tile", [None, 64])
@pytest.mark.parametrize("FDR,reliable", FLAGS)
@pytest.mark.parametrize("case", CASES)
def test_extract_matches_host_path(case, FDR, reliable, tile):
    """The port's host path (``return_result=True``): same keys, stats and
    p."""
    data, kw = _kw(case, FDR, reliable, tile)
    got = _extract(data, kw)
    host, _ = U.pw_univar_neighbors(data, device="cpu", return_result=True,
                                    **kw)
    _assert_same_as_host(got, host)


def _nan_table(n=300, p=40, seed=5):
    """fz_nz table whose odd columns are constant where they are nonzero:
    their correlations over the jointly nonzero rows are 0/0 (NaN)."""
    rng = np.random.default_rng(seed)
    data = np.log1p(rng.poisson(3.0, (n, p)) + rng.random((n, p)))
    data[:, 2::4] = 0.7 * data[:, 0::4] + 0.3 * data[:, 2::4]
    data[rng.random((n, p)) < 0.5] = 0.0
    data[:, 1::2] = np.where(data[:, 1::2] != 0, 2.0, 0.0)
    return data


@pytest.mark.parametrize("FDR,reliable", FLAGS)
def test_extract_nan_correlations_match_host_paths(FDR, reliable):
    """NaN log-p counts as unreliable: the extraction equals the port's
    host path and the JAX package's host path (which drop NaN p-values
    from BH's m)."""
    data = _nan_table()
    kw = dict(test_name="fz_nz", alpha=0.05, FDR=FDR, n_obs_min=20,
              correct_reliable_only=reliable)
    got = U.pw_univar_neighbors(data, device="cpu", **kw)
    host, res = U.pw_univar_neighbors(data, device="cpu", return_result=True,
                                      **kw)
    jax_host = juv.pw_univar_neighbors(data, **kw)
    assert np.isnan(res.stats[res.suff_power]).sum() > 100
    assert sum(map(len, got.values())) > 20
    _assert_same_as_host(got, host)
    _assert_same_as_host(got, jax_host)


@pytest.mark.parametrize("FDR,reliable", FLAGS)
def test_extract_fz_zero_variance_matches_host_paths(FDR, reliable):
    """fz with constant columns (NaN correlations): the extraction equals
    the port's host path and the JAX package's, and the JAX package's
    ``_extract_scan``, which counts a NaN log-p as unreliable for fz."""
    data = _case("fz")[1]
    data[:, 3::8] = 0.25
    kw = dict(test_name="fz", alpha=0.05, FDR=FDR, n_obs_min=20,
              correct_reliable_only=reliable)
    got = U.pw_univar_neighbors(data, device="cpu", **kw)
    host, res = U.pw_univar_neighbors(data, device="cpu", return_result=True,
                                      **kw)
    assert np.isnan(res.stats[res.suff_power]).sum() > 100
    assert sum(map(len, got.values())) > 20
    _assert_same_as_host(got, host)
    _assert_same_as_host(got, juv.pw_univar_neighbors(data, **kw))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = juv.pw_univar_neighbors(data, mesh=get_mesh(1), **kw)
    _assert_same_as_jax(got, want)


def test_second_sweep_and_refusal(monkeypatch):
    """Past the budget at log(alpha) the extraction sweeps again at the
    BH-safe edge and returns the same dicts; past the budget at that edge
    it raises."""
    test_name, data = _case("fz_nz")
    kw = dict(test_name=test_name, alpha=0.05, n_obs_min=20, tile=64)
    one = {}
    want = U.pw_univar_neighbors(data, device="cpu", info=one, **kw)
    assert one["route"] == "one sweep" and one["K"] > one["n_sig"] > 0
    monkeypatch.setattr(U, "EXTRACT_BUDGET", one["K"] - 1)
    two = {}
    got = U.pw_univar_neighbors(data, device="cpu", info=two, **kw)
    assert two["route"] == "two sweeps"
    assert one["n_sig"] <= two["K"] < one["K"]
    assert {v: list(d.items()) for v, d in got.items()} == \
        {v: list(d.items()) for v, d in want.items()}
    monkeypatch.setattr(U, "EXTRACT_BUDGET", two["K"] - 1)
    with pytest.raises(RuntimeError, match="extraction budget"):
        U.pw_univar_neighbors(data, device="cpu", **kw)
    # without FDR the edge is log(alpha) itself: past the budget it raises
    monkeypatch.setattr(U, "EXTRACT_BUDGET", one["K"] - 1)
    with pytest.raises(RuntimeError, match="extraction budget"):
        U.pw_univar_neighbors(data, device="cpu", FDR=False, **kw)


@pytest.mark.parametrize("case", ["mi_nz_nz2", "fz_nz", "fz"])
def test_default_route_never_condenses(case, monkeypatch):
    test_name, data = _case(case)

    def refuse(*args, **kwargs):
        raise AssertionError("a block was condensed on the host or the "
                             "p x p matrix built")

    monkeypatch.setattr(U, "_condense_block", refuse)
    monkeypatch.setattr(U, "cor_matrix", refuse)       # fz's p x p matrix
    kw = dict(test_name=test_name, n_obs_min=20, tile=64)
    nbrs = U.pw_univar_neighbors(data, device="cpu", **kw)
    assert sum(map(len, nbrs.values())) > 0
    with pytest.raises(AssertionError, match="condensed on the host"):
        U.pw_univar_neighbors(data, device="cpu", return_result=True, **kw)


# ---------------------------------------------------------------------------
# K8's plain version against the extraction before it, and the tail
# ---------------------------------------------------------------------------

def _old_block_scores(kind, outs, s, y_start, reliable, n_obs_min=0.0,
                      max_df=0):
    """The block scores of the extraction before K8, as they were."""
    if kind == "mi":
        stat, df, n_obs, suff = outs
        logp = sf.mi_logpval_smalldf(stat, df, n_obs, max_df)
    else:
        r, N = outs
        suff = N >= n_obs_min
        stat = torch.where(suff, r, 0.0)
        logp = sf.fz_logpval(stat, N, 0)
    t, q = logp.shape
    valid = (torch.arange(s, s + t)[:, None]
             < torch.arange(y_start, y_start + q)[None, :])
    unrel = valid & (~suff | torch.isnan(logp))
    logp = torch.where(unrel, math.inf if reliable else 0.0, logp)
    logp = torch.where(valid, logp, math.inf)
    return logp, stat, unrel.sum()


def _old_sweep(kind, blocks, thresh, reliable, n_obs_min, max_df, edges):
    """The sweep before K8 over (outs, s, y0) blocks: its candidates in
    order, the counts below each edge and the unreliable pairs."""
    parts, counts, unrel = [], 0, 0
    e = torch.as_tensor(edges, dtype=torch.float64)
    for outs, s, y0 in blocks:
        logp, stat, n_unrel = _old_block_scores(kind, outs, s, y0, reliable,
                                                n_obs_min, max_df)
        ylen = logp.shape[1]
        idx = torch.nonzero(logp.view(-1) < thresh).squeeze(1)
        lp = logp.view(-1)[idx]
        counts = counts + (lp[:, None] < e[None, :]).sum(dim=0)
        unrel = unrel + n_unrel
        parts.append((((idx // ylen) + s).to(torch.int32),
                      ((idx % ylen) + y0).to(torch.int32), lp,
                      stat.reshape(-1)[idx]))
    return [torch.cat(c) for c in zip(*parts)], counts, unrel


def _block_outs(case, nan_rows=False, seed=3):
    """(kind, n_obs_min, max_df, [(outs, s, y0)], p) of three blocks of a
    case's table from the plain block functions on the CPU, one on the
    diagonal and two off it."""
    from flashweave_tpu_torch.ops import kernels as K
    from flashweave_tpu_torch.state import (from_numpy_continuous,
                                            from_numpy_state)

    spans = [(0, 48, 0, 384), (100, 32, 40, 200), (200, 24, 150, 234)]
    if case == "mi_L12":
        data = _grouped(900, 384, 12)
        test_name = "mi"
    else:
        test_name, data = _case(case)
    p = data.shape[1]
    rng = np.random.default_rng(seed)
    blocks = []
    if test_name.startswith("mi"):
        st = from_numpy_state(data, None, None, "cpu")
        nz = 0 if test_name == "mi" else (2 if case == "mi_nz_nz2" else 1)
        max_df = (min(st.L, int(st.levels_np.max())) - 1) ** 2
        for s, t, y0, q in spans:
            stat, df, n_obs, suff = K.mi_univar_stats_ref(
                st.dataT, st.marg, st.levels, st.max_vals, s, t, st.L, y0, q,
                nz, 5.0, 20.0)
            if nan_rows:
                stat = stat.clone()
                stat[::5] = math.nan
                suff = suff & torch.from_numpy(rng.random((t, q)) > 0.1)
            blocks.append(((stat, df, n_obs, suff), s, y0))
        return "mi", 0.0, max_df, blocks, p
    table = from_numpy_continuous(data, "cpu")
    if test_name == "fz_nz":
        for s, t, y0, q in spans:
            r, N = K.fz_nz_stats_ref(table, s, t, y0, q)
            if nan_rows:
                r = r.clone()
                r[::5] = math.nan
            blocks.append(((r, N), s, y0))
        return "fz_nz", 20.0, 0, blocks, p
    xc, ssd = U._fz_center(table)
    n = torch.tensor(float(data.shape[0]), dtype=torch.float64)
    for s, t, y0, q in spans:
        r = U.fz_block(xc, ssd, s, t, y0, q)
        if nan_rows:
            r = r.clone()
            r[::5] = math.nan
        blocks.append(((r, n), s, y0))
    return "fz", 20.0, 0, blocks, p


def _fronted(kind, outs, n_obs_min):
    if kind == "mi":
        return "mi", outs
    return "given", U._given_scores(outs, n_obs_min)


REF_CASES = [(c, nan) for c in ("mi_L3", "mi_nz_nz1", "mi_nz_nz2", "mi_L12",
                                "fz_nz", "fz") for nan in (False, True)]


@pytest.mark.parametrize("reliable", [True, False])
@pytest.mark.parametrize("case,nan_rows", REF_CASES,
                         ids=[f"{c}-nan{n}" for c, n in REF_CASES])
def test_univar_extract_ref_equals_the_extraction_before_k8(case, nan_rows,
                                                            reliable):
    """K8's plain version over three blocks of a sweep, with and without
    NaN stats (and pairs without power): the cursor, the unreliable pairs,
    the counts below each edge and the candidates (X, Y, log p, stat, in
    order, bit for bit) of the sweep before K8; with the budget cut inside
    the second block, the same first slots and the cursor counting on."""
    from flashweave_tpu_torch.ops import kernels as K

    kind, n_obs_min, max_df, blocks, p = _block_outs(case, nan_rows)
    alpha = 0.05
    edges = U._extract_edges(alpha, p * (p - 1) // 2)
    la = math.log(alpha)
    want, counts, unrel = _old_sweep(kind, blocks, la, reliable, n_obs_min,
                                     max_df, edges)
    kept = len(want[0])
    assert kept > 100
    for cap in (sum(o[0].numel() for o, _, _ in blocks), kept - 37):
        buf = K.ExtractBuffers(cap, "cpu", edges, max_df)
        for outs, s, y0 in blocks:
            front, fo = _fronted(kind, outs, n_obs_min)
            K.univar_extract(buf, front, fo, s, y0, la, reliable, max_df)
        assert buf.tally[0] == kept and buf.kept == kept
        assert buf.tally[1] == unrel
        assert torch.equal(buf.tally[2:], counts)
        got = buf.candidates(min(cap, kept))
        for g, w in zip(got, want):
            w = w[:min(cap, kept)]
            assert g.dtype == w.dtype
            if g.dtype == torch.float64:
                g, w = g.view(torch.int64), w.view(torch.int64)
            assert torch.equal(g, w)
    if nan_rows:
        assert unrel > 0


def test_univar_extract_second_sweep_form_counts_nothing():
    """Without edges the tally counts the candidates and the unreliable
    pairs only; the candidates are those below the inner edge."""
    from flashweave_tpu_torch.ops import kernels as K

    kind, n_obs_min, max_df, blocks, p = _block_outs("mi_nz_nz2")
    edges = U._extract_edges(0.05, p * (p - 1) // 2)
    want, counts, unrel = _old_sweep(kind, blocks, float(edges[5]), True,
                                     n_obs_min, max_df, edges)
    buf = K.ExtractBuffers(10_000, "cpu", None, max_df)
    for outs, s, y0 in blocks:
        K.univar_extract(buf, "mi", outs, s, y0, float(edges[5]), True,
                         max_df)
    assert buf.tally[0] == len(want[0]) > 0
    assert buf.tally[1] == unrel and not buf.tally[2:].any()
    for g, w in zip(buf.candidates(len(want[0])), want):
        assert torch.equal(g, w)


def test_extract_buffers_check_their_edges():
    from flashweave_tpu_torch.ops import kernels as K

    assert K.K8_EDGES == U.N_EXTRACT_BINS
    edges = U._extract_edges(0.01, 1000)
    with pytest.raises(ValueError, match="strictly decreasing"):
        K.ExtractBuffers(8, "cpu", edges[::-1])
    with pytest.raises(ValueError, match="strictly decreasing"):
        K.ExtractBuffers(8, "cpu", edges[:10])
    flat = edges.copy()
    flat[3] = flat[4]
    with pytest.raises(ValueError, match="strictly decreasing"):
        K.ExtractBuffers(8, "cpu", flat)


def _old_tail(cand, p, m, alpha, FDR):
    """The extraction's tail before this change: the stable sort, BH's
    reverse cummin over every candidate, the one transfer and the loop
    that fills the dicts pair by pair."""
    la = math.log(alpha)
    nbr = {i: PSortedNbrs() for i in range(p)}
    X, Y, lp, stat = cand
    kept = lp.numel()
    slog, order = torch.sort(lp, stable=True)
    if FDR:
        ranks = torch.arange(1, kept + 1, dtype=torch.float64)
        terms = torch.where(slog < la, slog + math.log(m) - torch.log(ranks),
                            math.inf)
        ladj = torch.flip(torch.cummin(torch.flip(terms, (0,)), 0).values,
                          (0,))
        ladj = torch.clamp(ladj, max=0.0)
    else:
        ladj = slog
    n_sig = int((ladj < la).sum())
    order = order[:n_sig]
    rows = torch.stack([X[order].to(torch.float64),
                        Y[order].to(torch.float64), ladj[:n_sig],
                        stat[order]]).numpy()
    Xs, Ys = rows[0].astype(np.int64), rows[1].astype(np.int64)
    pvals, stats = np.exp(rows[2]), rows[3]
    tie = np.lexsort((U.condensed_pos(Xs, Ys, p), pvals))
    for x, y, st, pv in zip(Xs[tie], Ys[tie], stats[tie], pvals[tie]):
        entry = (float(st), float(pv))
        nbr[int(x)][int(y)] = entry
        nbr[int(y)][int(x)] = entry
    return nbr, n_sig


def _tied_candidates(p=300, K=20_000, seed=9):
    """K distinct pairs of p variables whose log p-values take 60 values
    (BH plateaus and exact ties), in condensed order."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.choice(p * (p - 1) // 2, K, replace=False))
    X, Y = U.condensed_to_pair(pos, p)
    levels = np.log(0.05) - np.concatenate([rng.exponential(1.0, 40),
                                            rng.exponential(20.0, 20)])
    lp = rng.choice(levels, K)
    stat = rng.standard_normal(K)
    return [torch.from_numpy(X.astype(np.int32)),
            torch.from_numpy(Y.astype(np.int32)), torch.from_numpy(lp),
            torch.from_numpy(stat)], p


@pytest.mark.parametrize("FDR", [True, False])
@pytest.mark.parametrize("m_scale", [3, 40])
def test_significant_is_order_free_and_equals_the_old_tail(FDR, m_scale):
    """The factored tail (``_significant``) on the candidates in condensed
    order and in two random permutations gives the old tail's dicts, item
    for item in insertion order, and its n_sig: tied log p-values get one
    adjusted p, so the significant prefix is one set, and the dicts insert
    by (adjusted p, condensed index) whatever the candidates' order."""
    cand, p = _tied_candidates()
    m = m_scale * len(cand[2])
    want, want_sig = _old_tail(cand, p, m, 0.05, FDR)
    assert 0 < want_sig <= len(cand[2])
    assert want_sig < len(cand[2]) or not FDR
    rng = np.random.default_rng(m_scale)
    for perm in (np.arange(len(cand[2])), rng.permutation(len(cand[2])),
                 rng.permutation(len(cand[2]))):
        got, n_sig = U._significant([c[perm] for c in cand], p, m, 0.05, FDR)
        assert n_sig == want_sig
        assert list(got) == list(want)
        for v in want:
            assert isinstance(got[v], PSortedNbrs)
            assert list(got[v].items()) == list(want[v].items()), v


def test_fill_dicts_equals_the_pair_loop():
    """The grouped fill inserts what the loop over the pairs inserts, in
    the same order in every dict, one tuple shared by both ends."""
    rng = np.random.default_rng(2)
    p, n = 500, 4000
    pos = rng.choice(p * (p - 1) // 2, n, replace=False)   # any order
    X, Y = U.condensed_to_pair(pos, p)
    stats, pvals = rng.standard_normal(n), rng.random(n)
    want = {i: PSortedNbrs() for i in range(p)}
    for x, y, st, pv in zip(X, Y, stats, pvals):
        entry = (float(st), float(pv))
        want[int(x)][int(y)] = entry
        want[int(y)][int(x)] = entry
    got = {i: PSortedNbrs() for i in range(p)}
    U._fill_dicts(got, X, Y, stats, pvals)
    for v in range(p):
        assert list(got[v].items()) == list(want[v].items())
        for w, e in got[v].items():
            assert e is got[w][v]
    empty = {0: PSortedNbrs()}
    U._fill_dicts(empty, X[:0], Y[:0], stats[:0], pvals[:0])
    assert empty == {0: {}}
