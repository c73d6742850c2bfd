"""The continuous window digest of the PyTorch port (``cont_dev``: fz_nz,
and fz's windows on the on-the-fly route) against the JAX package's
``cont_tests_begin`` / ``cont_tests_finish`` and against the port's own host
digest (``scheduler.Dispatcher._finish_mcw``), on the CPU in float64 (the
JAX package under x64), on tables made from a seed with numpy.

- ``statfuns.pcor_dp_tensor`` equals numpy's ``pcor_dp`` bit for bit on
  random (B, 5, 5) submatrices with k = 0..3, |r| = 1 (den == 0), NaN and
  1e-5 rounding ties, at max_k 0, 1 and 3.
- The digest against the JAX engine's: exit_e equal, wstat rtol 1e-9 /
  atol 1e-12, wpval rtol 1e-8 where the JAX package's log erfc is exact
  (its argument below 8), elsewhere against scipy's ``fz_pval`` of the
  port's own wstat (the JAX package's series past 8, ROADMAP queue 3).
- The digest against the host digest on the same round: exit_e equal;
  for the candidates without an exit, wstat equal and wpval rtol 1e-9 (the
  host's maximum runs over all tests, the device's over the significant
  ones, and the consumer reads only candidates without an exit).
- Networks (max_k 3, multi_il, convergence_threshold 0, no feed-forward,
  n_obs_min 20, as ``tests/test_condtests.py:344``): the port's device
  digest gives the host digest's network (edges identical, weights rtol
  1e-9) and the JAX package's device-digest network (edges identical,
  weights atol 2e-5, one step of the pcor DP's rounding grid).
- The flag: on only for fz_nz and fz on the fly, at max_k > 0, by default
  only on CUDA.
"""

import numpy as np
import pytest
import torch
from scipy.special import erfc

from flashweave_tpu.learning.lgl import LGL as jLGL
from flashweave_tpu.ops import condtests as jct
from flashweave_tpu_torch.learning.hiton import _combo_template
from flashweave_tpu_torch.learning.lgl import LGL as tLGL
from flashweave_tpu_torch.learning.scheduler import Dispatcher
from flashweave_tpu_torch.ops import condtests as tct
from flashweave_tpu_torch.ops import statfuns as tsf

ALPHA = 0.01
ATOL_PCOR = 2e-5


def _table(n=300, p=42, seed=8, zeros=0.0):
    """Continuous columns in chains of three (column 3j + 1 mixes 3j in,
    3j + 2 mixes 3j + 1 in), a fraction ``zeros`` of the entries set to 0
    before the mixing (fz_nz)."""
    rng = np.random.default_rng(seed)
    data = np.log1p(rng.poisson(3.0, (n, p)) + rng.random((n, p)))
    data[rng.random((n, p)) < zeros] = 0.0
    data[:, 1::3] = 0.8 * data[:, 0::3] + 0.2 * data[:, 1::3]
    data[:, 2::3] = 0.5 * data[:, 1::3] + 0.5 * data[:, 2::3]
    return data


def _synth_table(n=400, p=60, group=5, seed=1):
    """log1p of a grouped 3-level table (bench.py's fz_nz LGL input)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 3, (n, p // group))
    data = np.repeat(base, group, axis=1)
    flip = rng.random((n, p)) < 0.35
    data = np.where(flip, rng.integers(0, 3, (n, p)), data).astype(float)
    return np.where(data > 0, np.log1p(data), 0.0)


def _round(p, NC, seed, max_k=3):
    """A round of NC candidate windows as the scheduler ships it: var lists
    [T, cand, Zs...] with 1..6 Zs, the subsets of each in the reference's
    order (``_combo_template``).  A quarter of the candidates are T's
    neighbour in a chain (3j, 3j + 1), so some pass every test; a quarter
    are the chain's far end (3j, 3j + 2) with the middle 3j + 1 among the
    Zs, so they exit at the first subset that holds it."""
    rng = np.random.default_rng(seed)
    vls, pos, kv, counts = [], [], [], []
    for c in range(NC):
        a = int(rng.integers(1, 7))
        j = 3 * int(rng.integers(0, p // 3))
        rest = np.setdiff1d(np.arange(p), [j, j + 1, j + 2])
        if c % 4 == 0:
            v = [j, j + 1] + list(rng.choice(rest, a, replace=False))
        elif c % 4 == 1:
            zs = list(rng.choice(rest, a - 1, replace=False))
            zs.insert(int(rng.integers(0, a)), j + 1)
            v = [j, j + 2] + zs
        else:
            v = list(rng.choice(p, a + 2, replace=False))
        vls.append([int(x) for x in v])
        P, K = _combo_template(a, max_k)
        pos.append(P)
        kv.append(K)
        counts.append(len(K))
    return (vls, np.concatenate(pos), np.concatenate(kv),
            np.asarray(counts, np.int64))


def _nobs(data, vls, nz):
    if not nz:
        return np.full(len(vls), float(data.shape[0]))
    return np.array([float(((data[:, v[0]] != 0) & (data[:, v[1]] != 0)).sum())
                     for v in vls])


def _fz_pval(stat, n):
    z = np.sqrt(np.maximum(n - 3.0, 0)) / 2.0 * np.log((1 + stat) / (1 - stat))
    return erfc(np.abs(z) / np.sqrt(2.0)), np.abs(z) / np.sqrt(2.0)


# ---------------------------------------------------------------------------
# the pcor DP on tensors
# ---------------------------------------------------------------------------

def _submatrices(B=4000, seed=0):
    """Random symmetric (B, 5, 5) correlation submatrices with unit
    diagonals; some with |r| = 1 against a Z (den == 0), some NaN, some with
    Z columns of 0 and C[0, 1] on a 1e-5 rounding tie."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-0.95, 0.95, (B, 5, 5))
    C = (A + A.transpose(0, 2, 1)) / 2
    C[:, np.arange(5), np.arange(5)] = 1.0
    q = B // 8
    C[:q, 0, 2] = C[:q, 2, 0] = rng.choice([-1.0, 1.0], q)      # den == 0
    C[q:2 * q, 1, 3] = C[q:2 * q, 3, 1] = 1.0
    C[2 * q:3 * q, 0, 4] = np.nan
    t = slice(3 * q, 5 * q)
    C[t, :2, 2:] = 0.0
    C[t, 2:, :2] = 0.0
    ties = (rng.integers(-90_000, 90_000, 2 * q) + 0.5) / 1e5
    C[t, 0, 1] = C[t, 1, 0] = ties
    return C, rng.integers(0, 4, B)


@pytest.mark.parametrize("max_k", [0, 1, 3])
def test_pcor_dp_tensor_equals_numpy(max_k):
    C, kvec = _submatrices()
    # the ties really are ties: half-way between two points of the grid
    t = C[1500:2500, 0, 1] * 1e5
    assert (np.abs(t - np.trunc(t)) == 0.5).sum() > 100
    want = tsf.pcor_dp(C, kvec, max_k, xp=np)
    got = tsf.pcor_dp_tensor(torch.from_numpy(C), torch.from_numpy(kvec),
                             max_k).numpy()
    assert got.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.int64),
                                  want[ok].view(np.int64))
    # den == 0 gives 0 from the first step on; the NaN enters at the third
    assert (want[ok] == 0.0).any() == (max_k > 0)
    assert np.isnan(want).any() == (max_k == 3)


# ---------------------------------------------------------------------------
# the digest against the JAX package's and the host digest
# ---------------------------------------------------------------------------

CASES = [
    # test, on the fly, candidates, chunked
    ("fz_nz", False, 120, False),
    ("fz_nz", False, 300, True),
    ("fz", True, 120, False),
    ("fz", True, 300, True),
]


def _engines(test, onfly, monkeypatch):
    nz = test == "fz_nz"
    data = _table(zeros=0.3 if nz else 0.0)
    monkeypatch.setattr(jct, "FORCE_COR_ONFLY", onfly)
    monkeypatch.setattr(tct, "FORCE_COR_ONFLY", onfly)
    monkeypatch.setattr(tct, "FORCE_CONT_DEV", True)
    teng = tct.CondTestEngine(data, test, 3, hps=5, n_obs_min=20,
                              device="cpu")
    assert teng.cont_dev and teng.nz == nz
    jeng = jct.CondTestEngine(data, test, 3, hps=5, n_obs_min=20)
    return data, teng, jeng


def _port_digest(teng, rnd, chunked, monkeypatch):
    vls, POS, KV, counts = rnd
    if chunked:
        # 64-candidate segments, chunks of at most ~2,000 tests
        monkeypatch.setattr(tct, "MCOR_SEG", 64)
        monkeypatch.setattr(tct, "CONT_SUB_BYTES", 2000 * 8 * 25)
    before = tct.N_TESTS_DISPATCHED
    handles = teng.cont_tests_begin(vls, POS, KV, counts, ALPHA)
    assert tct.N_TESTS_DISPATCHED == before + len(KV)
    assert (len(handles) > 2) == chunked
    return teng.cont_tests_finish(handles)


@pytest.mark.parametrize("test,onfly,NC,chunked", CASES)
def test_digest_matches_jax(test, onfly, NC, chunked, monkeypatch):
    data, teng, jeng = _engines(test, onfly, monkeypatch)
    rnd = _round(data.shape[1], NC, seed=NC)
    ex, ws, wp = _port_digest(teng, rnd, chunked, monkeypatch)
    jex, jws, jwp = jeng.cont_tests_finish(
        jeng.cont_tests_begin(*rnd, ALPHA))
    assert ex.dtype == np.int64 and ws.dtype == wp.dtype == np.float64
    assert ex.shape == ws.shape == wp.shape == (NC,)
    np.testing.assert_array_equal(ex, jex)
    # every outcome is there: an exit at the first test, a later exit, none
    assert (ex == 0).any() and (ex > 0).any() and (ex == -1).any()
    np.testing.assert_allclose(ws, jws, rtol=1e-9, atol=1e-12)
    pv, z = _fz_pval(ws, _nobs(data, rnd[0], teng.nz))
    sig = wp > 0
    exact = sig & (z < 7.9)
    assert exact.any() and (sig & ~exact).any()
    np.testing.assert_allclose(wp[exact], jwp[exact], rtol=1e-8)
    np.testing.assert_allclose(wp[sig & ~exact], pv[sig & ~exact], rtol=1e-9,
                               atol=1e-300)
    np.testing.assert_array_equal(jwp[~sig], 0.0)


@pytest.mark.parametrize("test,onfly,NC,chunked", CASES)
def test_digest_matches_host_digest(test, onfly, NC, chunked, monkeypatch):
    data, teng, _ = _engines(test, onfly, monkeypatch)
    vls, POS, KV, counts = rnd = _round(data.shape[1], NC, seed=NC + 1)
    ex, ws, wp = _port_digest(teng, rnd, chunked, monkeypatch)
    host = {}
    handles = teng.masked_cor_begin([(v[0], v[1]) for v in vls], vls,
                                    plain=not teng.nz)
    Dispatcher(teng, ALPHA, fast=True)._finish_mcw(
        ("host", handles, [(0, NC)], POS, KV, counts), host)
    hex_, hws, hwp = host[0]
    np.testing.assert_array_equal(ex, hex_)
    noex = ex == -1
    assert noex.sum() >= 10 and (counts[noex] > 1).any()
    np.testing.assert_array_equal(ws[noex], hws[noex])
    np.testing.assert_allclose(wp[noex], hwp[noex], rtol=1e-9, atol=1e-300)


def test_digest_clips_correlations():
    """C is clipped to [-1, 1] before the DP, as the JAX digest does: an
    entry one ulp past 1 is r = 1, significant, where the unclipped value
    would give a NaN log p (not significant)."""
    C = torch.eye(3, dtype=torch.float64).repeat(2, 1, 1)
    C[:, 0, 1] = C[:, 1, 0] = torch.tensor([np.nextafter(1.0, 2.0), 0.5])
    one = torch.ones(2, dtype=torch.int64)
    out = tct._cont_digest(C, torch.full((2,), 50.0), one, 0 * one[:, None],
                           0 * one, 2, 1, np.log(ALPHA), 20.0).numpy()
    np.testing.assert_array_equal(out[0], [-1, -1])
    np.testing.assert_array_equal(out[1], [1.0, 0.5])
    assert out[2][0] == 0.0 and 0.0 < out[2][1] < ALPHA


def test_digest_below_n_obs_min():
    """With fewer rows than n_obs_min no test is significant: every
    candidate exits at its first test and has wpval 0."""
    data = _table(60, 12)
    eng = tct.CondTestEngine(data, "fz_nz", 3, n_obs_min=61, device="cpu")
    rnd = _round(12, 20, seed=5)
    ex, ws, wp = eng.cont_tests_finish(eng.cont_tests_begin(*rnd, ALPHA))
    np.testing.assert_array_equal(ex, 0)
    np.testing.assert_array_equal(wp, 0.0)
    assert np.isfinite(ws).all()


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------

KW = dict(max_k=3, parallel="multi_il", time_limit=0.0,
          convergence_threshold=0.0, feed_forward=False, verbose=False,
          n_obs_min=20)


def _edges(g):
    return sorted((u, v, w) for u, v, w in g.edges())


def _port_net(data, test, monkeypatch, cont_dev, onfly=False, spy=None):
    monkeypatch.setattr(tct, "FORCE_CONT_DEV", cont_dev)
    monkeypatch.setattr(tct, "FORCE_COR_ONFLY", onfly)
    return _edges(tLGL(data, test_name=test, device="cpu", **KW).graph)


def _same(got, want, **tol):
    assert len(want) > 20
    assert [e[:2] for e in got] == [e[:2] for e in want]
    np.testing.assert_allclose([e[2] for e in got], [e[2] for e in want],
                               **tol)


@pytest.mark.parametrize("test", ["fz_nz", "fz"])
def test_network_equals_host_digest(test, monkeypatch):
    data = _synth_table()
    calls = []
    begin = tct.CondTestEngine.cont_tests_begin

    def spy(self, *args):
        calls.append(len(args[2]))
        return begin(self, *args)

    monkeypatch.setattr(tct.CondTestEngine, "cont_tests_begin", spy)
    onfly = test == "fz"
    host = _port_net(data, test, monkeypatch, False, onfly)
    assert not calls
    dev = _port_net(data, test, monkeypatch, True, onfly)
    assert calls and sum(calls) > 1000
    _same(dev, host, rtol=1e-9)
    if onfly:
        # fz on the fly through the device digest against fz materialized
        # (the gather and the host DP)
        _same(dev, _port_net(data, test, monkeypatch, False, False),
              rtol=1e-9)


@pytest.mark.parametrize("test", ["fz_nz", "fz"])
def test_network_equals_jax_device_digest(test, monkeypatch):
    data = _synth_table()
    onfly = test == "fz"
    got = _port_net(data, test, monkeypatch, True, onfly)
    monkeypatch.setattr(jct, "FORCE_CONT_DEV", True)
    monkeypatch.setattr(jct, "FORCE_COR_ONFLY", onfly)
    want = _edges(jLGL(data, test_name=test, **KW).graph)
    _same(got, want, rtol=0, atol=ATOL_PCOR)


# ---------------------------------------------------------------------------
# the flag
# ---------------------------------------------------------------------------

def test_cont_dev_flag(monkeypatch):
    cont = _table(50, 9, seed=0)
    disc = np.random.default_rng(0).integers(0, 3, (50, 9)).astype(float)

    def flag(test, max_k=3, data=cont, **kw):
        return tct.CondTestEngine(data, test, max_k, device="cpu",
                                  **kw).cont_dev

    # the default off the card: off
    for test in ("fz_nz", "fz"):
        assert not flag(test)
    monkeypatch.setattr(tct, "FORCE_COR_ONFLY", True)
    assert not flag("fz")
    monkeypatch.setattr(tct, "FORCE_CONT_DEV", True)
    assert flag("fz_nz") and flag("fz")
    for test in ("mi", "mi_nz"):
        assert not flag(test, data=disc)
    assert not flag("fz_nz", max_k=0) and not flag("fz", max_k=0)
    monkeypatch.setattr(tct, "FORCE_COR_ONFLY", False)
    assert not flag("fz")                                  # materialized
    assert not flag("fz", cor_mat=np.eye(9))
    monkeypatch.setattr(tct, "FORCE_CONT_DEV", False)
    monkeypatch.setattr(tct, "FORCE_COR_ONFLY", True)
    assert not flag("fz_nz") and not flag("fz")
