"""fz (FlashWeave-S: ``sensitive=True, heterogeneous=False``) in the PyTorch
port against the JAX package on the CPU, float64 on both sides (the JAX
package under x64), on tables made from a seed with numpy.

- ``cor_matrix`` and ``_fz_center`` with a zero-variance column: rtol 1e-12 /
  atol 1e-14, NaN positions equal; the r of ``fz_block`` on a block
  against ``cor_matrix``'s entries at the same tolerance (one product over
  the whole table, blocked otherwise).
- The conditioning engine's ``fz_tests_raw`` against the JAX engine's on the
  same 700 tests, on the materialized route (a gather from the (p, p)
  matrix) and on the on-the-fly route (a Gram a batch), with and without
  row chunks and several test chunks: stat rtol 1e-9 / atol 1e-12, p rtol
  1e-8, suff equal, NaN positions equal; the run-level n_obs_min sentinel.
- ``masked_cor_begin(plain=True)`` against the JAX package's
  ``_masked_cor_kernel(plain=True)``: n_obs exact, C rtol 1e-10 / atol
  1e-12.
- Networks: single and single_il give the JAX package's edges with weights
  within atol 2e-5 (the pcor DP rounds to a 1e-5 grid,
  ``ops/statfuns.pcor_dp``); multi_il stays within the reference's
  tolerance model; the on-the-fly route gives the materialized route's
  network, through the gather (``track_rejections``) and through the fast
  all-row windows.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashweave_tpu as fw
import flashweave_tpu_torch as fwt
from flashweave_tpu.ops import condtests as jct
from flashweave_tpu.ops import univariate as juv
from flashweave_tpu.utils.testing import compare_graph_results
from flashweave_tpu_torch.ops import condtests as tct
from flashweave_tpu_torch.ops import univariate as U

RTOL_COR, ATOL_COR = 1e-12, 1e-14
ATOL_PCOR = 2e-5


def _cont_table(n=300, p=30, seed=8):
    """Correlated continuous columns (every third a mix of its neighbour),
    column 7 constant."""
    rng = np.random.default_rng(seed)
    data = np.log1p(rng.poisson(3.0, (n, p)) + rng.random((n, p)))
    data[:, 1::3] = 0.5 * data[:, 0::3] + 0.5 * data[:, 1::3]
    data[:, 7] = 2.5
    return data


def _synth_table(n, p, group, seed=1):
    """Grouped 3-level table, built like bench.py's synthetic LGL input."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 3, (n, p // group)).astype(np.int8)
    data = np.repeat(base, group, axis=1)
    flip = rng.random((n, p)) < 0.35
    data = np.where(flip, rng.integers(0, 3, (n, p), dtype=np.int8), data)
    return data.astype(np.float64)


@pytest.fixture(scope="module")
def table():
    return _synth_table(400, 60, 5)


# ---------------------------------------------------------------------------
# the correlation matrix and the blocked sweep's operands
# ---------------------------------------------------------------------------

def test_cor_matrix_and_center_match_jax():
    data = _cont_table()
    got = U.cor_matrix(data, device="cpu").numpy()
    want = np.asarray(juv.cor_matrix(jnp.asarray(data)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[7]).all() and np.isnan(got[:, 7]).all()
    np.testing.assert_allclose(got, want, rtol=RTOL_COR, atol=ATOL_COR)
    assert np.nanmax(np.abs(got)) <= 1.0
    xc, ssd = U._fz_center(data, device="cpu")
    wxc, wssd = juv._fz_center(jnp.asarray(data))
    np.testing.assert_allclose(xc.numpy(), np.asarray(wxc), rtol=RTOL_COR,
                               atol=ATOL_COR)
    np.testing.assert_allclose(ssd.numpy(), np.asarray(wssd), rtol=RTOL_COR,
                               atol=ATOL_COR)
    assert ssd[7] == 0.0
    # a tensor stays on its device and in float64
    t = U.cor_matrix(torch.from_numpy(data.astype(np.float32)))
    assert t.dtype == torch.float64 and t.device.type == "cpu"


@pytest.mark.parametrize("block", [(0, 30, 0, None), (4, 9, 11, 17),
                                   (20, 10, 0, 30)])
def test_fz_block_equals_cor_matrix(block):
    data = _cont_table()
    data[:, 12] = -data[:, 13]                   # r = -1 exactly, clamped
    C = U.cor_matrix(data, device="cpu").numpy()
    xc, ssd = U._fz_center(data, device="cpu")
    s, t, ys, ylen = block
    r = U.fz_block(xc, ssd, s, t, ys, ylen).numpy()
    want = C[s:s + t, ys:ys + (ylen or 30)]
    np.testing.assert_array_equal(np.isnan(r), np.isnan(want))
    np.testing.assert_allclose(r, want, rtol=RTOL_COR, atol=ATOL_COR)
    assert np.nanmax(np.abs(r)) <= 1.0


# ---------------------------------------------------------------------------
# the conditioning engine
# ---------------------------------------------------------------------------

def _tests(p, B=700, seed=1):
    """tests/test_condtests.py's batch: B > 512, k from 0 to 3."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, p, B).astype(np.int32)
    Y = (X + 1 + rng.integers(0, p - 1, B).astype(np.int32)) % p
    Zs = rng.integers(0, p, (B, 3)).astype(np.int32)
    kv = rng.integers(0, 4, B).astype(np.int32)
    return X, Y, Zs, kv


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("onfly", [False, True])
def test_fz_tests_match_jax(onfly, chunked, monkeypatch):
    data = _cont_table()
    monkeypatch.setattr(jct, "FORCE_COR_ONFLY", onfly)
    monkeypatch.setattr(tct, "FORCE_COR_ONFLY", onfly)
    if chunked:
        # 64-row chunks over 300 rows and 256 tests a device call
        monkeypatch.setattr(tct, "MCOR_ROW_BUDGET", 1)
        monkeypatch.setattr(tct.CondTestEngine, "FZ_CHUNK", 256)
    jeng = jct.CondTestEngine(data, "fz", 3, hps=5, n_obs_min=20)
    teng = tct.CondTestEngine(data, "fz", 3, hps=5, n_obs_min=20,
                              device="cpu")
    assert (teng.cor_device, teng.cor_onfly) == (jeng.cor_device,
                                                 jeng.cor_onfly) == (True,
                                                                     onfly)
    X, Y, Zs, kv = _tests(data.shape[1])
    before = tct.N_TESTS_DISPATCHED
    handle = teng.fz_tests_begin(X, Y, Zs, kv)
    assert tct.N_TESTS_DISPATCHED == before + 700
    assert len(handle[1]) == (3 if chunked else 1)
    got = teng.fz_tests_finish(handle)
    want = jeng.fz_tests_raw(X, Y, Zs, kv)
    np.testing.assert_array_equal(np.isnan(got[0]), np.isnan(want[0]))
    assert np.isnan(got[0]).any() and not np.isnan(got[0]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-8, atol=1e-300)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert (got[1] < 0.01).any()


def test_fz_tests_run_level_n_obs_min():
    data = _cont_table(60, 12)
    teng = tct.CondTestEngine(data, "fz", 3, n_obs_min=61, device="cpu")
    jeng = jct.CondTestEngine(data, "fz", 3, n_obs_min=61)
    X, Y, Zs, kv = _tests(12, B=40)
    got = teng.fz_tests_raw(X, Y, Zs, kv)
    for g, w in zip(got, jeng.fz_tests_raw(X, Y, Zs, kv)):
        np.testing.assert_array_equal(g, w)
    assert not got[3].any() and (got[1] == 1.0).all()


@pytest.mark.parametrize("chunked", [False, True])
def test_plain_masked_cor_matches_jax(chunked, monkeypatch):
    """fz's fast windows past the wall: correlations over all rows."""
    data = _cont_table()
    rng = np.random.default_rng(9)
    pairs, vls = [], []
    for _ in range(300):
        v = rng.choice(data.shape[1], 2 + rng.integers(1, 13), replace=False)
        pairs.append((int(v[0]), int(v[1])))
        vls.append([int(x) for x in v])
    if chunked:
        monkeypatch.setattr(jct, "MCOR_ROW_BUDGET", 1)
        monkeypatch.setattr(tct, "MCOR_ROW_BUDGET", 1)
        jct._masked_cor_kernel._clear_cache()
    try:
        jeng = jct.CondTestEngine(data, "fz", 3, n_obs_min=20)
        want = jeng.masked_cor_finish(jeng.masked_cor_begin(pairs, vls,
                                                            plain=True))
    finally:
        jct._masked_cor_kernel._clear_cache()
    teng = tct.CondTestEngine(data, "fz", 3, n_obs_min=20, device="cpu")
    got = teng.masked_cor_finish(teng.masked_cor_begin(pairs, vls,
                                                       plain=True))
    assert len(got) == len(want) == 300
    for (C, n), (wC, wn), vl in zip(got, want, vls):
        assert n == wn == data.shape[0]
        k = len(vl)
        np.testing.assert_allclose(C[:k, :k], wC[:k, :k], rtol=1e-10,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------

def _both(data, **kw):
    kw = dict(sensitive=True, heterogeneous=False, verbose=False,
              time_limit=0.0, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = fw.learn_network(data, **kw)
        got = fwt.learn_network(data, device="cpu", **kw)
    return fw.graph(want), fwt.graph(got)


def _same_network(got, want):
    ge, we = list(got.edges()), list(want.edges())
    assert len(we) > 20
    assert [(u, v) for u, v, _ in ge] == [(u, v) for u, v, _ in we]
    np.testing.assert_allclose([w for *_, w in ge], [w for *_, w in we],
                               rtol=0, atol=ATOL_PCOR)


@pytest.mark.parametrize("max_k,parallel", [
    (0, "single"), (3, "single"), (3, "single_il"),
])
def test_fz_network_equals_jax(table, max_k, parallel):
    want, got = _both(table, max_k=max_k, parallel_mode=parallel)
    _same_network(got, want)


def test_fz_multi_il_within_tolerance_model(table):
    want, got = _both(table, max_k=3, parallel_mode="multi_il")
    assert got.n_edges() > 20
    assert compare_graph_results(want, got, approx_nbr_diff=4,
                                 approx_weight_meandiff=0.1)


@pytest.mark.parametrize("parallel,track,route", [
    ("single_il", True, "gather"),       # fz_tests through the on-fly Gram
    ("single_il", False, "windows"),     # masked_cor(plain=True) windows
    ("multi_il", False, "windows"),
])
def test_fz_onfly_network_equals_materialized(table, parallel, track, route,
                                              monkeypatch):
    calls = {"gather": 0, "windows": 0}

    def spy(name, fn):
        def wrapped(*args):
            # the engine passes plain positionally: args[6]
            if name == "gather" or args[6]:
                calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tct, "_fz_cond_onfly_kernel",
                        spy("gather", tct._fz_cond_onfly_kernel))
    monkeypatch.setattr(tct, "_masked_cor_kernel",
                        spy("windows", tct._masked_cor_kernel))
    kw = dict(sensitive=True, max_k=3, parallel_mode=parallel,
              track_rejections=track, verbose=False, time_limit=0.0,
              device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mat = fwt.graph(fwt.learn_network(table, **kw))
        assert calls == {"gather": 0, "windows": 0}
        monkeypatch.setattr(tct, "FORCE_COR_ONFLY", True)
        onf = fwt.graph(fwt.learn_network(table, **kw))
    assert calls[route] > 0
    assert calls["gather" if route == "windows" else "windows"] == 0
    _same_network(onf, mat)
