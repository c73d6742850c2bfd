"""The PyTorch port's conditional-test engine against the JAX package's, on
the same random (X, Y, Zs, kvec) batches with k from 0 to 3.  Integers
(df, suff) must be equal and stat within rtol 1e-12 (float64 on both sides;
only summation order differs).

fz_nz: masked correlation submatrices on the same random (T, candidate)
pairs and variable lists, with and without row chunks: n_obs exact, C
within rtol 1e-10 / atol 1e-12; the partial-correlation tests fed the same
C are bit-equal (the same numpy pcor DP)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flashweave_tpu.ops import condtests as jct
from flashweave_tpu.ops import contingency as jcont
from flashweave_tpu.utils.misc import get_levels, get_max_vals
from flashweave_tpu_torch.ops import condtests as tct
from flashweave_tpu_torch.ops import contingency as tcont


def _table(kind, n, p, seed):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        data = rng.integers(0, 2, (n, p))
    else:
        data = rng.integers(0, 3, (n, p))
        data[rng.random((n, p)) < 0.4] = 0
        if kind == "uniform":
            data[:3] = np.arange(3)[:, None]       # every variable 3-level
        else:
            data[:, ::3] = np.minimum(data[:, ::3], 1)   # mixed 2/3 levels
    # correlated blocks so some tests are significant
    data[:, 1::4] = np.where(rng.random((n, len(range(1, p, 4)))) < 0.7,
                             data[:, 0::4][:, : len(range(1, p, 4))],
                             data[:, 1::4])
    return data.astype(np.float64)


def _batch(p, B, max_k, seed):
    rng = np.random.default_rng(seed)
    X = np.empty(B, np.int32)
    Y = np.empty(B, np.int32)
    Zs = np.zeros((B, max_k), np.int32)
    kvec = rng.integers(0, max_k + 1, B).astype(np.int32)
    for i in range(B):
        v = rng.choice(p, 2 + max_k, replace=False)
        X[i], Y[i] = v[0], v[1]
        Zs[i, : kvec[i]] = v[2: 2 + kvec[i]]
    return X, Y, Zs, kvec


CASES = [
    # test_name, table kind, n, p
    ("mi", "mixed", 300, 24),
    ("mi", "binary", 300, 24),
    ("mi_nz", "mixed", 300, 24),
    ("mi_nz", "uniform", 300, 24),
    ("mi_nz", "mixed", 100, 24),      # n // hps + 1 = 21 < 27: compaction
]


@pytest.mark.parametrize("test_name,kind,n,p", CASES)
def test_engine_matches_jax(test_name, kind, n, p):
    data = _table(kind, n, p, seed=n + p)
    levels, maxv = get_levels(data), get_max_vals(data)
    max_k = 3
    jeng = jct.CondTestEngine(data, test_name, max_k, levels=levels,
                              max_vals=maxv, hps=5)
    teng = tct.CondTestEngine(data, test_name, max_k, levels=levels,
                              max_vals=maxv, hps=5, device="cpu")
    assert (teng.S, teng.S_hist, teng.nzu) == (jeng.S, jeng.S_hist, jeng.nzu)
    if n == 100:
        assert teng.S_hist < teng.S
    if kind == "uniform":
        assert teng.nzu
    assert (not teng.dev_digest and teng.turbo_mxu == jeng.turbo_mxu
            and teng.mesh is None)
    X, Y, Zs, kvec = _batch(p, 300, max_k, seed=n)
    want = jeng.mi_tests_raw(X, Y, Zs, kvec)
    got = teng.mi_tests_raw(X, Y, Zs, kvec)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=0)   # stat
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9, atol=0)    # pval
    np.testing.assert_array_equal(got[2], want[2])                    # df
    np.testing.assert_array_equal(got[3], want[3])                    # suff
    assert got[3].any() and (got[1] < 0.01).any()
    lazy_j = jeng.mi_tests_finish_lazy(jeng.mi_tests_begin(X, Y, Zs, kvec))
    lazy_t = teng.mi_tests_finish_lazy(teng.mi_tests_begin(X, Y, Zs, kvec))
    np.testing.assert_array_equal(lazy_t[2], lazy_j[2])               # n_obs


def test_chunked_begin_equals_single_chunk(monkeypatch):
    data = _table("mixed", 200, 20, seed=1)
    eng = tct.CondTestEngine(data, "mi_nz", 3, hps=5, device="cpu")
    assert eng.k5
    X, Y, Zs, kvec = _batch(20, 250, 3, seed=2)
    whole = eng.mi_tests_raw(X, Y, Zs, kvec)
    before = tct.N_TESTS_DISPATCHED
    monkeypatch.setattr(tct, "CHUNK_ELEMS", 200 * 64)     # 64 tests a chunk
    calls = []
    kernel = tct._mi_cond_kernel
    monkeypatch.setattr(tct, "_mi_cond_kernel",
                        lambda *a: calls.append(len(a[3])) or kernel(*a))
    # K5's route: one handle a call; on the CPU its plain version runs the
    # chunks
    handle = eng.mi_tests_begin(X, Y, Zs, kvec)
    assert len(handle) == 1 and calls == [64, 64, 64, 58]
    for a, b in zip(eng.mi_tests_finish(handle), whole):
        np.testing.assert_array_equal(a, b)
    # the plain route (compacted strata, int16 tables): a handle a chunk
    eng.k5 = False
    handle = eng.mi_tests_begin(X, Y, Zs, kvec)
    assert len(handle) == 4
    assert tct.N_TESTS_DISPATCHED == before + 500
    for a, b in zip(eng.mi_tests_finish(handle), whole):
        np.testing.assert_array_equal(a, b)
    res = eng.mi_tests(X[:3], Y[:3], Zs[:3], kvec[:3])
    assert [r.df for r in res] == list(whole[2][:3])


@pytest.mark.parametrize("reduced,S", [(False, 27), (True, 27), (False, 10)])
def test_cond_ctab_batch_matches_jax(reduced, S):
    kind = "uniform" if reduced else "mixed"
    data = _table(kind, 150, 16, seed=4).astype(np.int64)
    X, Y, Zs, kvec = _batch(16, 64, 3, seed=5)
    x, y = data[:, X], data[:, Y]
    mask = (x != 0) & (y != 0) if reduced else np.ones(x.shape, bool)
    want, wocc = jcont.cond_ctab_batch(
        jnp.asarray(data, jnp.float64), jnp.asarray(X), jnp.asarray(Y),
        jnp.asarray(Zs), jnp.asarray(kvec), jnp.asarray(mask), 64, 3, 3, S,
        reduced=reduced)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    got, occ = tcont.cond_ctab_batch(
        torch.from_numpy(data.astype(np.int8)), t(X), t(Y), t(Zs), t(kvec),
        torch.from_numpy(mask), 3, 3, S, reduced=reduced)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if S < 27:
        np.testing.assert_array_equal(occ.numpy(), np.asarray(wocc))
    else:
        assert occ is None and wocc is None


def test_engine_flags_for_continuous_modes(monkeypatch):
    """fz keeps its correlations on the device (``cor_device``): the (p, p)
    matrix below ``FZ_COR_BYTES``, the centered table past it; fz_nz
    neither.  Both take the scheduler's float64 host digest (``cont_dev``
    off)."""
    data = _cont_table(50, 8, seed=0)
    eng = tct.CondTestEngine(data, "fz_nz", 3, device="cpu")
    assert eng.nz and not eng.discrete and eng.data.dtype == torch.float64
    assert not (eng.cont_dev or eng.cor_device or eng.cor_onfly
                or eng.dev_digest or eng.turbo_mxu)
    fz = tct.CondTestEngine(data, "fz", 3, device="cpu")
    assert fz.cor_device and not fz.cor_onfly and not fz.nz
    assert not (fz.cont_dev or fz.dev_digest or fz.turbo_mxu)
    assert fz.cor_j.shape == (8, 8) and fz.cor_j.dtype == torch.float64
    # the wall: 8 p^2 bytes against FZ_COR_BYTES, whatever the device
    assert 8 * 65_536 ** 2 > tct.FZ_COR_BYTES >= 8 * 10_000 ** 2
    monkeypatch.setattr(tct, "FZ_COR_BYTES", 8 * 8 ** 2 - 1)
    onf = tct.CondTestEngine(data, "fz", 3, device="cpu")
    assert onf.cor_device and onf.cor_onfly and not onf.cont_dev
    assert onf.xc.shape == (50, 8) and onf.ssd.shape == (8,)
    onf.release()
    assert onf.xc is None and onf.ssd is None and onf.cor_j is None
    # no device correlations with a host matrix, without the recursion or
    # at max_k 0
    for kw in (dict(cor_mat=np.eye(8)), dict(recursive_pcor=False)):
        assert not tct.CondTestEngine(data, "fz", 3, device="cpu",
                                      **kw).cor_device
    assert not tct.CondTestEngine(data, "fz", 0, device="cpu").cor_device


def test_slice_mask_matches_jax():
    rng = np.random.default_rng(6)
    ctab = rng.integers(0, 9, (50, 3, 3, 4)).astype(np.float64)
    ox = rng.integers(0, 2, 50)
    oy = rng.integers(0, 2, 50)
    want = jcont.slice_mask(jnp.asarray(ctab), jnp.asarray(ox), jnp.asarray(oy))
    got = tcont.slice_mask(torch.from_numpy(ctab), torch.from_numpy(ox),
                           torch.from_numpy(oy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# fz_nz: masked correlations
# ---------------------------------------------------------------------------

def _cont_table(n=300, p=30, seed=8):
    rng = np.random.default_rng(seed)
    data = np.log1p(rng.poisson(3.0, (n, p)) + rng.random((n, p)))
    data[:, 1::3] = 0.5 * data[:, 0::3] + 0.5 * data[:, 1::3]
    data[rng.random((n, p)) < 0.5] = 0.0
    return data


def _pairs(p, B, seed):
    """(T, candidate) pairs with variable lists [T, cand, Z_total...] of
    1 to 12 conditioning variables (bucketed widths 8 and 16)."""
    rng = np.random.default_rng(seed)
    pairs, vls = [], []
    for _ in range(B):
        v = rng.choice(p, 2 + rng.integers(1, 13), replace=False)
        pairs.append((int(v[0]), int(v[1])))
        vls.append([int(x) for x in v])
    return pairs, vls


@pytest.mark.parametrize("chunked", [False, True])
def test_masked_cor_matches_jax(chunked, monkeypatch):
    data = _cont_table()
    pairs, vls = _pairs(data.shape[1], 300, seed=9)
    if chunked:
        # 64-row chunks (the floor) over 300 rows, a non-multiple
        monkeypatch.setattr(jct, "MCOR_ROW_BUDGET", 1)
        monkeypatch.setattr(tct, "MCOR_ROW_BUDGET", 1)
        jct._masked_cor_kernel._clear_cache()
    try:
        jeng = jct.CondTestEngine(data, "fz_nz", 3, n_obs_min=20)
        want = jeng.masked_cor(pairs, vls)
        want_raw = jeng.masked_cor_finish_raw(jeng.masked_cor_begin(pairs, vls))
    finally:
        jct._masked_cor_kernel._clear_cache()
    teng = tct.CondTestEngine(data, "fz_nz", 3, n_obs_min=20, device="cpu")
    got = teng.masked_cor(pairs, vls)
    got_raw = teng.masked_cor_finish_raw(teng.masked_cor_begin(pairs, vls))
    assert len(got) == len(want) == 300
    for (C, n), (wC, wn), vl in zip(got, want, vls):
        assert n == wn == teng.nz_pair_count(vl[0], vl[1])
        assert C.shape == wC.shape
        k = len(vl)
        np.testing.assert_allclose(C[:k, :k], wC[:k, :k], rtol=1e-10,
                                   atol=1e-12)
    np.testing.assert_array_equal(got_raw[1], want_raw[1])
    assert got_raw[0].shape == want_raw[0].shape == (300, 16, 16)
    for i, vl in enumerate(vls):
        k = len(vl)
        np.testing.assert_allclose(got_raw[0][i, :k, :k],
                                   want_raw[0][i, :k, :k], rtol=1e-10,
                                   atol=1e-12)


def test_fz_tests_from_cor_match_jax():
    """Partial-correlation tests fed the same masked correlation matrix:
    stats and p-values bit-equal, n_obs_min short-circuit included."""
    data = _cont_table()
    pairs, vls = _pairs(data.shape[1], 40, seed=10)
    teng = tct.CondTestEngine(data, "fz_nz", 3, n_obs_min=75, device="cpu")
    jeng = jct.CondTestEngine(data, "fz_nz", 3, n_obs_min=75)
    rng = np.random.default_rng(11)
    n_short = 0
    for C, n_obs in teng.masked_cor(pairs, vls):
        B = 50
        kvec = rng.integers(0, 4, B)
        pos_Zs = rng.integers(2, 14, (B, 3))
        pos_X, pos_Y = np.zeros(B, np.int64), np.ones(B, np.int64)
        got = teng.fz_tests_from_cor_raw(C, pos_X, pos_Y, pos_Zs, kvec, n_obs)
        want = jeng.fz_tests_from_cor_raw(C, pos_X, pos_Y, pos_Zs, kvec, n_obs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        n_short += n_obs < 75
        res = teng.fz_tests_from_cor(C, pos_X[:2], pos_Y[:2], pos_Zs[:2],
                                     kvec[:2], n_obs)
        assert [r.stat for r in res] == list(got[0][:2])
    assert 0 < n_short < 40


def test_fz_tests_iterative_matches_jax():
    data = _cont_table(200, 12)
    teng = tct.CondTestEngine(data, "fz_nz", 3, n_obs_min=20,
                              recursive_pcor=False, device="cpu")
    jeng = jct.CondTestEngine(data, "fz_nz", 3, n_obs_min=20,
                              recursive_pcor=False)
    Zs_list = [(), (2,), (2, 5), (2, 5, 7)]
    fields = lambda rs: [(r.stat, r.pval, r.df, r.suff_power) for r in rs]
    assert fields(teng.fz_tests_iterative(0, 1, Zs_list)) == fields(
        jeng.fz_tests_iterative(0, 1, Zs_list))
