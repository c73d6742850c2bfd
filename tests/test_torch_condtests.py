"""The PyTorch port's conditional-test engine against the JAX package's, on
the same random (X, Y, Zs, kvec) batches with k from 0 to 3.  Integers
(df, suff) must be equal and stat within rtol 1e-12 (float64 on both sides;
only summation order differs)."""

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
    assert not teng.dev_digest and not teng.turbo_mxu and teng.mesh is None
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
    X, Y, Zs, kvec = _batch(20, 250, 3, seed=2)
    whole = eng.mi_tests_raw(X, Y, Zs, kvec)
    before = tct.N_TESTS_DISPATCHED
    monkeypatch.setattr(tct, "CHUNK_ELEMS", 200 * 64)     # 64 tests a chunk
    handle = eng.mi_tests_begin(X, Y, Zs, kvec)
    assert len(handle) == 4
    assert tct.N_TESTS_DISPATCHED == before + 250
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


def test_engine_refuses_continuous_modes():
    data = _table("mixed", 50, 8, seed=0)
    for name, item in (("fz", "item 7"), ("fz_nz", "item 8")):
        with pytest.raises(NotImplementedError, match=item):
            tct.CondTestEngine(data, name, 3, device="cpu")


def test_slice_mask_matches_jax():
    rng = np.random.default_rng(6)
    ctab = rng.integers(0, 9, (50, 3, 3, 4)).astype(np.float64)
    ox = rng.integers(0, 2, 50)
    oy = rng.integers(0, 2, 50)
    want = jcont.slice_mask(jnp.asarray(ctab), jnp.asarray(ox), jnp.asarray(oy))
    got = tcont.slice_mask(torch.from_numpy(ctab), torch.from_numpy(ox),
                           torch.from_numpy(oy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
