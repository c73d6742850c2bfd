"""K5's plain version and route on the CPU (the kernel itself runs only on
the card, ``chip_smoke.py`` phase 2e).

- ``kernels.mi_cond_stats_ref`` against the JAX package's
  ``_mi_cond_kernel`` on the same seeded tables and descriptors: the three
  modes (nz-uniform, generic nz with binary variables, plain mi), L = 2, 3
  and 4, max_k 0..3, n even and odd, tests whose rows are all masked and
  tests of k = 0.  df, n_obs and suff exact, stat within rtol 1e-12 (float64
  on both sides; only the order of the sums differs).
- The engine's K5 route (one packed int32 descriptor array a call) against
  its route before K5 (four int64 uploads a chunk of ``_mi_cond_kernel``):
  bit-equal on the CPU, per test and through the window digest.
- The gate (``CondTestEngine.k5``): which tables take K5's route and which
  stay on the plain chunks; the wrapper on a CPU tensor runs the plain
  version and counts no launch.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flashweave_tpu.ops import condtests as jct
from flashweave_tpu.utils.misc import get_levels, get_max_vals
from flashweave_tpu_torch.ops import condtests as tct
from flashweave_tpu_torch.ops import kernels as K
from flashweave_tpu_torch.state import from_numpy_state

HPS = 5.0


def _table(kind, n, p, seed, L=3):
    """A seeded (n, p) table: "uniform" (every variable 3-level, zeros
    common), "mixed" (2- and 3-level variables, zeros common) or "plain"
    (L levels).  Columns 1, 5, 9, ... copy their left neighbour in 70% of
    the rows, so some tests are significant.  Columns 2 and 3 are nonzero
    only in the first and the second half of the rows: a test of X = 2 and
    Y = 3 keeps no row under nz."""
    rng = np.random.default_rng(seed)
    if kind == "plain":
        data = rng.integers(0, L, (n, p))
    else:
        data = rng.integers(0, 3, (n, p))
        data[rng.random((n, p)) < 0.4] = 0
        if kind == "mixed":
            data[:, ::4] = np.minimum(data[:, ::4], 1)
    data[:, 1::4] = np.where(rng.random((n, len(range(1, p, 4)))) < 0.7,
                             data[:, 0::4][:, :len(range(1, p, 4))],
                             data[:, 1::4])
    if kind != "plain":
        h = n // 2
        data[h:, 2] = 0
        data[:h, 3] = 0
        data[:2, 2] = data[-2:, 3] = [1, 2]
    if kind == "uniform":
        data[:3, 4:] = np.arange(3)[:, None]       # every variable 3-level
        data[h:h + 3, :2] = np.arange(3)[:, None]
    return data


def _descriptors(p, B, max_k, seed):
    """(X, Y, Zs, kvec) int32 of B tests with k in 0..max_k; the first tests
    are X = 2, Y = 3 (no row kept under nz) at every k."""
    rng = np.random.default_rng(seed)
    X = np.empty(B, np.int32)
    Y = np.empty(B, np.int32)
    Zs = np.zeros((B, max_k), np.int32)
    kvec = rng.integers(0, max_k + 1, B).astype(np.int32)
    for i in range(B):
        v = rng.choice(p, 2 + max_k, replace=False)
        if i <= max_k:
            v = np.concatenate([[2, 3], rng.choice(np.arange(4, p), max_k,
                                                   replace=False)])
            kvec[i] = i
        X[i], Y[i] = v[0], v[1]
        Zs[i, :kvec[i]] = v[2:2 + kvec[i]]
    return X, Y, Zs, kvec


def _desc(X, Y, Zs, kvec):
    return torch.from_numpy(np.concatenate(
        [X[:, None], Y[:, None], kvec[:, None], Zs], axis=1).astype(np.int32))


REF_CASES = [
    # test, table kind, L, max_k, n
    ("mi_nz", "uniform", 3, 0, 300),
    ("mi_nz", "uniform", 3, 1, 301),
    ("mi_nz", "uniform", 3, 2, 300),
    ("mi_nz", "uniform", 3, 3, 301),
    ("mi_nz", "mixed", 3, 0, 301),
    ("mi_nz", "mixed", 3, 1, 300),
    ("mi_nz", "mixed", 3, 2, 301),
    ("mi_nz", "mixed", 3, 3, 300),
    ("mi", "plain", 2, 0, 300),
    ("mi", "plain", 2, 3, 301),
    ("mi", "plain", 3, 1, 300),
    ("mi", "plain", 3, 3, 301),
    ("mi", "plain", 4, 2, 301),
    ("mi", "plain", 4, 3, 400),
]


@pytest.mark.parametrize("test,kind,L,max_k,n", REF_CASES)
def test_plain_version_matches_jax(test, kind, L, max_k, n):
    p, B = 24, 160
    data = _table(kind, n, p, seed=n + L + max_k, L=L)
    levels, maxv = get_levels(data), get_max_vals(data)
    st = from_numpy_state(data, levels, maxv, "cpu")
    nz = test == "mi_nz"
    nzu = bool(nz and st.L == 3 and (maxv > 1).all())
    assert st.L == L and nzu == (kind == "uniform")
    mode = 2 if nzu else int(nz)
    S = L ** max_k
    assert K.k5_fits(L, max_k, mode) and S <= n // HPS + 1
    X, Y, Zs, kvec = _descriptors(p, B, max_k, seed=max_k + n)
    got = [t.numpy() for t in K.mi_cond_stats(st, _desc(X, Y, Zs, kvec), HPS,
                                              max_k, mode)]
    j = jnp.asarray
    want = [np.asarray(t) for t in jct._mi_cond_kernel(
        j(data.astype(np.float64)), j(levels), j(maxv), j(X), j(Y), j(Zs),
        j(kvec), HPS, B, max_k, L, S, nz, nzu)]
    np.testing.assert_array_equal(got[1], want[1])           # df
    np.testing.assert_array_equal(got[2], want[2])           # n_obs
    np.testing.assert_array_equal(got[3], want[3])           # suff
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=0)
    assert got[0].dtype == got[2].dtype == np.float64
    assert got[1].dtype == np.int64 and got[3].dtype == bool
    # every kind of test is there: k = 0, a nonzero stat, and under nz the
    # tests of X, Y = 2, 3, which keep no row (and pass the power check:
    # n / 0 cells)
    assert (kvec == 0).any() and got[3].any() and (got[0] != 0).any()
    if nz:
        none = np.isin(X, (2, 3)) & np.isin(Y, (2, 3))
        assert none[:max_k + 1].all() and (got[2][none] == 0).all()
        assert got[3][none].all() and (got[2][~none] > 0).all()


ROUTE_CASES = [("mi_nz", "uniform", 2), ("mi_nz", "mixed", 3),
               ("mi", "plain", 3)]


@pytest.mark.parametrize("test,kind,max_k", ROUTE_CASES)
def test_packed_route_equals_chunked_route(test, kind, max_k, monkeypatch):
    data = _table(kind, 250, 30, seed=11)
    eng = tct.CondTestEngine(data, test, max_k, hps=5, device="cpu")
    assert eng.k5 and eng.nz_mode == {"uniform": 2, "mixed": 1,
                                      "plain": 0}[kind]
    X, Y, Zs, kvec = _descriptors(30, 300, max_k, seed=3)
    counts = np.array([100, 1, 150, 49], np.int64)
    # several chunks of the plain version, as the headline's 4,096 tests a
    # chunk of 2,048 rows
    monkeypatch.setattr(tct, "CHUNK_ELEMS", 250 * 64)
    uploads = []
    upload = eng._upload
    monkeypatch.setattr(eng, "_upload",
                        lambda *a, **kw: uploads.append(1) or upload(*a, **kw))
    k5 = eng.mi_tests_begin(X, Y, Zs, kvec)
    k5_digest = eng.mi_tests_finish_digest(
        eng.mi_tests_begin_digest(X, Y, Zs, kvec, counts, 0.01))
    assert len(k5) == 1 and len(uploads) == 1      # the digest's counts
    eng.k5 = False
    chunked = eng.mi_tests_begin(X, Y, Zs, kvec)
    chunked_digest = eng.mi_tests_finish_digest(
        eng.mi_tests_begin_digest(X, Y, Zs, kvec, counts, 0.01))
    assert len(chunked) == 5 and len(uploads) == 1 + 2 * 5 * 4 + 1
    for a, b in zip(eng.mi_tests_finish_lazy(k5),
                    eng.mi_tests_finish_lazy(chunked)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(k5_digest, chunked_digest):
        np.testing.assert_array_equal(a, b)
    assert (k5_digest[0] >= 0).any()


GATE_CASES = [
    # test, table kind, levels, n, max_k, K5's route
    ("mi_nz", "uniform", 3, 300, 3, True),     # the headline's nzu tables
    ("mi_nz", "mixed", 3, 300, 3, True),
    ("mi", "plain", 2, 300, 3, True),          # 2-level mi (phase 3g)
    ("mi", "plain", 3, 300, 3, True),
    ("mi", "plain", 4, 400, 3, True),
    ("mi", "plain", 5, 700, 3, True),          # 3,125 cells
    ("mi", "plain", 6, 1200, 3, False),        # past K5_TEST_BYTES
    ("mi_nz", "mixed", 3, 100, 3, False),      # compacted strata
    ("mi", "plain", 12, 300, 3, False),        # 12 levels: compacted
    ("mi", "plain", 12, 300, 1, True),
    ("mi", "plain", 200, 300, 0, False),       # an int16 table
]


@pytest.mark.parametrize("test,kind,L,n,max_k,route", GATE_CASES)
def test_k5_gate(test, kind, L, n, max_k, route):
    data = _table(kind, n, 8, seed=5, L=L)
    eng = tct.CondTestEngine(data, test, max_k, hps=5, device="cpu")
    assert eng.L == L and eng.k5 == route
    assert eng.state.data.dtype == (torch.int16 if L > 128 else torch.int8)
    assert (eng.S == eng.S_hist) == (n != 100 and (L < 12 or max_k < 3))
    X, Y, Zs, kvec = _descriptors(8, 40, max_k, seed=1)
    K.reset_launch_counts()
    stat, pval, df, suff = eng.mi_tests_raw(X, Y, Zs, kvec)
    assert np.isfinite(stat).all() and len(stat) == len(X)
    assert K.launch_counts()["mi_cond_stats"] == 0
    if route:
        # the wrapper on CPU tensors is the plain version, launch-free
        desc = _desc(X, Y, Zs, kvec)
        got = K.mi_cond_stats(eng.state, desc, 5, max_k, eng.nz_mode)
        want = K.mi_cond_stats_ref(eng.state, desc, 5, max_k, eng.nz_mode)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        np.testing.assert_array_equal(got[0].numpy(), stat)
        assert K.launch_counts()["mi_cond_stats"] == 0


def test_k5_fits_budget():
    """K5's budget, (Lr + 1)^2 L^max_k int32 a test within 32 KiB."""
    assert K.K5_TEST_BYTES == 32 << 10
    assert K.k5_fits(3, 3, 2) and 4 * 3 ** 2 * 27 == 972      # headline
    assert K.k5_fits(5, 3, 0) and 4 * 6 ** 2 * 125 == 18_000
    assert not K.k5_fits(6, 3, 0) and 4 * 7 ** 2 * 216 > 32 << 10
    assert K.k5_fits(2, 9, 0) and not K.k5_fits(2, 10, 0)
