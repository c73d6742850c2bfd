"""fz's pcor DP on the device, on the CPU.

- The gather route (``CondTestEngine.fz_tests_begin`` / ``fz_tests_finish``)
  runs ``statfuns.pcor_dp_tensor`` on each chunk's submatrices on the
  engine's device and copies back one statistic a test: the statistics
  equal numpy's ``pcor_dp`` over the same submatrices bit for bit, and the
  p-values equal scipy's over them, for conditioning sets of k = 0, 1, 2
  and 3 alone and mixed, on both conditioning routes (the (p, p) matrix and
  on the fly) and in several chunks (``FZ_CHUNK``).  The handle holds (B,)
  statistics, not (B, 25) submatrices.
- The continuous window digest never sees a test with k = 0: every
  conditioning set the scheduler ships to ``cont_tests_begin`` (fz_nz, fz
  on the fly) comes from ``hiton._combo_template``, whose subsets have
  sizes max_k..1.  So the digest's clip of the correlations to [-1, 1],
  which the host digest lacks, cannot turn a NaN p into 0 (ROADMAP queue
  3): for k >= 1 the DP's rounding absorbs it.
"""

import numpy as np
import pytest
import torch

from flashweave_tpu_torch.learning.lgl import LGL
from flashweave_tpu_torch.ops import condtests as tct
from flashweave_tpu_torch.ops import statfuns as tsf


def _table(n=200, p=30, seed=4):
    rng = np.random.default_rng(seed)
    data = np.log1p(rng.poisson(3.0, (n, p)) + rng.random((n, p)))
    data[:, 1::3] = 0.8 * data[:, 0::3] + 0.2 * data[:, 1::3]
    data[:, 2::3] = 0.5 * data[:, 1::3] + 0.5 * data[:, 2::3]
    return data


@pytest.mark.parametrize("onfly", [False, True])
@pytest.mark.parametrize("k", [0, 1, 2, 3, "mixed"])
def test_fz_gather_dp_equals_host_dp(k, onfly, monkeypatch):
    monkeypatch.setattr(tct, "FORCE_COR_ONFLY", onfly)
    monkeypatch.setattr(tct.CondTestEngine, "FZ_CHUNK", 64)
    data = _table()
    p = data.shape[1]
    eng = tct.CondTestEngine(data, "fz", 3, hps=5, n_obs_min=10,
                             device="cpu")
    assert eng.cor_device and eng.cor_onfly == onfly
    rng = np.random.default_rng(7)
    B = 150
    X = rng.integers(0, p, B)
    Y = (X + 1 + rng.integers(0, p - 2, B)) % p
    Zs = rng.integers(0, p, (B, 3))
    kv = (rng.integers(0, 4, B) if k == "mixed" else np.full(B, k))
    handle = eng.fz_tests_begin(X, Y, Zs, kv)
    assert [t.shape for t in handle[1]] == [(64,), (64,), (22,)]
    stat, pval, df, suff = eng.fz_tests_finish(handle)
    # the same submatrices on the host, then numpy's DP and scipy's p
    args = [torch.from_numpy(np.asarray(a, np.int64)) for a in (X, Y, Zs, kv)]
    if onfly:
        sub = tct._fz_cond_onfly_kernel(eng.xc, eng.ssd, *args, 3)
    else:
        sub = tct._fz_cond_kernel(eng.cor_j, *args, 3)
    want = tsf.pcor_dp(sub.numpy(), kv, 3, xp=np)
    np.testing.assert_array_equal(stat, want)
    np.testing.assert_array_equal(pval, np.asarray(tsf.fz_pval(want, 200, 0)))
    assert (df == 0).all() and suff.all()
    if k == 0:
        np.testing.assert_array_equal(stat, sub.numpy()[:, 0, 1])


@pytest.mark.parametrize("test_name", ["fz_nz", "fz"])
def test_cont_digest_never_sees_k0(test_name, monkeypatch):
    monkeypatch.setattr(tct, "FORCE_CONT_DEV", True)
    monkeypatch.setattr(tct, "FORCE_COR_ONFLY", True)
    data = _table(n=300, p=36, seed=2)
    if test_name == "fz_nz":
        data[np.random.default_rng(3).random(data.shape) < 0.2] = 0.0
    seen = []
    begin = tct.CondTestEngine.cont_tests_begin

    def spy(self, var_lists, POS, KV, counts, alpha):
        seen.append(np.asarray(KV))
        return begin(self, var_lists, POS, KV, counts, alpha)

    monkeypatch.setattr(tct.CondTestEngine, "cont_tests_begin", spy)
    for parallel in ("multi_il", "single_il"):
        res = LGL(data, test_name=test_name, max_k=3, parallel=parallel,
                  time_limit=0.0, convergence_threshold=0.0, n_obs_min=20,
                  verbose=False, device="cpu")
        assert res.graph.n_edges() > 0
    kv = np.concatenate(seen)
    assert len(seen) > 2 and kv.size > 100
    assert kv.min() >= 1 and kv.max() >= 2
