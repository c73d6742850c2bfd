"""Why the 12-level slice keeps 4 edges a group of 5, settled on the CPU.

``chip_smoke.py`` phase 6 learns mi at 12 levels on a grouped 2048 x 10,000
table (``synth_table(..., levels=12)``) and keeps 8,000 edges, 4 a group of
5, where the 3-level slice keeps about 10.  The cause is power.  A
conditional test of X and Y given k >= 1 variables has 12 x 12 x levels_z
cells (levels_z: its occupied strata, 12 for one 12-level Z), so n / cells
<= 2048 / 1728 = 1.19, not above hps = 5: no conditional test has power.
HITON's ``issig`` needs power (``learning/hiton.py:46-48``), so every
candidate that needs a conditioning set is dropped, and each target keeps
only its first candidate (the most significant univariate one, accepted
without a test).  The network is the OR of those picks.

- At phase 6's n and settings (n = 2,048, multi_il), on a 100-variable cut:
  every conditional test dispatched has k >= 1 and ``suff_power`` False,
  and the network's edges are exactly the pairs (T, first candidate of T).
- On a smaller cut (n = 768, which still gives every univariate 12 x 12
  table power, p = 20, single_il): the port's network equals the JAX
  package's (edges, weights rtol 1e-9, tests dispatched).  The JAX
  package's CPU route builds an (n, B, L * S) float64 one-hot for a batch
  of B tests (``flashweave_tpu/ops/contingency.py``, off the TPU), which at
  12 levels and multi_il's batches asks for 83 GB and more, so this
  comparison runs one target at a time.
"""

import numpy as np

from flashweave_tpu.learning.lgl import LGL as jLGL
from flashweave_tpu.ops import condtests as jct
from flashweave_tpu_torch.learning.lgl import LGL as tLGL
from flashweave_tpu_torch.ops import condtests as tct
from flashweave_tpu_torch.ops.univariate import pw_univar_neighbors

KW = dict(test_name="mi", max_k=3, time_limit=0.0, convergence_threshold=0.0,
          verbose=False, n_obs_min=20)


def synth_table(n, p, group, seed=1, levels=3):
    """``chip_smoke.py``'s ``synth_table``: the grouped table of bench.py's
    LGL input at ``levels`` levels."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, levels, (n, p // group)).astype(np.int8)
    data = np.repeat(base, group, axis=1)
    flip = rng.random((n, p)) < 0.35
    data = np.where(flip, rng.integers(0, levels, (n, p), dtype=np.int8), data)
    return data.astype(np.float32)


def test_twelve_levels_no_conditional_test_has_power(monkeypatch):
    data = synth_table(2048, 100, 5, levels=12)
    E = tct.CondTestEngine
    kvecs, suffs = [], []
    begin, finish = E.mi_tests_begin, E.mi_tests_finish_lazy

    def begin_spy(self, X, Y, Zs, kvec):
        kvecs.append(np.array(kvec))
        return begin(self, X, Y, Zs, kvec)

    def finish_spy(self, handle):
        out = finish(self, handle)
        suffs.append(out[3].copy())
        return out

    monkeypatch.setattr(E, "mi_tests_begin", begin_spy)
    monkeypatch.setattr(E, "mi_tests_finish_lazy", finish_spy)
    before = tct.N_TESTS_DISPATCHED
    g = tLGL(data, parallel="multi_il", device="cpu", **KW).graph
    kv, suff = np.concatenate(kvecs), np.concatenate(suffs)
    assert len(kv) == len(suff) == tct.N_TESTS_DISPATCHED - before > 1000
    assert kv.min() >= 1
    assert not suff.any()           # no conditional test has power

    # the network: each target's first univariate candidate, OR-merged
    univar = pw_univar_neighbors(data, "mi", alpha=0.01, hps=5,
                                 n_obs_min=20, device="cpu")
    picks = {tuple(sorted((T, next(iter(nb))))) for T, nb in univar.items()
             if nb}
    edges = {(u, v) for u, v, _ in g.edges()}
    assert len(picks) == 80         # 4 a group of 5, as phase 6's 8,000
    assert edges == picks


def test_twelve_levels_equal_jax():
    data = synth_table(768, 20, 5, levels=12)
    kw = dict(KW, parallel="single_il")
    b0 = jct.N_TESTS_DISPATCHED
    want = sorted(jLGL(data, **kw).graph.edges())
    want_tests = jct.N_TESTS_DISPATCHED - b0
    b1 = tct.N_TESTS_DISPATCHED
    got = sorted(tLGL(data, device="cpu", **kw).graph.edges())
    assert tct.N_TESTS_DISPATCHED - b1 == want_tests > 500
    assert len(want) == 15
    assert [e[:2] for e in got] == [e[:2] for e in want]
    np.testing.assert_allclose([e[2] for e in got], [e[2] for e in want],
                               rtol=1e-9, atol=0)
