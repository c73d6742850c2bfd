"""The main path at a cut of bench.py's headline cell, on the CPU.

bench.py's p = 98,304 mi_nz LGL (``lgl_scale_bench``, bench.py:337-362)
runs on ``_synth_table(2048, 98304, 8, seed=0)``: groups of 8, so each
variable has 7 true neighbours and some targets carry 9 or 10 candidates,
whose full-target windows (1,074 and 1,665 tests) only the turbo digest's
budget admits (``hiton.TURBO_MXU_BUDGET`` = 1,700 against
``TURBO_TEST_BUDGET`` = 700).  The same construction at n = 512 and p = 200
reaches that band too.  The port's ``LGL`` on the CPU, with the window
digest on the device route (``FORCE_DEV_DIGEST`` True) and on the host
(False), equals the JAX package's LGL under x64 on the same table and
settings (bench.py:274-284): the same edges in the same order, weights
within rtol 1e-9 and the same conditional tests dispatched, also with the
turbo digest's plane budget and the histogram's chunk cut so that the
windows of the band go one or two a chunk (at p = 98,304 the first round
digests ~91,000 windows of m = 7 in ~1,200 chunks).  A spy on
``turbo_tests_begin`` shows that a window of the band ran.
"""

import numpy as np
import pytest

from flashweave_tpu.learning.lgl import LGL as jLGL
from flashweave_tpu.ops import condtests as jct
from flashweave_tpu_torch.learning import hiton as thiton
from flashweave_tpu_torch.learning.lgl import LGL as tLGL
from flashweave_tpu_torch.ops import condtests as tct

# bench.py's lgl_run settings
KW = dict(test_name="mi_nz", max_k=3, parallel="multi_il", time_limit=0.0,
          convergence_threshold=0.0, verbose=False, n_obs_min=20)


def _synth_table(n, p, group, seed=1):
    """bench.py's ``_synth_table`` (bench.py:265-271)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 3, (n, p // group)).astype(np.int8)
    data = np.repeat(base, group, axis=1)
    flip = rng.random((n, p)) < 0.35
    data = np.where(flip, rng.integers(0, 3, (n, p), dtype=np.int8), data)
    return data.astype(np.float32)


@pytest.fixture(scope="module")
def cut():
    """The table and the JAX package's network: (data, sorted edges, tests
    dispatched)."""
    data = _synth_table(512, 200, 8, seed=0)
    before = jct.N_TESTS_DISPATCHED
    edges = sorted(jLGL(data, **KW).graph.edges())
    return data, edges, jct.N_TESTS_DISPATCHED - before


@pytest.mark.parametrize("small_chunks", [False, True])
@pytest.mark.parametrize("dev_digest", [False, True])
def test_scale_cut_equals_jax(cut, dev_digest, small_chunks, monkeypatch):
    data, want, want_tests = cut
    monkeypatch.setattr(tct, "FORCE_DEV_DIGEST", dev_digest)
    if small_chunks:
        # the chunked routes of the headline cell at this size: one or two
        # turbo windows a plane chunk (a window of m = 7 holds 3.5 MB of
        # planes at n = 512), 64 tests a histogram chunk
        monkeypatch.setattr(tct, "TURBO_PLANE_BYTES", 8 << 20)
        monkeypatch.setattr(tct, "CHUNK_ELEMS", 64 * data.shape[0])
    windows, digests = {}, []
    turbo = tct.CondTestEngine.turbo_tests_begin
    digest = tct.CondTestEngine.mi_tests_begin_digest

    def turbo_spy(self, m, Ts, cands, alpha, tpl):
        windows.setdefault(tpl["B"], 0)
        windows[tpl["B"]] += len(Ts)
        return turbo(self, m, Ts, cands, alpha, tpl)

    def digest_spy(self, *args):
        digests.append(len(args[0]))
        return digest(self, *args)

    monkeypatch.setattr(tct.CondTestEngine, "turbo_tests_begin", turbo_spy)
    monkeypatch.setattr(tct.CondTestEngine, "mi_tests_begin_digest",
                        digest_spy)
    stats = {}
    monkeypatch.setattr(thiton, "WINDOW_STATS", stats)
    before = tct.N_TESTS_DISPATCHED
    got = sorted(tLGL(data, device="cpu", **KW).graph.edges())
    assert tct.N_TESTS_DISPATCHED - before == want_tests
    assert len(want) > 300
    assert [e[:2] for e in got] == [e[:2] for e in want]
    np.testing.assert_allclose([e[2] for e in got], [e[2] for e in want],
                               rtol=1e-9, atol=0)
    # every turbo window went through the turbo digest, and one of them
    # holds more tests than the histogram windows' budget admits
    assert stats["turbo_mxu"] == stats["turbo"] == sum(windows.values())
    band = {b: w for b, w in windows.items()
            if thiton.TURBO_TEST_BUDGET < b <= thiton.TURBO_MXU_BUDGET}
    assert band, windows
    assert bool(digests) == dev_digest
