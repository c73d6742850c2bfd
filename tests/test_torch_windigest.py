"""K6 (the mi / mi_nz window digest) and K7 (the turbo window digest) of the
PyTorch port on the CPU, where their wrappers run the plain versions:

- K6's wrapper equals ``condtests._mi_digest`` bit for bit at the
  headline's max_df and at a 2-level table's, and a hand case holds its edge cases: a
  segment with no significant test, ties of log p (the last index wins),
  df = 0, 1 and max_df, a failed power check, x past ``ERFC_DIRECT_MAX``.
- K7's wrapper equals the turbo route before it (each chunk's
  ``_turbo_pair_stats``, every test's pair gathered, ``_mi_digest``) bit
  for bit, and its plain version equals the JAX package's
  ``_turbo_digest_fn`` under x64 (``test_torch_midigest.py``'s
  tolerances) for m = 2..10 and max_k = 1..3 in nz modes 0, 1 and 2 (a
  Latin square of the three).
- The distinct (candidate, subset) pairs and each test's index into them
  reproduce the template's ``jb * U + ub`` for every m <= 10 and
  max_k <= 3.
- Wherever the turbo windows run, K5's gate, which K7 shares, holds, and
  every template the turbo route takes fits K7's shared memory; K7's passes
  and layout at the headline's windows.
No launch is counted: CPU tensors never launch a kernel.
"""

import math

import numpy as np
import pytest
import torch
from scipy.special import log_ndtr
from scipy.stats import chi2

from flashweave_tpu.ops import condtests as jct
from flashweave_tpu_torch.learning import hiton
from flashweave_tpu_torch.learning.hiton import _turbo_mxu_template
from flashweave_tpu_torch.ops import condtests as tct
from flashweave_tpu_torch.ops import kernels as K
from flashweave_tpu_torch.ops import statfuns as tsf
from flashweave_tpu_torch.utils.misc import get_levels, get_max_vals

ALPHA = 0.01
LA = math.log(ALPHA)


def _no_launches():
    return all(v == 0 for v in K.launch_counts().values())


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def _random_tests(B, max_df, seed):
    """B tests as K5 returns them: stat signed, n_obs up to 300, df in
    0..max_df, a tenth failing the power check (stat and df 0 there)."""
    rng = np.random.default_rng(seed)
    n_obs = rng.integers(0, 300, B).astype(np.float64)
    stat = rng.exponential(0.3, B) * rng.choice([-1.0, 1.0], B)
    df = rng.integers(0, max_df + 1, B)
    suff = rng.random(B) > 0.1
    stat[~suff], df[~suff] = 0.0, 0
    return (torch.from_numpy(stat), torch.from_numpy(df),
            torch.from_numpy(n_obs), torch.from_numpy(suff))


@pytest.mark.parametrize("max_df", [108, 8])
def test_window_digest_wrapper_equals_mi_digest(max_df):
    """At the headline's max_df ((3-1)^2 27, nz-uniform) and a 2-level
    table's at max_k 3 (8)."""
    K.reset_launch_counts()
    rng = np.random.default_rng(2)
    counts = rng.integers(1, 12, 200)
    B = int(counts.sum())
    tests = _random_tests(B, max_df, seed=1)
    counts_t = torch.from_numpy(counts)
    want = tct._mi_digest(*tests, counts_t, B, LA, max_df)
    got = K.mi_window_digest(*tests, counts_t, B, LA, max_df)
    assert got.dtype == torch.float64 and got.shape == (3, 200)
    assert torch.equal(got, want)
    out = got.numpy()
    assert (out[0] == -1).any() and (out[0] == 0).any() and (out[0] > 0).any()
    assert _no_launches()


def test_window_digest_hand_cases():
    """Six segments: (0) no significant test, one failing the power check;
    (1) a tie of the largest log p at local 1 and 3 (equal tests), an exit
    at local 2; (2) df = 1 past ERFC_DIRECT_MAX and df = max_df; (3) df = 0
    and a df past max_df (log p 0), then a significant test; (4) one
    significant test at df = 2; (5) a strong test failing the power check
    (log p 0: the exit)."""
    max_df = 12
    rows = [
        # stat, df, n_obs, suff
        (0.001, 4, 100.0, True), (0.0, 0, 100.0, False),
        (0.2, 3, 100.0, True), (0.1, 4, 100.0, True), (0.001, 2, 100.0, True),
        (0.1, 4, 100.0, True),
        (-8.0, 1, 100.0, True), (3.0, max_df, 200.0, True),
        (0.5, 0, 100.0, True), (0.5, max_df + 2, 100.0, True),
        (0.3, 5, 100.0, True),
        (0.05, 2, 300.0, True),
        (0.0, 0, 300.0, False),
    ]
    stat, df, n_obs, suff = (torch.tensor(c, dtype=dt) for c, dt in zip(
        zip(*rows), (torch.float64, torch.int64, torch.float64, torch.bool)))
    counts = torch.tensor([2, 4, 2, 3, 1, 1])
    out = K.mi_window_digest(stat, df, n_obs, suff, counts, len(rows), LA,
                             max_df).numpy()

    def logp(i):
        s, d, n, _ = rows[i]
        return math.log(chi2.sf(2 * abs(s) * n, d))

    # the closed form against scipy where scipy's p is a normal number
    for i in (0, 2, 3, 4, 7, 10, 11):
        got = tsf.mi_logpval_smalldf(stat[i:i + 1], df[i:i + 1],
                                     n_obs[i:i + 1], max_df).item()
        assert got == pytest.approx(logp(i), rel=1e-9)
    # x = 800 (sqrt 28.3 > 26): the asymptotic series; log erfc(sqrt x)
    # from scipy's log of the normal tail
    far = tsf.mi_logpval_smalldf(stat[6:7], df[6:7], n_obs[6:7],
                                 max_df).item()
    assert far == pytest.approx(math.log(2) + log_ndtr(-math.sqrt(1600.0)),
                                rel=1e-12)
    np.testing.assert_array_equal(out[0], [0, 2, -1, 0, -1, 0])
    # wstat: the first test without a significant one; the tie's last test
    np.testing.assert_array_equal(out[1], [0.001, 0.1, 3.0, 0.3, 0.05, 0.0])
    assert out[2][0] == 0.0 and out[2][5] == 0.0
    tie = tsf.mi_logpval_smalldf(stat[3:4], df[3:4], n_obs[3:4],
                                 max_df).item()
    assert out[2][1] == math.exp(tie)
    assert out[2][2] == pytest.approx(chi2.sf(2 * 3.0 * 200, max_df),
                                      rel=1e-9)
    assert out[2][3] == pytest.approx(chi2.sf(2 * 0.3 * 100, 5), rel=1e-9)
    assert out[2][4] == pytest.approx(chi2.sf(2 * 0.05 * 300, 2), rel=1e-9)
    assert _no_launches()


# ---------------------------------------------------------------------------
# the template's distinct pairs
# ---------------------------------------------------------------------------

DISTINCT_MAXK3 = [2, 9, 28, 70, 150, 287, 504, 828, 1290]


@pytest.mark.parametrize("max_k", [1, 2, 3])
def test_distinct_pairs_reproduce_template(max_k):
    for m in range(2, 11):
        tpl = _turbo_mxu_template(m, max_k)
        U = tpl["U"]
        pj, pu, tpair = tct._turbo_pairs(tpl["jb"], tpl["ub"], U)
        pid = pj * U + pu
        assert (np.diff(pid) > 0).all()            # distinct, ordered
        np.testing.assert_array_equal(
            pid[tpair], tpl["jb"].astype(np.int64) * U + tpl["ub"])
        assert len(pj) <= tpl["B"]
        if max_k == 3:
            assert len(pj) == DISTINCT_MAXK3[m - 2]
        c = K.turbo_consts(m, pj, pu, tpair, tpl["memb"], tpl["klen"],
                           tpl["counts"], "cpu")
        assert (c.U, c.B, c.NC, c.NP) == (U, tpl["B"], tpl["NC"], len(pj))
        assert c.max_klen == min(max_k, m - 1)
        assert c.memb.dtype == torch.int32 and c.memb.shape == (U, max_k)
        np.testing.assert_array_equal(c.test_pairs().numpy(),
                                      tpl["jb"].astype(np.int64) * U
                                      + tpl["ub"])
        np.testing.assert_array_equal(c.offs.numpy(), tpl["offs"])
        np.testing.assert_array_equal(c.counts.numpy(), tpl["counts"])


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def _table(nz_mode, n=240, p=36, seed=4):
    """Chains of three noisy copies (``test_torch_midigest.py``'s layout):
    nz mode 2 on 3-level columns, 1 with every third chain binary, 0 on
    3-level columns (plain mi)."""
    rng = np.random.default_rng(seed)
    cols = []
    for j in range(p // 3):
        L = 2 if (nz_mode == 1 and j % 3 == 0) else 3
        c = rng.integers(0, L, n)
        for _ in range(3):
            cols.append(c)
            c = np.where(rng.random(n) < 0.3, rng.integers(0, L, n), c)
    return np.stack(cols, axis=1).astype(np.float64)


def _windows(p, W, m, seed):
    """W windows: a target 3j, its chain's other two columns among the m
    candidates (for m >= 2), the rest at random."""
    rng = np.random.default_rng(seed)
    Ts, cands = [], []
    for _ in range(W):
        j = 3 * int(rng.integers(0, p // 3))
        rest = np.setdiff1d(np.arange(p), [j, j + 1, j + 2])
        c = [j + 1, j + 2][:m] + list(rng.choice(rest, max(m - 2, 0),
                                                 replace=False))
        Ts.append(j)
        cands.append(rng.permutation(c))
    return np.asarray(Ts, np.int64), np.asarray(cands, np.int64)


def _engine(nz_mode, max_k):
    data = _table(nz_mode)
    test = "mi" if nz_mode == 0 else "mi_nz"
    levels, maxv = get_levels(data), get_max_vals(data)
    eng = tct.CondTestEngine(data, test, max_k, levels=levels, max_vals=maxv,
                             hps=5, device="cpu")
    assert eng.turbo_mxu and eng.k5 and eng.nz_mode == nz_mode
    return data, levels, maxv, eng


def _old_route(eng, m, Ts, cands, tpl):
    """The turbo route before K7: the chunks of ``_turbo_pair_stats``, each
    template test's pair through ``jb * U + ub``, ``_mi_digest``."""
    st = eng.tables[0]
    W, B, U = len(Ts), tpl["B"], tpl["U"]
    memb = torch.from_numpy(tpl["memb"].astype(np.int64))
    klen = torch.from_numpy(tpl["klen"].astype(np.int64))
    pairid = torch.from_numpy(tpl["jb"].astype(np.int64) * U + tpl["ub"])
    Wc = max(1, tct.TURBO_PLANE_BYTES // (4 * eng.n * U * eng.S))
    Ts_d, C_d = torch.from_numpy(Ts), torch.from_numpy(cands)
    parts = [tct._turbo_pair_stats(
        st.data, st.levels, st.max_vals, Ts_d[s:s + Wc], C_d[s:s + Wc], memb,
        klen, 5.0, eng.L, eng.S, eng.nz, eng.nzu) for s in range(0, W, Wc)]
    stat, df, n_obs, suff = (torch.cat(t)[:, pairid].reshape(-1)
                             for t in zip(*parts))
    counts = torch.from_numpy(tpl["counts"]).repeat(W)
    return tct._mi_digest(stat, df, n_obs, suff, counts, W * B, LA,
                          (eng.L - 1) ** 2 * eng.S_hist).reshape(3, W,
                                                                 tpl["NC"])


# (m, max_k, nz mode): every m once, each (max_k, mode) pair once
K7_CASES = [(2, 3, 0), (3, 2, 1), (4, 1, 2), (5, 3, 1), (6, 2, 2),
            (7, 1, 0), (8, 3, 2), (9, 2, 0), (10, 1, 1)]


def _weakest(pairs, tpair, counts, W, max_df):
    """Per (window, slot): whether a test is significant, and |mi| n_obs and
    df of the weakest significant test, from the distinct pairs' results
    (each test's through ``tpair``)."""
    stat, df, n_obs, suff = (t[:, tpair].reshape(-1) for t in pairs)
    logp = torch.where(suff, tsf.mi_logpval_smalldf(stat, df, n_obs,
                                                    max_df), 0.0).numpy()
    stat, df, n_obs = stat.numpy(), df.numpy(), n_obs.numpy()
    has, x, d, o = [], [], [], 0
    for k in np.tile(counts, W):
        sl = logp[o:o + k]
        sig = sl < LA
        if sig.any():
            ls = np.where(sig, sl, -np.inf)
            w = o + np.flatnonzero(ls == ls.max())[-1]
            has.append(True)
            x.append(abs(stat[w]) * n_obs[w])
            d.append(df[w])
        else:
            has.append(False)
            x.append(0.0)
            d.append(0)
        o += k
    return np.array(has), np.array(x), np.array(d)


@pytest.mark.parametrize("m,max_k,nz_mode", K7_CASES)
def test_turbo_digest(m, max_k, nz_mode):
    """K7's wrapper (its plain version here) equals the route before it bit
    for bit, and the JAX package's turbo digest with the tolerances of
    ``test_torch_midigest.py``."""
    K.reset_launch_counts()
    data, levels, maxv, eng = _engine(nz_mode, max_k)
    tpl = _turbo_mxu_template(m, max_k)
    W = 6
    Ts, cands = _windows(data.shape[1], W, m, seed=m)
    got = eng._turbo_windows(m, Ts, cands, ALPHA, tpl)
    assert got.shape == (3, W, tpl["NC"]) and got.dtype == torch.float64
    assert torch.equal(got, _old_route(eng, m, Ts, cands, tpl))
    assert _no_launches()

    jeng = jct.CondTestEngine(data, "mi" if nz_mode == 0 else "mi_nz", max_k,
                              levels=levels, max_vals=maxv, hps=5)
    jex, jws, jwp = jeng.turbo_tests_finish(
        jeng.turbo_tests_begin(m, Ts, cands, ALPHA, tpl))
    ex, ws, wp = (a.numpy() for a in got)
    np.testing.assert_array_equal(ex, jex)
    const = eng._turbo_dev_cache[(m, torch.device("cpu"))]
    max_df = (eng.L - 1) ** 2 * eng.S_hist
    again, pairs = K.mi_turbo_digest(
        eng.tables[0], torch.from_numpy(Ts), torch.from_numpy(cands), const,
        5.0, max_k, nz_mode, LA, max_df, return_pairs=True)
    assert torch.equal(again, got)
    assert all(t.shape == (W, const.NP) for t in pairs)
    has, x, d = _weakest(pairs, const.tpair.long(), tpl["counts"], W, max_df)
    has = has.reshape(W, -1)
    assert has.any()
    np.testing.assert_allclose(ws[has], jws[has], rtol=1e-12, atol=0)
    exact = has.reshape(-1) & (np.sqrt(x) < 7.9)
    far = has.reshape(-1) & ~exact
    np.testing.assert_allclose(wp.reshape(-1)[exact], jwp.reshape(-1)[exact],
                               rtol=1e-9)
    np.testing.assert_allclose(wp.reshape(-1)[far],
                               chi2.sf(2 * x[far], d[far]), rtol=1e-9,
                               atol=1e-300)
    np.testing.assert_array_equal(wp[~has], 0.0)


# ---------------------------------------------------------------------------
# the gate and the staging
# ---------------------------------------------------------------------------

def test_k7_gate_follows_shapes(monkeypatch):
    """The turbo windows run only where K5's gate holds (K7 shares it, and
    the engine asserts it), decided from shapes: across level counts and
    max_k wherever the digests' cell bound lets the turbo route on."""
    three = _table(2, n=200, p=12)
    binary = (_table(0, n=200, p=12) > 0).astype(np.float64)

    def route(data, test="mi_nz", max_k=3):
        e = tct.CondTestEngine(data, test, max_k, hps=5, device="cpu")
        return e.turbo_mxu, e.k5

    assert route(three) == (True, True)
    assert route(binary, "mi") == (True, True)
    # compacted strata (n // hps + 1 = 21 < 27): neither turbo nor K5
    assert route(three[:100]) == (False, False)
    # 12 levels: past the digests' gate (K5 too at max_k 3)
    twelve = np.random.default_rng(0).integers(0, 12, (200, 12)).astype(float)
    assert route(twelve, "mi") == (False, False)
    assert route(three, max_k=0)[0] is False
    assert route(three, "fz")[0] is False
    monkeypatch.setattr(tct, "FORCE_TURBO_MXU", False)
    assert route(three) == (False, True)
    monkeypatch.setattr(tct, "FORCE_TURBO_MXU", None)
    rng = np.random.default_rng(1)
    on = 0
    for L in range(2, 7):
        table = rng.integers(0, L, (700, 8)).astype(float)
        for max_k in (1, 2, 3, 7):
            for test in ("mi", "mi_nz"):
                turbo, k5 = route(table, test, max_k)
                assert k5 or not turbo
                on += turbo
    assert on >= 6
    # every template the turbo route takes fits K7's shared memory: each
    # (L, max_k, nz) of the digests' gate, each m whose template holds at
    # most TURBO_MXU_BUDGET tests
    gate = [(L, max_k, nz) for L in range(2, 13) for max_k in range(1, 8)
            for nz in (0, 1, 2)
            if (L - 1) ** 2 * L ** max_k <= tct.DIGEST_CELLS
            and (nz != 2 or L == 3)]
    assert (2, 7, 0) in gate and (3, 3, 2) in gate and (5, 1, 1) in gate
    assert max(L for L, _, _ in gate) == 5
    widest = 0
    for L, max_k, nz in gate:
        m = 2
        while _turbo_mxu_template(m, max_k)["B"] <= hiton.TURBO_MXU_BUDGET:
            tpl = _turbo_mxu_template(m, max_k)
            pj, pu, _ = tct._turbo_pairs(tpl["jb"], tpl["ub"], tpl["U"])
            plan = K.k7_plan(m, L, nz, tpl["klen"], pj, pu)
            bytes_ = K.k7_smem_bytes(
                len(pj), plan.warps, K.k7_hist_ints(L, min(max_k, m - 1), nz),
                m, plan.mtw, plan.cg_ints, plan.zrows)
            assert bytes_ <= K.SMEM_BLOCK_BYTES, (L, max_k, nz, m, bytes_)
            widest = max(widest, bytes_)
            m += 1
    assert widest > 100_000            # L = 2, max_k = 7, m = 8


def test_k7_shared_memory_layout():
    """csrc/mi_turbo_digest.cu's layout at the headline's windows (m = 7,
    max_k = 3, nz-uniform, L = 3): U = 63 subsets of 3, 9 and 27 strata
    (1,155 columns), 287 distinct pairs, A of 28 rows in 2 M-tiles, so 8
    warps of 2 x 8 tiles; three passes of 64, 62 and 21 N-tiles (at most
    512 columns a pass: subsets 0-38, 39-56, 57-62); 287 pairs of 16 + 4 +
    1 bytes, 8 histogram slices of (2 + 1)^2 27 ints, 8 warps' B columns
    (8 N-tiles of 8 columns, 8 bytes each), 39 subset descriptors of 8
    ints, 8 column references and flags, then the slab of 32 rows of 520
    ints, larger than the ring (3 x 8 rows) and two buffers of A (32 rows)
    and of 39 subsets' codes and a zero row, 144 bytes a row."""
    tpl = _turbo_mxu_template(7, 3)
    pj, pu, _ = tct._turbo_pairs(tpl["jb"], tpl["ub"], tpl["U"])
    plan = K.k7_plan(7, 3, 2, tpl["klen"], pj, pu)
    assert tpl["U"] == 63 and plan.colo[-1] == 1155
    assert plan.passes.tolist() == [[0, 7, 0, 39], [0, 7, 39, 57],
                                    [0, 7, 57, 63]]
    assert [plan.cols(u0, u1) for _, _, u0, u1 in plan.passes] == [
        (0, 512), (504, 1000), (992, 1160)]
    assert plan.rows(0, 7) == (0, 32)
    # each pass lists the pairs of its subsets, every pair once
    assert plan.poffs.tolist()[0] == 0 and plan.poffs[-1] == len(pj) == 287
    assert sorted(plan.ppairs.tolist()) == list(range(287))
    for i, (_, _, u0, u1) in enumerate(plan.passes.tolist()):
        got = pu[plan.ppairs[plan.poffs[i]:plan.poffs[i + 1]]]
        assert ((got >= u0) & (got < u1)).all()
    assert (plan.mtw, plan.warps, plan.zrows) == (2, 8, 39)
    assert K.k7_slab_stride(64) == 520 and K.k7_slab_stride(21) == 200
    assert plan.cg_ints == 32 * 520
    hist = K.k7_hist_ints(3, 3, 2)
    assert hist == 243
    head = -(-(21 * 287) // 16) * 16
    head = -(-(head + 4 * 8 * 243) // 16) * 16 + 8 * 8 * 64 + 32 * 39
    head = -(-(head + 5 * 8) // 16) * 16
    streams = (3 * 8 + 2 * 32 + 2 * 40) * 144
    assert streams < 4 * 32 * 520
    assert K.k7_smem_bytes(287, 8, hist, 7, 2, 32 * 520, 39) == (
        head + 4 * 32 * 520) == 85_760
    # two blocks an SM
    assert 2 * 85_760 <= 227 * 1024
    # m = 2: one pass, one N-tile, one warp
    small = K.k7_plan(2, 3, 2, _turbo_mxu_template(2, 3)["klen"], [0, 1],
                      [1, 0])
    assert small.passes.tolist() == [[0, 2, 0, 2]]
    assert (small.mtw, small.warps, small.cg_ints) == (1, 1, 16 * 40)
    # past K7's shapes: codes past 127, or Lr > 7
    with pytest.raises(ValueError):
        K.k7_plan(3, 12, 0, [2], [0], [0])
    with pytest.raises(ValueError):
        K.k7_plan(3, 8, 0, [1], [0], [0])
