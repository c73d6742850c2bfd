"""K1 (the fused univariate G-test) and K2 (the fz_nz masked correlation) in
the PyTorch port: their plain versions and ``level_marginals`` against the
JAX package.

Data is n=500, p=250, deliberately not a tile multiple.  The plain version
(what the CPU wrapper runs) is held against
- ``pair_ctab_block`` + ``mi_block_stats`` in x64: integers exact, stat
  rtol 1e-12 / atol 1e-15;
- the Pallas kernel ``mi_univar_stats_pallas`` in interpret mode: integers
  exact, stat atol 2e-6 / rtol 2e-5 (the Pallas epilogue is float32).
K2's plain version (``fz_nz_stats_ref``) is held against
- ``univariate.fz_nz_block`` in x64: N exact, NaN positions identical, r
  rtol 1e-10 / atol 1e-12;
- the Pallas kernel ``fz_nz_stats_pallas`` in interpret mode: N exact, r
  atol 2e-5 on the non-degenerate columns (its moments are float32, where a
  constant column need not give exactly zero variance).
The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against the plain versions there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flashweave_tpu.ops import pallas_kernels as pk
from flashweave_tpu.ops.contingency import pair_ctab_block
from flashweave_tpu.ops.univariate import mi_block_stats
from flashweave_tpu_torch.ops import kernels as K
from flashweave_tpu_torch.state import from_numpy_continuous, from_numpy_state

BLOCKS = [(0, 250, 0, 250), (25, 125, 100, 150)]   # full, ragged


def _data(L, nz, corr=False):
    rng = np.random.default_rng(10 * L + nz)
    n, p = 500, 250
    data = rng.integers(0, L, (n, p)).astype(np.float64)
    if corr:
        # every 4th variable mostly copies its left neighbour: significant pairs
        keep = rng.random((n, len(range(1, p, 4)))) < 0.7
        data[:, 1::4] = np.where(keep, data[:, 0:p - 1:4], data[:, 1::4])
    if nz == 2:
        # nz-uniform: every variable takes all three levels
        data[:3] = np.arange(3)[:, None]
    else:
        data[rng.random((n, p)) < 0.5] = 0.0
        # sparse variables fail the power checks; a constant one never tests
        sparse = data[:, 5::11]
        sparse[rng.random(sparse.shape) < 0.96] = 0.0
        data[:, 5::11] = sparse
        data[:, 3::50] = 0.0
        if L == 3:
            # mixed: some variables binary (max_val 1)
            data[:, ::7] = np.minimum(data[:, ::7], 1.0)
    levels = np.array([len(np.unique(data[:, j])) for j in range(p)], np.int32)
    maxv = data.max(axis=0).astype(np.int32)
    return data, levels, maxv


def _ref(data, levels, maxv, L, nz, block):
    s, tile, ys, ylen = block
    st = from_numpy_state(data, levels, maxv, "cpu")
    return K.mi_univar_stats_ref(st.dataT, st.marg, st.levels, st.max_vals,
                                 s, tile, L, ys, ylen, nz, 5.0, 20.0)


CASES = [(2, 0), (2, 1), (3, 0), (3, 1), (3, 2)]


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("L,nz", CASES)
def test_ref_matches_jax_block_stats(L, nz, block):
    data, levels, maxv = _data(L, nz)
    if nz == 2:
        assert (maxv > 1).all()
    got = _ref(data, levels, maxv, L, nz, block)
    s, tile, ys, ylen = block
    ctab = pair_ctab_block(jnp.asarray(data), s, tile, L, ys, ylen)
    want = mi_block_stats(ctab, levels[s:s + tile], levels[ys:ys + ylen],
                          maxv[s:s + tile], maxv[ys:ys + ylen], 5.0, 20.0,
                          nz, L)
    # an independent pair's stat is 0 on one side and ~1e-18 on the other,
    # from summation order: a purely relative tolerance fails on it
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-12, atol=1e-15)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    assert got[3].any() and (nz == 2 or not got[3].all())


@pytest.mark.parametrize("L,nz,block", [(3, 2, BLOCKS[1]), (2, 1, BLOCKS[0]),
                                        (3, 1, BLOCKS[1])])
def test_ref_matches_pallas_interpret(L, nz, block):
    data, levels, maxv = _data(L, nz)
    got = _ref(data, levels, maxv, L, nz, block)
    s, tile, ys, ylen = block
    dj = jnp.asarray(data)
    marg = pk.level_marginals(dj, L)
    want = pk.mi_univar_stats_pallas(
        dj.T, dj, marg, levels, maxv, s, tile, L, ys, ylen, nz, 5.0, 20.0,
        tx=128, ty=128, tn=256)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=2e-6, rtol=2e-5)


@pytest.mark.parametrize("L", [2, 3, 5])
def test_level_marginals_match_jax(L):
    rng = np.random.default_rng(L)
    data = rng.integers(0, L, (500, 250))
    got = K.level_marginals(torch.from_numpy(data.astype(np.int8)), L)
    want = pk.level_marginals(jnp.asarray(data), L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_wrapper_runs_plain_version_without_counting():
    data, levels, maxv = _data(3, 1)
    st = from_numpy_state(data, levels, maxv, "cpu")
    K.reset_launch_counts()
    got = K.mi_univar_stats(st.dataT, st.marg, st.levels, st.max_vals,
                            25, 125, 3, 100, 150, 1, 5.0, 20.0)
    want = _ref(data, levels, maxv, 3, 1, BLOCKS[1])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert K.launch_counts() == {"mi_univar_stats": 0, "fz_nz_stats": 0,
                                 "pair_ctab_planes": 0,
                                 "mi_univar_stats_planes": 0,
                                 "mi_cond_stats": 0,
                                 "mi_window_digest": 0,
                                 "mi_turbo_digest": 0,
                                 "univar_extract": 0}


def test_wrapper_rejects_other_devices():
    t = torch.empty((4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.mi_univar_stats(t, t, t, t, 0, 4, 3)


def test_chip_smoke_ptxas_report_names_each_kernel():
    """chip_smoke.py's phase-1 report: registers, stack and spills of each
    kernel (K1 by its level count) from nvcc's -Xptxas -v lines, with a
    device function's properties and other lines left out."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    k1 = "_ZN51_GLOBAL__N__f2_18_mi_univar_stats_cu_25b122mi_univar_stats_kernelILi3EEEvNS_5BlockE"
    count = ("_ZN58_GLOBAL__N__a1_25_mi_univar_stats_planes_cu_3c35"
             "mi_univar_stats_planes_count_kernelENS_5BlockEPi")
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{k1}' for 'sm_90a'",
        f"ptxas info    : Function properties for {k1}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 107 registers, used 1 barriers",
        "ptxas info    : Function properties for __internal_trig_reduction",
        "    40 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        f"ptxas info    : Compiling entry function '{count}' for 'sm_90a'",
        f"ptxas info    : Function properties for {count}",
        "    1024 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 480 bytes cmem[0]",
    ])
    assert smoke.ptxas_report(log) == {
        "mi_univar_stats<3>": dict(stack=0, spill_stores=0, spill_loads=0,
                                   registers=107),
        "mi_univar_stats_planes_count": dict(stack=1024, spill_stores=4,
                                             spill_loads=12, registers=128)}
    assert smoke.kernel_key("_ZN3fooEv") is None


def _smoke_module():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_sass_counts_and_fp64_ops():
    """chip_smoke.py's phase-1 SASS readings on cuobjdump-style text: the
    tensor-core and shared-atomic instructions of each kernel (K7 by its
    template argument), and a one-call probe's float64 operations on the
    path a typical argument takes (the longest, stepping over CALLs) and
    every instruction once, an FMA as two, beside its conditional branches;
    then the log p chain's count from them (each call as one gives the count
    before the SASS was read)."""
    smoke = _smoke_module()
    k7 = "_ZN12_GLOBAL__N_122mi_turbo_digest_kernelILi2EEEv4Args"
    sass = "\n".join([
        "\tcode for sm_90a",
        f"\t\tFunction : {k7}",
        "        /*0000*/                   IMMA.16832.U8.U8 R4, R8, R12, R4 ;",
        "        /*0010*/                   IMMA.16832.U8.U8 R4, R8, R14, R4 ;",
        "        /*0020*/                   EXIT ;",
        "\t\tFunction : fw_probe_exp_kernel",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0 */",
        "        /*0010*/                   DFMA R4, R2, R4, R6 ;",
        "        /*0020*/              @P0 BRA 0x50 ;",
        "        /*0030*/                   DADD R4, R4, R6 ;",
        "        /*0040*/                   BRA 0x70 ;",
        "        /*0050*/                   DMUL R4, R4, R4 ;",
        "        /*0060*/                   BRA 0x30 ;",
        "        /*0070*/                   F2I.F64.TRUNC R0, R4 ;",
        "        /*0080*/              @!P1 DSETP.GEU.AND P0, PT, R4, R6, PT ;",
        "        /*0090*/                   EXIT ;",
        "        /*00a0*/                   BRA 0xa0 ;",
        "\t\tFunction : _ZN3fooEv",
        "        /*0000*/                   ATOMS.ADD RZ, [R2], R3 ;",
    ])
    assert smoke.sass_counts(sass) == {
        "mi_turbo_digest<2>": {"DMMA": 0, "IMMA": 2, "HGMMA": 0, "ATOMS": 0}}
    part = sass.split("Function : ")[2]
    # the longest path: DFMA, DMUL, DADD, F2I (the predicated DSETP left
    # out); every instruction once: 6
    assert smoke.sass_fp64_ops(part) == {"ops": 5, "all": 6, "branches": 1}
    # a CALL is stepped over: its subroutine (a slow path) is not counted
    called = part.replace("DMUL R4, R4, R4 ;", "CALL.REL.NOINC 0xa0 ;")
    called = called.replace("BRA 0xa0 ;", "DFMA R4, R4, R4, R4 ;")
    assert smoke.sass_fp64_ops(called) == {"ops": 4, "all": 7,
                                           "branches": 1}
    assert smoke.sass_counts(sass.replace("IMMA.16832.U8.U8 R4, R8, R14",
                                          "ATOMS.ADD RZ, [R2], R3")) == {
        "mi_turbo_digest<2>": {"DMMA": 0, "IMMA": 1, "HGMMA": 0, "ATOMS": 1}}
    with pytest.raises(RuntimeError, match="probes"):
        smoke.logp_call_ops(sass)
    smoke.LOGP_OPS.update({c: 1 for c in smoke.FP64_CALLS})
    df = np.array([0, 1, 2, 4, 5, 7, 9, 200])
    suff = np.array([True] * 7 + [True])
    # a logsumexp step 5 (an exp, a log, three sums), a chain step 7: df 0
    # none; 1 x and log erfc(sqrt x) 4; 2 x and a log 2; 4 2 + a first step
    # (6) + a sum; 5, 7, 9 2 + the first term (2) + 1, 2, 3 chain steps +
    # log erfc (3) + a sum + a last step (5); past max_df none; two a test
    assert smoke.logp_fp64_ops(df, suff, 108) == (
        0 + 4 + 2 + 9 + 20 + 27 + 34 + 0 + 2 * 8)
    assert smoke.logp_fp64_ops(df, ~suff, 108) == 2 * 8
    smoke.LOGP_OPS.update(exp=20, log=30)
    # a step of the even chain: one exp and a log beside five operations
    assert (smoke.logp_fp64_ops([6], [True], 108)
            - smoke.logp_fp64_ops([4], [True], 108)) == 20 + 30 + 5


def test_chip_smoke_k6_lane_use():
    """chip_smoke.py's lane use of K6's layouts: one df everywhere keeps
    every lane busy in the sorted tiles, and segments of one test leave 31
    of a warp's 32 lanes idle a segment; two chain lengths alternating test
    by test are sorted apart (up to the tile's one mixed warp) but cost a
    warp a segment its dearer one."""
    smoke = _smoke_module()
    smoke.LOGP_OPS.update({c: 1 for c in smoke.FP64_CALLS})
    B = 4096
    df, suff = np.full(B, 3), np.ones(B, bool)
    got = smoke.k6_lane_use(df, suff, 108, np.ones(B, np.int64), 256)
    assert got == {"sorted": 1.0, "by_segment": 1 / 32}
    df[1::2] = 27
    ops = smoke.logp_test_ops(np.array([3, 27]), [True, True], 108)
    got = smoke.k6_lane_use(df, suff, 108, np.full(B // 64, 64), 256)
    assert got["sorted"] == pytest.approx(1.0)
    assert got["by_segment"] == pytest.approx(ops.sum() / (2 * ops.max()))


def test_chip_smoke_k8_lane_use():
    """chip_smoke.py's lane use of K8's layouts: the branches of a chain sum
    to its operations; one df everywhere keeps every lane busy both ways;
    two chain classes alternating pair by pair cost a warp of consecutive
    pairs both branches, and K8's sorted tiles one each (up to the tile's
    one mixed warp); a tile of one class runs in tile order, so its pairs
    without power leave lanes idle; pairs at X >= Y run nothing."""
    smoke = _smoke_module()
    smoke.LOGP_OPS.update(exp=31, log=45, log1p=46, erfc=114, sqrt=14)
    d = np.arange(131)
    np.testing.assert_array_equal(smoke.chain_branches(d).sum(axis=0),
                                  smoke.logp_test_ops(d, np.ones(131, bool),
                                                      200))
    t, q = 3, 8192
    df = torch.full((t, q), 3, dtype=torch.int32)
    suff = torch.ones((t, q), dtype=torch.bool)
    outs = (torch.zeros(t, q, dtype=torch.float64), df, df, suff)
    got = smoke.k8_lane_use(outs, 0, t, 4, 4096)
    assert got == {"in_order": 1.0, "built": 1.0, "mixed_tiles": 0.0}
    df[:, 1::2] = 4
    ops3, ops4 = smoke.logp_test_ops(np.array([3, 4]), [True, True], 4)
    branches = smoke.chain_branches(np.array([3, 4])).max(axis=1).sum()
    got = smoke.k8_lane_use(outs, 0, t, 4, 4096)
    assert got["in_order"] == pytest.approx((ops3 + ops4) / (2 * branches))
    assert got["built"] == pytest.approx(1.0, abs=2e-3)
    assert got["mixed_tiles"] == 1.0
    # the second tile of each row of one class, every other pair without
    # power: in tile order, half of its lanes idle
    suff[:, 4096::2] = False
    got = smoke.k8_lane_use(outs, 0, t, 4, 4096)
    useful = 2048 * ops3 + 4096 * ops4
    assert got["built"] == pytest.approx(
        useful / (32 * (64 * ops3 + 64 * ops4 + 128 * ops4)))
    assert got["mixed_tiles"] == 0.5
    # at X >= Y (the block on the diagonal) and without power: no chain;
    # every tile of one class, so in tile order both ways
    suff[:, ::2] = False
    got = smoke.k8_lane_use(outs, 0, 0, 4, 4096)
    assert got["built"] == got["in_order"] == pytest.approx(0.5, abs=2e-3)
    assert got["mixed_tiles"] == 0.0
    hist = smoke.k8_df_hist(outs, 0, 0)
    assert hist == {4: int((np.arange(q)[1::2] > np.arange(t)[:, None]).sum()),
                    "no power": int((np.arange(q)[::2]
                                     > np.arange(t)[:, None]).sum())}
    suff[:] = False
    assert smoke.k8_lane_use(outs, 0, 0, 4, 4096) == {
        "in_order": None, "built": None, "mixed_tiles": None}


@pytest.mark.parametrize("nz", [0, 2])
def test_chip_smoke_turbo_occupied_cells(nz):
    """The G-tests' work in K7's bound: the occupied cells of every
    distinct pair of each window, as chip_smoke.py counts them from the
    plain route's tables, equal a count of the distinct (x, y, z) of the
    rows in numpy; the G-tests' floor adds one operation a cell to the
    n + 1 logs of a c log c table."""
    smoke = _smoke_module()
    L, max_k, m, p, n = 3, 3, 4, 40, 300
    data = smoke.synth_table(n, p, 5, seed=3)
    st = from_numpy_state(data, None, None, "cpu")
    Ts, C = smoke.turbo_windows(p, 6, m, 5, seed=4)
    consts = smoke.turbo_template_consts(m, "cpu", max_k)
    want = 0
    for w in range(len(Ts)):
        for j, u in zip(consts.pj.tolist(), consts.pu.tolist()):
            x, y = data[:, Ts[w]], data[:, C[w, j]]
            z = sum(data[:, C[w, int(consts.memb[u, i])]].astype(np.int64)
                    * L ** i for i in range(int(consts.klen[u])))
            keep = (x != 0) & (y != 0) if nz == 2 else np.ones_like(x, bool)
            want += len(set(zip(x[keep], y[keep],
                                np.broadcast_to(z, keep.shape)[keep])))
    got = smoke.turbo_occupied_cells(st, torch.from_numpy(Ts),
                                     torch.from_numpy(C), consts, nz, max_k)
    assert got == want
    smoke.LOGP_OPS["log"] = 45
    assert smoke.gtest_fp64_ops(got, n) == got + (n + 1) * 45


def test_build_needs_nvcc(monkeypatch):
    """Without nvcc the build raises instead of falling back."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(K.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K._nvcc()


@pytest.mark.parametrize("test_name,L,nz", [("mi", 3, 0), ("mi_nz", 3, 1),
                                            ("mi_nz", 3, 2)])
def test_pw_univar_neighbors_matches_jax(test_name, L, nz):
    """The whole univariate pass (K1 blocks on the CPU path, host p-values,
    BH) gives the JAX package's neighbor dicts: same pairs in the same
    order, stats and adjusted p-values within rtol 1e-12."""
    from flashweave_tpu.ops.univariate import pw_univar_neighbors as jax_pw
    from flashweave_tpu_torch.ops.univariate import pw_univar_neighbors

    data, levels, maxv = _data(L, nz, corr=True)
    kw = dict(test_name=test_name, alpha=0.01, hps=5, n_obs_min=20,
              levels=levels, max_vals=maxv, tile=96)
    want, wres = jax_pw(data, return_result=True, **kw)
    got, gres = pw_univar_neighbors(data, return_result=True, device="cpu",
                                    **kw)
    assert sum(map(len, got.values())) > 50
    for v in range(data.shape[1]):
        assert list(got[v]) == list(want[v])
        np.testing.assert_allclose(np.array(list(got[v].values())),
                                   np.array(list(want[v].values())),
                                   rtol=1e-12, atol=0)
    np.testing.assert_array_equal(gres.suff_power, wres.suff_power)


# ---------------------------------------------------------------------------
# K2: fz_nz masked correlation
# ---------------------------------------------------------------------------

# degenerate columns, inside both blocks below
ZERO, CONST, ORIG, COPY, NORIG, NEG = 101, 103, 104, 105, 106, 107


def _cont_data(kind):
    """(500, 250) float64 table with ~60% zeros and the degenerate columns:
    all-zero, an exact copy and a negated copy; "dyadic" also holds a
    column constant over its nonzero rows.  "dyadic" values are multiples of
    1/64, so every moment sum is exact and any summation order gives the
    same r bit for bit (the constant column's 0/0 is then certain); "sparse"
    values are log1p of noisy counts."""
    rng = np.random.default_rng(20 if kind == "dyadic" else 21)
    n, p = 500, 250
    counts = rng.poisson(3.0, (n, p)) + rng.random((n, p))
    data = np.log1p(counts)
    data[:, 1::3] = 0.5 * data[:, 0:p - 1:3] + 0.5 * data[:, 1::3]
    data[rng.random((n, p)) < 0.6] = 0.0
    if kind == "dyadic":
        data = np.round(data * 64.0) / 64.0
        data[:, CONST] = np.where(data[:, CONST] != 0, 1.5, 0.0)
    data[:, ZERO] = 0.0
    data[:, COPY] = data[:, ORIG]
    data[:, NEG] = -data[:, NORIG]
    return data


def _cont_ref(data, block):
    s, tile, ys, ylen = block
    r, N = K.fz_nz_stats_ref(from_numpy_continuous(data, "cpu"), s, tile, ys,
                             ylen)
    assert r.dtype == torch.float64 and N.dtype == torch.int32
    return r.numpy(), N.numpy()


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("kind", ["sparse", "dyadic"])
def test_fz_nz_ref_matches_jax_block(kind, block):
    from flashweave_tpu.ops.univariate import fz_nz_block

    data = _cont_data(kind)
    r, N = _cont_ref(data, block)
    s, tile, ys, ylen = block
    wr, wN = fz_nz_block(jnp.asarray(data), s, tile, ys, ylen)
    wr, wN = np.asarray(wr), np.asarray(wN)
    np.testing.assert_array_equal(N, wN.astype(np.int32))
    np.testing.assert_array_equal(np.isnan(r), np.isnan(wr))
    np.testing.assert_allclose(r, wr, rtol=1e-10, atol=1e-12)
    # the degenerate columns give what the semantics say
    col = lambda v: v - ys
    row = lambda v: v - s
    assert (N[:, col(ZERO)] == 0).all() and (r[:, col(ZERO)] == 0).all()
    both = N[row(ORIG), col(COPY)] > 1
    assert both and r[row(ORIG), col(COPY)] == pytest.approx(1.0, abs=1e-12)
    assert r[row(NORIG), col(NEG)] == pytest.approx(-1.0, abs=1e-12)
    if kind == "dyadic":
        nan_rows = N[:, col(CONST)] > 0
        assert nan_rows.sum() > 50
        assert np.isnan(r[nan_rows, col(CONST)]).all()
    assert np.abs(r[~np.isnan(r)]).max() <= 1.0


@pytest.mark.parametrize("kind,block", [("dyadic", BLOCKS[0]),
                                        ("sparse", BLOCKS[1])])
def test_fz_nz_ref_matches_pallas_interpret(kind, block):
    data = _cont_data(kind)
    r, N = _cont_ref(data, block)
    s, tile, ys, ylen = block
    dj = jnp.asarray(data)
    wr, wN = pk.fz_nz_stats_pallas(dj[:, s:s + tile], dj[:, ys:ys + ylen],
                                   tx=128, ty=128, tn=256)
    wr, wN = np.asarray(wr, np.float64), np.asarray(wN)
    np.testing.assert_array_equal(N, wN.astype(np.int32))
    degenerate = np.array([ZERO, CONST, COPY, NEG])
    keep_x = ~np.isin(np.arange(s, s + tile), degenerate)
    keep_y = ~np.isin(np.arange(ys, ys + ylen), degenerate)
    sub = np.ix_(keep_x, keep_y)
    assert np.isfinite(r[sub]).all()
    np.testing.assert_allclose(r[sub], wr[sub], rtol=0, atol=2e-5)


def test_fz_nz_cpu_wrapper_runs_plain_version_without_counting():
    data = from_numpy_continuous(_cont_data("sparse"), "cpu")
    assert data.dtype == torch.float64 and data.is_contiguous()
    K.reset_launch_counts()
    got = K.fz_nz_stats(data, 25, 125, 100, 150)
    want = K.fz_nz_stats_ref(data, 25, 125, 100, 150)
    for g, w in zip(got, want):
        assert torch.equal(g.nan_to_num(7.0), w.nan_to_num(7.0))
    assert K.launch_counts() == {"mi_univar_stats": 0, "fz_nz_stats": 0,
                                 "pair_ctab_planes": 0,
                                 "mi_univar_stats_planes": 0,
                                 "mi_cond_stats": 0,
                                 "mi_window_digest": 0,
                                 "mi_turbo_digest": 0,
                                 "univar_extract": 0}


def test_fz_nz_wrapper_rejects_other_devices():
    t = torch.empty((4, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.fz_nz_stats(t, 0, 4)


def test_build_runs_one_nvcc_per_source_then_links(monkeypatch, tmp_path):
    """build_library with a stand-in nvcc that writes its -o file and a
    ptxas-style line: one compile per csrc/*.cu, one link, objects removed,
    the library named by the source hash with nvcc's report beside it, and
    both reused on the next call."""
    fake = tmp_path / "nvcc"
    calls = tmp_path / "calls.txt"
    fake.write_text(
        "#!/usr/bin/env python3\n"
        "import sys\n"
        f"open({str(calls)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('x')\n"
        "print('ptxas info    : Used 40 registers')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(K, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    info = K.build_library()
    lines = calls.read_text().splitlines()
    n_src = len(list(K.SRC_DIR.glob("*.cu")))
    assert n_src >= 2
    assert sum(" -c " in ln for ln in lines) == n_src
    assert sum(ln.startswith("-shared") for ln in lines) == 1
    assert info.path.exists() and info.path.name.startswith("libfw_kernels_")
    assert info.log.count("registers") == n_src
    report = info.path.with_suffix(".log")
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [
        report.name, info.path.name]
    again = K.build_library()
    assert again.path == info.path and again.seconds == 0.0
    assert again.log == info.log == report.read_text()
    assert len(calls.read_text().splitlines()) == len(lines)
