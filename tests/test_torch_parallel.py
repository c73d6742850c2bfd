"""The PyTorch port's device mesh (``flashweave_tpu_torch.parallel``) on the
CPU: a mesh of eight shards on one CPU device (``get_mesh(devices=["cpu"] *
8)``, the counterpart of the JAX package's 8 virtual CPU devices) against
the unmeshed port and against the JAX package's ``get_mesh(8)``, on tables
made from a seed with numpy.

Against the unmeshed port every result is exact: integers, floats bit for
bit, neighbor dicts equal item for item in insertion order:
- the univariate pass (the device extraction, one and two sweeps, and the
  host path ``return_result=True``) for mi_nz, mi, fz_nz and fz, at p = 9
  (three shards get no piece of the slab), p = 37 (pieces of unequal
  width) and in the multiblock case (p = 384, ``tile=64``);
- the engine's raw mi_nz, fz (gather and on the fly) and fz_nz results,
  and the mi window, turbo and continuous digests forced on with the
  existing hooks, batches of sizes that do not divide by eight;
- the multi_il LGL: the meshed network equals the unmeshed multi_il
  network edge for edge and weight for weight.
Against the JAX package, with the tolerances of ``tests/test_parallel.py``:
neighbor dicts with stats rtol 1e-5 and p rtol 1e-3; conditional mi_nz
stats rtol 1e-12 with df and suff equal; fz stats rtol 1e-9; fz_nz's masked
correlations and the three window digests with the tolerances of the
port's digest tests (``test_engine_matches_jax_mesh``).  The multi_il
LGL on a mesh against ``single`` goes through the port's copy of
``utils/testing.compare_graph_results`` (no differing neighbor, mean weight
difference at most 0.01), as the JAX package's mesh test does.  The scaling
harness (``parallel/scaling.py``) at shard counts 1, 2 and 8 finds the same
significant pairs at every count.  The mesh helpers: device-major ranges,
one replica per distinct device, the gather of uneven pieces.
"""

import numpy as np
import pytest
import torch

from flashweave_tpu.ops import univariate as juv
from flashweave_tpu.ops.condtests import CondTestEngine as JEngine
from flashweave_tpu.parallel.mesh import get_mesh as jax_get_mesh
from flashweave_tpu_torch.learning.hiton import (_combo_template,
                                                 _turbo_mxu_template)
from flashweave_tpu_torch.learning.lgl import LGL
from flashweave_tpu_torch.ops import condtests as tct
from flashweave_tpu_torch.ops import univariate as uv
from flashweave_tpu_torch.parallel import mesh as pm
from flashweave_tpu_torch.utils.misc import get_levels, get_max_vals
from flashweave_tpu_torch.utils.testing import compare_graph_results

ALPHA = 0.01


@pytest.fixture(scope="module")
def mesh():
    return pm.get_mesh(devices=["cpu"] * 8)


def _table(test_name, n, p, seed):
    """test_parallel.py's construction: 3-level (mi) or continuous columns,
    30% zeros, a copied column and a noisy copy."""
    rng = np.random.default_rng(seed)
    if test_name.startswith("mi"):
        data = rng.integers(0, 3, (n, p)).astype(np.float64)
        data[rng.random((n, p)) < 0.3] = 0.0
    else:
        data = np.where(rng.random((n, p)) < 0.3, 0.0,
                        rng.standard_normal((n, p)))
    data[:, 1] = data[:, 0]
    data[:, 3] = np.where(rng.random(n) < 0.7, data[:, 2], data[:, 3])
    for a, b in [(p // 5, 2 * p // 3), (p // 3, p - 1)]:
        data[:, b] = np.where(rng.random(n) < 0.8, data[:, a], data[:, b])
    return data


def _levels(test_name, data):
    if test_name.startswith("mi"):
        return get_levels(data.astype(int)), get_max_vals(data.astype(int))
    return None, None


def _items(nbrs):
    return [list(nbrs[v].items()) for v in sorted(nbrs)]


# -- the mesh helpers ---------------------------------------------------------

def test_mesh_helpers(mesh):
    assert mesh.size == 8 and mesh.first == 0 and mesh.group is None
    assert [r[1:] for r in mesh.shard_ranges(19)] == [
        (0, 3), (3, 6), (6, 9), (9, 12), (12, 15), (15, 18), (18, 19),
        (19, 19)]
    x = torch.arange(4.0)
    reps = pm.put_replicated(x, mesh)
    assert len(reps) == 8 and all(r is reps[0] for r in reps)
    parts = [torch.full((i % 3, 2), float(i)) for i in range(8)]
    got = pm.gather(mesh, parts)
    np.testing.assert_array_equal(got.numpy(), torch.cat(parts).numpy())
    assert pm.gather(mesh, [p.T for p in parts], dim=1).shape == (2, 7)
    assert int(pm.psum(mesh, torch.tensor(28))) == 28
    assert pm.bcast_scalar_from_rank0(mesh, 2.5) == 2.5
    a = np.arange(10).reshape(5, 2)
    np.testing.assert_array_equal(pm.pad_to_multiple(a, 4, 0),
                                  np.vstack([a, np.zeros((3, 2), int)]))
    assert pm.get_mesh(2, devices=["cpu"] * 8).size == 2
    with pytest.raises(ValueError):
        pm.get_mesh(9, devices=["cpu"] * 8)


# -- the univariate pass ------------------------------------------------------

UNIVAR = [(t, p, tile) for t in ("mi_nz", "mi", "fz_nz", "fz")
          for p, tile in ((9, None), (37, None), (384, 64))]


@pytest.mark.parametrize("test_name,p,tile", UNIVAR)
def test_univar_mesh_equals_unmeshed(mesh, test_name, p, tile):
    data = _table(test_name, 200, p, seed=p)
    lv, mx = _levels(test_name, data)
    kw = dict(levels=lv, max_vals=mx, tile=tile, device="cpu")
    want = uv.pw_univar_neighbors(data, test_name, **kw)
    info = {}
    got = uv.pw_univar_neighbors(data, test_name, mesh=mesh, info=info, **kw)
    assert _items(got) == _items(want)
    assert sum(map(len, got.values())) >= 6
    calls = [0] * 8                  # the shards with a nonempty piece
    for *_, y_len in uv._sweep_blocks(p, tile or p):
        for i, a, b in mesh.shard_ranges(y_len):
            calls[i] += b > a
    assert info["shard_calls"] == calls and min(calls) >= (p > 9)
    # the host path: every block gathered along Y
    _, rw = uv.pw_univar_neighbors(data, test_name, return_result=True, **kw)
    _, rg = uv.pw_univar_neighbors(data, test_name, return_result=True,
                                   mesh=mesh, **kw)
    np.testing.assert_array_equal(rg.stats, rw.stats)
    np.testing.assert_array_equal(rg.pvals, rw.pvals)


@pytest.mark.parametrize("test_name", ["mi_nz", "fz_nz"])
def test_univar_mesh_two_sweeps(mesh, test_name, monkeypatch):
    """Past the budget on the global candidate count, the mesh takes the
    second sweep at the BH-safe edge, as unmeshed."""
    data = _table(test_name, 200, 384, seed=3)
    lv, mx = _levels(test_name, data)
    kw = dict(levels=lv, max_vals=mx, tile=64, device="cpu")
    monkeypatch.setattr(uv, "EXTRACT_BUDGET", 300)
    iw, ig = {}, {}
    want = uv.pw_univar_neighbors(data, test_name, info=iw, **kw)
    got = uv.pw_univar_neighbors(data, test_name, mesh=mesh, info=ig, **kw)
    assert iw["route"] == ig["route"] == "two sweeps"
    assert ig["K"] == iw["K"] and ig["n_sig"] == iw["n_sig"]
    assert _items(got) == _items(want)


def _close(a, b, rtol_stat=1e-5, rtol_pval=1e-3):
    """tests/test_parallel.py's ``_nbr_dicts_close``."""
    assert set(a) == set(b)
    for T in a:
        assert set(a[T]) == set(b[T]), T
        for nbr, (st1, pv1) in a[T].items():
            st2, pv2 = b[T][nbr]
            assert np.isclose(st1, st2, rtol=rtol_stat), (T, nbr)
            assert np.isclose(pv1, pv2, rtol=rtol_pval, atol=1e-280), (T, nbr)


@pytest.mark.parametrize("test_name,p,tile", [("mi_nz", 37, None),
                                              ("fz_nz", 37, None),
                                              ("fz", 384, 64)])
def test_univar_mesh_matches_jax_mesh(mesh, test_name, p, tile):
    data = _table(test_name, 200, p, seed=p)
    lv, mx = _levels(test_name, data)
    got = uv.pw_univar_neighbors(data, test_name, levels=lv, max_vals=mx,
                                 tile=tile, device="cpu", mesh=mesh)
    want = juv.pw_univar_neighbors(data, test_name, levels=lv, max_vals=mx,
                                   tile=tile, mesh=jax_get_mesh(8))
    _close(got, want)


# -- the conditioning engine --------------------------------------------------

def _batch(p, B, max_k, seed):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, p, B).astype(np.int64)
    Y = (X + 1 + rng.integers(0, p - 2, B)) % p
    Zs = rng.integers(0, p, (B, max_k)).astype(np.int64)
    kv = rng.integers(0, max_k + 1, B).astype(np.int64)
    return X, Y, Zs, kv


def _engines(data, test_name, mesh, **kw):
    lv, mx = _levels(test_name, data)
    args = dict(levels=lv, max_vals=mx, hps=5, n_obs_min=10, device="cpu",
                **kw)
    return (tct.CondTestEngine(data, test_name, 3, **args),
            tct.CondTestEngine(data, test_name, 3, mesh=mesh, **args))


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_engine_mi_nz_equals_unmeshed_and_jax(mesh):
    data = _table("mi_nz", 200, 36, seed=42)
    one, meshed = _engines(data, "mi_nz", mesh)
    batch = _batch(36, 101, 3, seed=0)
    got = meshed.mi_tests_raw(*batch)
    _equal(got, one.mi_tests_raw(*batch))
    lv, mx = _levels("mi_nz", data)
    jeng = JEngine(data, "mi_nz", 3, levels=lv, max_vals=mx, hps=5,
                   n_obs_min=10, mesh=jax_get_mesh(8))
    jstat, _, jdf, jsuff = jeng.mi_tests_raw(*batch)
    np.testing.assert_allclose(got[0], jstat, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got[2], jdf)
    np.testing.assert_array_equal(got[3], jsuff)


@pytest.mark.parametrize("onfly", [False, True])
def test_engine_fz_equals_unmeshed_and_jax(mesh, onfly, monkeypatch):
    monkeypatch.setattr(tct, "FORCE_COR_ONFLY", onfly)
    data = np.log1p(np.abs(_table("fz", 200, 36, seed=5)))
    one, meshed = _engines(data, "fz", mesh)
    assert meshed.cor_onfly == onfly and meshed.cor_device
    batch = _batch(36, 101, 3, seed=1)
    got = meshed.fz_tests_raw(*batch)
    _equal(got, one.fz_tests_raw(*batch))
    jeng = JEngine(data, "fz", 3, hps=5, n_obs_min=10, mesh=jax_get_mesh(8))
    jstat, jpval, _, _ = jeng.fz_tests_raw(*batch)
    np.testing.assert_allclose(got[0], jstat, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[1], jpval, rtol=1e-9, atol=1e-300)


def _var_lists(p, NC, seed):
    rng = np.random.default_rng(seed)
    return [[int(v) for v in rng.choice(p, int(rng.integers(3, 7)),
                                        replace=False)] for _ in range(NC)]


@pytest.mark.parametrize("plain", [False, True])
def test_engine_masked_cor_equals_unmeshed(mesh, plain):
    data = np.log1p(np.abs(_table("fz_nz", 200, 36, seed=6)))
    one, meshed = _engines(data, "fz_nz", mesh)
    vls = _var_lists(36, 301, seed=2)
    pairs = [(v[0], v[1]) for v in vls]
    got = meshed.masked_cor_finish_raw(meshed.masked_cor_begin(pairs, vls,
                                                               plain))
    want = one.masked_cor_finish_raw(one.masked_cor_begin(pairs, vls, plain))
    _equal(got, want)


def _mi_round(p, NC, max_k, seed):
    """A round of NC mi candidate windows: target, candidate and 1..5 Zs
    whose subsets (``_combo_template``) are the candidate's tests."""
    rng = np.random.default_rng(seed)
    X, Y, Zs, kv, counts = [], [], [], [], []
    for _ in range(NC):
        a = int(rng.integers(1, 6))
        t, y, *zs = (int(v) for v in rng.choice(p, a + 2, replace=False))
        pos, k = _combo_template(a, max_k)
        Z = np.asarray(zs, np.int64)[pos]
        Z[np.arange(max_k)[None, :] >= k[:, None]] = 0
        X.append(np.full(len(k), t))
        Y.append(np.full(len(k), y))
        Zs.append(Z)
        kv.append(k)
        counts.append(len(k))
    return (np.concatenate(X), np.concatenate(Y), np.concatenate(Zs),
            np.concatenate(kv).astype(np.int64), np.asarray(counts, np.int64))


def test_mi_window_digest_equals_unmeshed(mesh, monkeypatch):
    monkeypatch.setattr(tct, "FORCE_DEV_DIGEST", True)
    data = _table("mi_nz", 300, 36, seed=9)
    one, meshed = _engines(data, "mi_nz", mesh)
    assert meshed.dev_digest
    rnd = _mi_round(36, 77, 3, seed=4)
    got = meshed.mi_tests_finish_digest(
        meshed.mi_tests_begin_digest(*rnd, ALPHA))
    _equal(got, one.mi_tests_finish_digest(
        one.mi_tests_begin_digest(*rnd, ALPHA)))
    assert (got[0] == -1).any() and (got[0] >= 0).any()


@pytest.mark.parametrize("m", [3, 6])
def test_turbo_digest_equals_unmeshed(mesh, m, monkeypatch):
    data = _table("mi_nz", 300, 36, seed=10)
    one, meshed = _engines(data, "mi_nz", mesh)
    assert meshed.turbo_mxu
    tpl = _turbo_mxu_template(m, 3)
    rng = np.random.default_rng(m)
    W = 21
    Ts = rng.integers(0, 36, W)
    cands = np.stack([rng.choice(np.setdiff1d(np.arange(36), [t]), m,
                                 replace=False) for t in Ts])
    got = meshed.turbo_tests_finish(
        meshed.turbo_tests_begin(m, Ts, cands, ALPHA, tpl))
    _equal(got, one.turbo_tests_finish(
        one.turbo_tests_begin(m, Ts, cands, ALPHA, tpl)))
    assert got[0].shape == (W, tpl["NC"])
    assert set(meshed._turbo_dev_cache) == {(m, torch.device("cpu"))}


def _cont_round(p, NC, seed, max_k=3):
    rng = np.random.default_rng(seed)
    vls, pos, kv, counts = [], [], [], []
    for _ in range(NC):
        a = int(rng.integers(1, 7))
        vls.append([int(x) for x in rng.choice(p, a + 2, replace=False)])
        P, K = _combo_template(a, max_k)
        pos.append(P)
        kv.append(K)
        counts.append(len(K))
    return (vls, np.concatenate(pos), np.concatenate(kv),
            np.asarray(counts, np.int64))


@pytest.mark.parametrize("test_name,onfly", [("fz_nz", False),
                                             ("fz", True)])
def test_cont_digest_equals_unmeshed(mesh, test_name, onfly, monkeypatch):
    """Whole 16-candidate segments a shard, gathered along the
    candidates; 150 candidates leave the last shard empty."""
    monkeypatch.setattr(tct, "FORCE_CONT_DEV", True)
    monkeypatch.setattr(tct, "FORCE_COR_ONFLY", onfly)
    monkeypatch.setattr(tct, "MCOR_SEG", 16)
    data = np.log1p(np.abs(_table(test_name, 300, 36, seed=11)))
    one, meshed = _engines(data, test_name, mesh)
    assert meshed.cont_dev
    rnd = _cont_round(36, 150, seed=12)
    got = meshed.cont_tests_finish(meshed.cont_tests_begin(*rnd, ALPHA))
    _equal(got, one.cont_tests_finish(one.cont_tests_begin(*rnd, ALPHA)))
    assert (got[0] == -1).any() and (got[0] >= 0).any()


def _close_log(wp, jwp):
    """wpval against the JAX package's: 0 at the same candidates, log p
    within 1e-5 elsewhere (its log erfc series past z = 8 is up to 6.8e-6
    off in float64, ROADMAP queue 3)."""
    np.testing.assert_array_equal(wp == 0, jwp == 0)
    has = wp > 0
    assert has.any()
    np.testing.assert_allclose(np.log(wp[has]), np.log(jwp[has]), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["masked_cor", "mi", "turbo", "cont"])
def test_engine_matches_jax_mesh(mesh, kind, monkeypatch):
    """fz_nz's masked correlations (C rtol 1e-10 / atol 1e-12, row counts
    equal) and the three window digests on the mesh against the JAX
    engine's on ``get_mesh(8)``: exit_e equal, wstat rtol 1e-12 (mi, turbo:
    where a slot has a significant test; the JAX turbo digest writes 0
    elsewhere) or rtol 1e-9 / atol 1e-12 (continuous), wpval by
    :func:`_close_log`."""
    from flashweave_tpu.ops import condtests as jct

    jmesh = jax_get_mesh(8)
    if kind == "masked_cor":
        data = np.log1p(np.abs(_table("fz_nz", 200, 36, seed=6)))
        _, meshed = _engines(data, "fz_nz", mesh)
        vls = _var_lists(36, 301, seed=2)
        pairs = [(v[0], v[1]) for v in vls]
        jeng = JEngine(data, "fz_nz", 3, hps=5, n_obs_min=10, mesh=jmesh)
        for (C, n), (jC, jn), vl in zip(meshed.masked_cor(pairs, vls),
                                        jeng.masked_cor(pairs, vls), vls):
            k = len(vl)
            assert n == jn
            np.testing.assert_allclose(C[:k, :k], jC[:k, :k], rtol=1e-10,
                                       atol=1e-12)
        return
    if kind == "cont":
        monkeypatch.setattr(tct, "FORCE_CONT_DEV", True)
        monkeypatch.setattr(jct, "FORCE_CONT_DEV", True)
        monkeypatch.setattr(tct, "MCOR_SEG", 16)
        data = np.log1p(np.abs(_table("fz_nz", 300, 36, seed=11)))
        _, meshed = _engines(data, "fz_nz", mesh)
        jeng = JEngine(data, "fz_nz", 3, hps=5, n_obs_min=10, mesh=jmesh)
        rnd = _cont_round(36, 150, seed=12)
        ex, ws, wp = meshed.cont_tests_finish(
            meshed.cont_tests_begin(*rnd, ALPHA))
        jex, jws, jwp = jeng.cont_tests_finish(
            jeng.cont_tests_begin(*rnd, ALPHA))
        np.testing.assert_array_equal(ex, jex)
        np.testing.assert_allclose(ws, jws, rtol=1e-9, atol=1e-12)
        _close_log(wp, jwp)
        return
    monkeypatch.setattr(tct, "FORCE_DEV_DIGEST", True)
    monkeypatch.setattr(jct, "FORCE_DEV_DIGEST", True)
    data = _table("mi_nz", 300, 36, seed=9 if kind == "mi" else 10)
    _, meshed = _engines(data, "mi_nz", mesh)
    lv, mx = _levels("mi_nz", data)
    jeng = JEngine(data, "mi_nz", 3, levels=lv, max_vals=mx, hps=5,
                   n_obs_min=10, mesh=jmesh)
    if kind == "mi":
        rnd = _mi_round(36, 77, 3, seed=4)
        ex, ws, wp = meshed.mi_tests_finish_digest(
            meshed.mi_tests_begin_digest(*rnd, ALPHA))
        jex, jws, jwp = jeng.mi_tests_finish_digest(
            jeng.mi_tests_begin_digest(*rnd, ALPHA))
    else:
        assert jeng.turbo_mxu
        tpl = _turbo_mxu_template(6, 3)
        rng = np.random.default_rng(6)
        Ts = rng.integers(0, 36, 21)
        cands = np.stack([rng.choice(np.setdiff1d(np.arange(36), [t]), 6,
                                     replace=False) for t in Ts])
        ex, ws, wp = meshed.turbo_tests_finish(
            meshed.turbo_tests_begin(6, Ts, cands, ALPHA, tpl))
        jex, jws, jwp = jeng.turbo_tests_finish(
            jeng.turbo_tests_begin(6, Ts, cands, ALPHA, tpl))
    np.testing.assert_array_equal(ex, jex)
    has = wp > 0
    np.testing.assert_allclose(ws[has], jws[has], rtol=1e-12, atol=0)
    _close_log(wp, jwp)


# -- LGL ------------------------------------------------------------------------

@pytest.mark.parametrize("test_name", ["mi_nz", "mi", "fz", "fz_nz"])
def test_lgl_multi_il_mesh(mesh, test_name):
    """test_parallel.py's test_lgl_mesh_matches_single construction (max_k
    2): the meshed multi_il network equals the unmeshed multi_il network
    exactly, and ``single`` through compare_graph_results."""
    rng = np.random.default_rng(11)
    n, p = 250, 30
    if test_name.startswith("mi"):
        d = rng.integers(0, 2 if test_name == "mi" else 3, (n, p))
        d = d.astype(np.float64)
        d[:, 1] = d[:, 0]
        d[:, 3] = np.where(rng.random(n) < 0.8, d[:, 2], d[:, 3])
    else:
        d = rng.standard_normal((n, p))
        d[:, 1] = d[:, 0] + 0.1 * rng.standard_normal(n)
        d[:, 3] = d[:, 2] + 0.5 * rng.standard_normal(n)
        if test_name == "fz_nz":
            d = np.where(rng.random((n, p)) < 0.2, 0.0, d)
    kw = dict(test_name=test_name, max_k=2, time_limit=0.0,
              convergence_threshold=0.0, verbose=False, device="cpu")
    single = LGL(d, parallel="single", **kw).graph
    multi = LGL(d, parallel="multi_il", **kw).graph
    meshed = LGL(d, parallel="multi_il", mesh=mesh, **kw).graph
    assert sorted(meshed.edges()) == sorted(multi.edges())
    assert meshed.n_edges() > 0
    assert compare_graph_results(single, meshed, approx=True,
                                 approx_nbr_diff=0,
                                 approx_weight_meandiff=0.01, verbose=True)


# -- the scaling harness --------------------------------------------------------

def test_scaling_harness():
    from flashweave_tpu_torch.parallel.scaling import (cond_scaling, report,
                                                       univar_scaling)

    rng = np.random.default_rng(42)
    synth = rng.integers(0, 3, (200, 36)).astype(np.float64)
    synth[:, 1] = synth[:, 0]
    synth[:, 3] = np.where(rng.random(200) < 0.8, synth[:, 2], synth[:, 3])
    res = univar_scaling(synth, "mi_nz", device_counts=(1, 2, 8), repeats=1,
                         device="cpu")
    assert set(res) == {1, 2, 8}
    sigs = {r["n_significant"] for r in res.values()}
    assert len(sigs) == 1 and sigs.pop() > 0
    assert all(r["tests_per_sec"] > 0 for r in res.values())
    assert res[1]["efficiency"] == 1.0
    assert "8 device(s)" in report(res, "univar")
    res2 = cond_scaling(synth, "mi_nz", B=512, device_counts=(1, 8),
                        repeats=1, device="cpu")
    assert set(res2) == {1, 8}
