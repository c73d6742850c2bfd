"""K3 (contingency planes) and K4 (the tensor-core form of the univariate
G-test) in the PyTorch port: their plain versions, the planes route of the
univariate pass and the choice of block function by level count, against
the JAX package.

Tables are n=500, p=250 (not tile multiples) from numpy seeds.  Held:
- ``x_indicator_planes`` / ``y_indicator_planes`` against the JAX functions,
  exactly;
- ``pair_ctab_planes_ref`` against the Pallas kernel ``mi_pair_ctabs`` in
  interpret mode, exactly;
- ``mi_univar_stats_planes_ref`` against the Pallas kernel
  ``mi_univar_stats_planes`` in interpret mode (integers exact, stat atol
  2e-6 / rtol 2e-5: the Pallas epilogue is float32), and against K1's plain
  version in float64 (integers exact, stat rtol 1e-12 / atol 1e-15: the
  same float64 arithmetic, margins rebuilt instead of recounted);
- ``mi_planes_stats`` against the JAX ``mi_planes_stats`` on the same planes
  (the JAX function casts the planes to float32: integers exact, stat atol
  2e-6 / rtol 2e-5);
- the univariate pass and ``learn_network(normalize=False)`` on a 10-level
  table, where the port picks K4, against the JAX package (single_il: edges
  identical, weights rtol 1e-9).
The CUDA kernels themselves run only on the card (``chip_smoke.py``
phases 2c, 2d, 3c, 6 and 7).
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import flashweave_tpu as fw
import flashweave_tpu_torch as fwt
from flashweave_tpu.ops import pallas_kernels as pk
from flashweave_tpu.ops import univariate as juv
from flashweave_tpu_torch.ops import kernels as K
from flashweave_tpu_torch.ops import univariate as U
from flashweave_tpu_torch.state import from_numpy_state

N, P = 500, 250
BLOCKS = [(0, 250, 0, 250), (25, 125, 100, 150)]   # full, ragged
# MI statistics in float64 on both sides: a stat of 0 on one side can be
# ~1e-18 on the other from summation order, so a small atol beside rtol
RTOL64, ATOL64 = 1e-12, 1e-15


def _data(L, nz, seed=0):
    """(N, P) table of L levels: sparse (nz 0 / 1, some binary and sparse
    variables, one constant) or with every variable at all three levels
    (nz 2); every 4th variable mostly copies its left neighbour."""
    rng = np.random.default_rng(100 * L + 10 * nz + seed)
    data = rng.integers(0, L, (N, P)).astype(np.float64)
    keep = rng.random((N, len(range(1, P, 4)))) < 0.7
    data[:, 1::4] = np.where(keep, data[:, 0:P - 1:4], data[:, 1::4])
    if nz == 2:
        data[:3] = np.arange(3)[:, None]
    else:
        # few enough zeros that many-level nz tables still pass the checks
        data[rng.random((N, P)) < (0.4 if L <= 3 else 0.1)] = 0.0
        sparse = data[:, 5::11]
        sparse[rng.random(sparse.shape) < 0.96] = 0.0
        data[:, 5::11] = sparse
        data[:, ::7] = np.minimum(data[:, ::7], 1.0)
        data[:, 3::50] = 0.0
    return data


def _state(data):
    return from_numpy_state(data, None, None, "cpu")


def _args(st, nz, block):
    s, tile, ys, ylen = block
    return (st.dataT, st.marg, st.levels, st.max_vals, s, tile, st.L, ys, ylen,
            nz, 5.0, 20.0)


def _assert_stats(got, want, rtol, atol):
    for g, w in zip(got[1:], want[1:]):
        g = np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("L,tx,tn", [(2, 128, 256), (3, 128, 256),
                                     (10, 32, 128)])
def test_indicator_planes_match_jax(L, tx, tn):
    data = _data(L, 0).astype(np.int8)
    got_x = K.x_indicator_planes(torch.from_numpy(data.T.copy()), L, tx, tn)
    got_y = K.y_indicator_planes(torch.from_numpy(data), L, tx, tn)
    want_x = pk.x_indicator_planes(jnp.asarray(data.T), L, tx, tn)
    want_y = pk.y_indicator_planes(jnp.asarray(data), L, tx, tn)
    assert got_x.dtype == got_y.dtype == torch.int8
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


@pytest.mark.parametrize("L,block", [(2, BLOCKS[0]), (3, BLOCKS[1]),
                                     (5, BLOCKS[1])])
def test_pair_ctab_planes_ref_matches_pallas_interpret(L, block):
    data = _data(L, 0)
    s, tile, ys, ylen = block
    got = K.pair_ctab_planes_ref(_state(data).dataT, s, tile, L, ys, ylen)
    dj = jnp.asarray(data)
    want = pk.mi_pair_ctabs(dj[:, s:s + tile], dj[:, ys:ys + ylen], L=L,
                            tx=128, ty=128, tn=256)
    assert got.dtype == torch.int32 and got.shape == (L * L, tile, ylen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _padc(a, w, fill):
    out = np.full((a.shape[0], w), fill, a.dtype)
    out[:, :a.shape[1]] = a
    return out


@pytest.mark.parametrize("L,nz", [(2, 1), (3, 0), (3, 2), (5, 1)])
def test_planes_ref_matches_pallas_interpret(L, nz):
    """Every X-tile of the Pallas planes kernel, fed as
    tests/test_pallas.py feeds it, against the plain version on the same
    block."""
    data = _data(L, nz)
    st = _state(data)
    d8 = jnp.asarray(data.astype(np.int8))
    tx = ty = 128
    tn = 256
    xpl = pk.x_indicator_planes(d8.T, L, tx, tn)
    ypl = pk.y_indicator_planes(d8, L, ty, tn)
    p_pad_x = xpl.shape[0] * tx
    p_pad_y = ypl.shape[1] // ((L - 1) * ty) * ty
    marg = st.marg.numpy()
    lv, mv = st.levels_np[None], st.max_vals_np[None]
    for bi in range(p_pad_x // tx):
        want = pk.mi_univar_stats_planes(
            xpl, ypl, jnp.asarray(_padc(marg, p_pad_x, 0)),
            jnp.asarray(_padc(marg, p_pad_y, 0)),
            jnp.asarray(_padc(lv, p_pad_x, 1)),
            jnp.asarray(_padc(lv, p_pad_y, 1)),
            jnp.asarray(_padc(mv, p_pad_x, 0)),
            jnp.asarray(_padc(mv, p_pad_y, 0)),
            bi, L, 0, p_pad_y, nz, 5.0, 20.0, N, tx=tx, ty=ty, tn=tn)
        s, tile = bi * tx, min(tx, P - bi * tx)
        got = K.mi_univar_stats_planes_ref(*_args(st, nz, (s, tile, 0, P)))
        want = [np.asarray(w)[:tile, :P] for w in want]
        assert got[3].any()
        _assert_stats(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("L,nz", [(2, 0), (3, 1), (3, 2), (6, 1), (8, 1),
                                  (10, 0)])
def test_planes_ref_matches_k1_ref(L, nz, block):
    """The margin reconstruction of K4's plain version against K1's, which
    recounts all L^2 cells: both float64."""
    st = _state(_data(L, nz))
    got = K.mi_univar_stats_planes_ref(*_args(st, nz, block))
    want = K.mi_univar_stats_ref(*_args(st, nz, block))
    assert got[0].dtype == torch.float64 and got[1].dtype == torch.int32
    assert got[3].any()
    _assert_stats(got, want, rtol=RTOL64, atol=ATOL64)


@pytest.mark.parametrize("L,nz", [(3, 1), (4, 0)])
def test_mi_planes_stats_matches_jax(L, nz):
    st = _state(_data(L, nz))
    s, tile, ys, ylen = BLOCKS[1]
    planes = K.pair_ctab_planes_ref(st.dataT, s, tile, L, ys, ylen)
    lv, mv = st.levels_np, st.max_vals_np
    sl = (slice(s, s + tile), slice(ys, ys + ylen))
    got = U.mi_planes_stats(planes, st.levels[sl[0]], st.levels[sl[1]],
                            st.max_vals[sl[0]], st.max_vals[sl[1]], 5.0, 20.0,
                            nz, L)
    want = juv.mi_planes_stats(jnp.asarray(planes.numpy()), lv[sl[0]],
                               lv[sl[1]], mv[sl[0]], mv[sl[1]], 5.0, 20.0, nz,
                               L)
    assert got[3].any()
    _assert_stats(got, want, rtol=2e-5, atol=2e-6)
    # the route function: K3's plain planes, then mi_planes_stats
    route = U.mi_planes_block(*_args(st, nz, BLOCKS[1]))
    _assert_stats(route, K.mi_univar_stats_ref(*_args(st, nz, BLOCKS[1])),
                  rtol=RTOL64, atol=ATOL64)


def test_block_fn_chosen_from_levels():
    """K1 for L = 2..4, K4 for L = 5..127 (the faster kernel at each L on
    the card, PERF.md), decided from L alone."""
    for L in range(2, 5):
        assert U.mi_block_fn(L) is K.mi_univar_stats
    for L in range(5, 128):
        assert U.mi_block_fn(L) is K.mi_univar_stats_planes
    assert K.K1_LEVELS == range(2, 5) and K.PLANES_LEVELS == range(2, 128)


def test_k4_tile_fits_its_store():
    """K4's slab walk cuts the block into sub-blocks of whole block tiles
    that cover it once, each slab of int32 counts within K4_SCRATCH_BYTES
    (phase 6's block: three parts of the Y-slab; at L = 127, eight block
    tiles a slab, so the X-block is cut too)."""
    bx, by = K.K4_TILE
    tile, y_len = 512, 10_000
    for L in K.PLANES_LEVELS:
        per_tile = (L - 1) ** 2 * bx * by * 4
        subs = K.k4_sub_blocks(L, tile, y_len)
        xs = sorted({(x0, xl) for x0, xl, _, _ in subs})
        ys = sorted({(y0, yl) for _, _, y0, yl in subs})
        assert len(subs) == len(xs) * len(ys)
        for spans, total, side in ((xs, tile, bx), (ys, y_len, by)):
            assert spans[0][0] == 0 and sum(ln for _, ln in spans) == total
            assert all(a0 + al == b0 for (a0, al), (b0, _) in zip(spans, spans[1:]))
            assert all(s0 % side == 0 for s0, _ in spans)
        slab = max(-(-xl // bx) * -(-yl // by) for _, xl, _, yl in subs) * per_tile
        assert slab <= K.K4_SCRATCH_BYTES
        assert (len(subs) == 1) == (L <= 8)
    assert K.k4_sub_blocks(12, tile, y_len) == [
        (0, 512, 0, 3392), (0, 512, 3392, 3392), (0, 512, 6784, 3216)]
    assert {x0 for x0, _, _, _ in K.k4_sub_blocks(127, tile, y_len)} == {0, 256}


def test_cpu_wrappers_run_plain_versions_without_counting():
    st = _state(_data(10, 1))
    K.reset_launch_counts()
    args = _args(st, 1, BLOCKS[1])
    for g, w in zip(K.mi_univar_stats_planes(*args),
                    K.mi_univar_stats_planes_ref(*args)):
        assert torch.equal(g, w)
    assert torch.equal(K.pair_ctab_planes(st.dataT, 25, 125, 10, 100, 150),
                       K.pair_ctab_planes_ref(st.dataT, 25, 125, 10, 100, 150))
    assert set(K.launch_counts()) == {"mi_univar_stats", "fz_nz_stats",
                                      "pair_ctab_planes",
                                      "mi_univar_stats_planes",
                                      "mi_cond_stats", "mi_window_digest",
                                      "mi_turbo_digest", "univar_extract"}
    assert not any(K.launch_counts().values())


def test_planes_wrappers_reject_other_devices():
    t = torch.empty((4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.mi_univar_stats_planes(t, t, t, t, 0, 4, 10)
    with pytest.raises(ValueError, match="unsupported device"):
        K.pair_ctab_planes(t, 0, 4, 10)


def _levels_table(n, p, L, group=5, seed=1):
    """Grouped L-level table (the construction of chip_smoke.synth_table)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, L, (n, p // group))
    data = np.repeat(base, group, axis=1)
    flip = rng.random((n, p)) < 0.35
    data = np.where(flip, rng.integers(0, L, (n, p)), data)
    return data.astype(np.float64)


@pytest.mark.parametrize("test_name", ["mi", "mi_nz"])
def test_pw_univar_neighbors_10_levels_matches_jax(test_name):
    from flashweave_tpu.ops.univariate import pw_univar_neighbors as jax_pw

    # n = 800: a 10 x 10 table needs n / 100 > hps = 5 to be tested
    data = _levels_table(800, P, 10)
    kw = dict(test_name=test_name, alpha=0.01, hps=5, n_obs_min=20, tile=96)
    want, wres = jax_pw(data, return_result=True, **kw)
    got, gres = U.pw_univar_neighbors(data, return_result=True, device="cpu",
                                      **kw)
    # the planes route gives the same decisions (on the host path, whose
    # dicts keep the condensed order)
    planes, _ = U.pw_univar_neighbors(data, device="cpu", return_result=True,
                                      block_fn=U.mi_planes_block, **kw)
    assert sum(map(len, got.values())) > 200
    np.testing.assert_array_equal(gres.suff_power, wres.suff_power)
    for v in range(P):
        assert list(got[v]) == list(want[v]) == list(planes[v])
        if got[v]:
            np.testing.assert_allclose(np.array(list(got[v].values())),
                                       np.array(list(want[v].values())),
                                       rtol=RTOL64, atol=0)


@pytest.mark.parametrize("heterogeneous", [False, True])
def test_learn_network_10_levels_matches_jax(heterogeneous):
    data = _levels_table(600, 40, 10)
    kw = dict(sensitive=False, heterogeneous=heterogeneous, normalize=False,
              max_k=3, parallel_mode="single_il", verbose=False,
              time_limit=0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = fw.graph(fw.learn_network(data, **kw))
        got = fwt.graph(fwt.learn_network(data, device="cpu", **kw))
    we, ge = list(want.edges()), list(got.edges())
    assert len(we) > 20
    assert [e[:2] for e in ge] == [e[:2] for e in we]
    np.testing.assert_allclose([e[2] for e in ge], [e[2] for e in we],
                               rtol=1e-9, atol=0)


def _wide_level_table(n=400, p=60, seed=4):
    """Mostly 3-level table in which a few variables take levels past 127
    (so L = 151), while every variable has at most 3 distinct values and
    its tests keep their power."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 3, (n, p)).astype(np.float64)
    data[:, 1::4] = np.where(rng.random((n, len(range(1, p, 4)))) < 0.7,
                             data[:, 0:p - 1:4], data[:, 1::4])
    data[:, 2::9] = np.where(data[:, 2::9] == 2, 150.0, data[:, 2::9])
    data[:, 3::9] = np.where(data[:, 3::9] == 1, 131.0, data[:, 3::9])
    return data


@pytest.mark.parametrize("test_name", ["mi", "mi_nz"])
def test_more_than_127_levels_take_the_pair_table_route(test_name):
    """L >= 128: an int16 table and the plain pair-table route with a cut
    tile, against the JAX package's univariate pass (its XLA route)."""
    from flashweave_tpu.ops.univariate import pw_univar_neighbors as jax_pw

    data = _wide_level_table()
    st = _state(data)
    assert st.L == 151 and st.dataT.dtype == torch.int16
    assert U.mi_block_fn(st.L) is K.mi_univar_stats_ref
    assert U._pair_table_tile(512, st.L, 10_000) == 1
    kw = dict(test_name=test_name, alpha=0.01, hps=5, n_obs_min=20)
    want, wres = jax_pw(data, return_result=True, **kw)
    got, gres = U.pw_univar_neighbors(data, return_result=True, device="cpu",
                                      **kw)
    # mi_nz sizes its post-check by the table's L (150 x 150 cells), so
    # there no pair has the power; both packages agree on that too
    assert sum(map(len, got.values())) > (20 if test_name == "mi" else -1)
    np.testing.assert_array_equal(gres.suff_power, wres.suff_power)
    np.testing.assert_allclose(gres.stats, wres.stats, rtol=RTOL64,
                               atol=ATOL64)
    np.testing.assert_allclose(gres.pvals, wres.pvals, rtol=1e-10, atol=0)
    for v in range(data.shape[1]):
        assert list(got[v]) == list(want[v])
