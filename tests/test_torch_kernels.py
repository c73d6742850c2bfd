"""K1 (the fused univariate G-test) in the PyTorch port: its plain version
and ``level_marginals`` against the JAX package.

Data is n=500, p=250, deliberately not a tile multiple.  The plain version
(what the CPU wrapper runs) is held against
- ``pair_ctab_block`` + ``mi_block_stats`` in x64: integers exact, stat
  rtol 1e-12;
- the Pallas kernel ``mi_univar_stats_pallas`` in interpret mode: integers
  exact, stat atol 2e-6 / rtol 2e-5 (the Pallas epilogue is float32).
The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flashweave_tpu.ops import pallas_kernels as pk
from flashweave_tpu.ops.contingency import pair_ctab_block
from flashweave_tpu.ops.univariate import mi_block_stats
from flashweave_tpu_torch.ops import kernels as K
from flashweave_tpu_torch.state import from_numpy_state

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
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-12, atol=0)
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
    assert K.launch_counts() == {"mi_univar_stats": 0}


def test_wrapper_rejects_other_devices():
    t = torch.empty((4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.mi_univar_stats(t, t, t, t, 0, 4, 3)


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
