"""The PyTorch port's statistics functions against the JAX package's, on the
same random stratified tables (made with numpy).  Integers must be equal,
floats within rtol 1e-12 (both sides compute in float64; only summation
order differs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flashweave_tpu.ops import statfuns as jsf
from flashweave_tpu_torch.ops import statfuns as tsf


def _tables(seed, B, L, S, nz):
    """Random (B, L, L, S) count tables with nz slicing applied the way the
    engines do (zeroed cells + offsets), plus some empty strata."""
    rng = np.random.default_rng(seed)
    ctab = rng.integers(0, 30, (B, L, L, S)).astype(np.float64)
    ctab[rng.random((B, L, L, S)) < 0.3] = 0.0
    ctab[:, :, :, rng.random(S) < 0.2] = 0.0
    if nz:
        ox = rng.integers(0, 2, B)
        oy = rng.integers(0, 2, B)
        a = np.arange(L)
        keep = (a[None, :, None] >= ox[:, None, None]) & (a[None, None, :] >= oy[:, None, None])
        ctab = ctab * keep[..., None]
    else:
        ox = np.zeros(B, np.int64)
        oy = np.zeros(B, np.int64)
    return ctab, ox, oy


@pytest.mark.parametrize("L,S,nz", [(2, 1, False), (3, 1, True), (3, 27, True),
                                    (2, 8, False), (4, 16, True)])
def test_mi_stats_matches_jax(L, S, nz):
    ctab, ox, oy = _tables(L * 100 + S, 400, L, S, nz)
    want = jsf.mi_stats(jnp.asarray(ctab), jnp.asarray(ox), jnp.asarray(oy),
                        xp=jnp)
    want_np = jsf.mi_stats(ctab, ox, oy, xp=np)
    got = tsf.mi_stats(torch.from_numpy(ctab), torch.from_numpy(ox),
                       torch.from_numpy(oy))
    for w, wn, g in zip(want, want_np, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=0)
        np.testing.assert_allclose(g.numpy(), wn, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_mi_stats_unsigned_matches_jax():
    ctab, ox, oy = _tables(5, 200, 3, 9, True)
    want = jsf.mi_stats(ctab, ox, oy, signed=False, xp=np)
    got = tsf.mi_stats(torch.from_numpy(ctab), torch.from_numpy(ox),
                       torch.from_numpy(oy), signed=False)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-12, atol=0)
    assert (got[0].numpy() >= 0).all()


@pytest.mark.parametrize("with_z", [False, True])
def test_sufficient_power_matches_jax(with_z):
    rng = np.random.default_rng(3)
    lx = rng.integers(0, 4, 500)
    ly = rng.integers(0, 4, 500)
    lz = rng.integers(0, 10, 500) if with_z else None
    n_obs = rng.integers(0, 200, 500).astype(np.float64)
    want = jsf.sufficient_power(lx, ly, n_obs, 5, levels_z=lz, xp=np)
    got = tsf.sufficient_power(
        torch.from_numpy(lx), torch.from_numpy(ly), torch.from_numpy(n_obs), 5,
        levels_z=None if lz is None else torch.from_numpy(lz))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mi_pval_and_thresholds_match_jax():
    rng = np.random.default_rng(11)
    mi = rng.normal(0, 0.02, 5000)
    df = rng.integers(-1, 9, 5000)
    n_obs = rng.integers(0, 9000, 5000).astype(np.float64)
    np.testing.assert_array_equal(tsf.mi_pval(mi, df, n_obs),
                                  jsf.mi_pval(mi, df, n_obs))
    for alpha in (0.01, 0.05):
        np.testing.assert_array_equal(tsf.chi2_g_threshold(alpha, 40),
                                      jsf.chi2_g_threshold(alpha, 40))


def test_fz_pval_matches_jax():
    rng = np.random.default_rng(12)
    r = rng.uniform(-0.999, 0.999, 2000)
    n = rng.integers(2, 500, 2000)
    np.testing.assert_array_equal(tsf.fz_pval(r, n, 1), jsf.fz_pval(r, n, 1))


@pytest.mark.parametrize("m", [None, 4000])
def test_benjamini_hochberg_matches_jax(m):
    rng = np.random.default_rng(13)
    p = rng.random(3000) ** 6
    p[rng.random(3000) < 0.1] = np.nan
    p[:50] = p[50]                                    # exact ties
    np.testing.assert_array_equal(tsf.benjamini_hochberg(p, 0.01, m),
                                  jsf.benjamini_hochberg(p, 0.01, m))


def _cor_submatrices(seed, B, m):
    """Random positive-definite (B, m, m) correlation matrices."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, 3 * m))
    A[:, 1] += 0.8 * A[:, 0]                  # X and Y correlated
    cov = A @ np.swapaxes(A, 1, 2)
    d = np.sqrt(np.einsum("bii->bi", cov))
    return cov / (d[:, :, None] * d[:, None, :])


@pytest.mark.parametrize("max_k", [0, 1, 2, 3])
def test_pcor_dp_matches_jax(max_k):
    """Same numpy code on both sides: bit-equal for every k in 0..max_k."""
    C = _cor_submatrices(30 + max_k, 2000, max_k + 2)
    kvec = np.random.default_rng(max_k).integers(0, max_k + 1, 2000)
    got = tsf.pcor_dp(C, kvec, max_k, xp=np)
    want = jsf.pcor_dp(C, kvec, max_k, xp=np)
    np.testing.assert_array_equal(got, want)
    assert (np.abs(got) <= 1.0).all() and np.abs(got).max() > 0.3


def test_pcor_iterative_matches_jax():
    rng = np.random.default_rng(40)
    data = rng.normal(size=(200, 6))
    data[:, 1] += data[:, 0] + data[:, 2]
    for Zs in ((), (2,), (2, 3), (2, 3, 4)):
        assert tsf.pcor_iterative(0, 1, Zs, data) == jsf.pcor_iterative(
            0, 1, Zs, data)
