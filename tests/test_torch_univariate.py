"""The fz_nz univariate pass of the PyTorch port against the JAX package's
(and fz's host path, at the end).

The same synthetic table (log1p of noisy counts, ~60% zeros, some
correlated columns) goes through ``flashweave_tpu.ops.univariate
.pw_univar_neighbors`` (x64, its host path through ``fz_nz_block``) and
through the port's (``device="cpu"``: K2's plain version, host condense,
float64 Fisher-z p-values, BH).  ``n_obs_min`` is set so that a part of the
pairs fails it.  Neighbor sets and their order must be identical; stats and
adjusted p-values agree within rtol 1e-10 (float64 on both sides, moment
sums in another order).
"""

import numpy as np
import pytest

from flashweave_tpu.ops.univariate import pw_univar_neighbors as jax_pw
from flashweave_tpu_torch.ops.univariate import pw_univar_neighbors


def _table(n=300, p=120, seed=3):
    rng = np.random.default_rng(seed)
    base = np.log1p(rng.poisson(4.0, (n, p)) + rng.random((n, p)))
    data = base.copy()
    data[:, 1::4] = 0.6 * base[:, 0::4] + 0.4 * base[:, 1::4]
    data[:, 2::4] = 0.8 * data[:, 1::4] + 0.2 * base[:, 2::4]
    data[rng.random((n, p)) < 0.6] = 0.0
    return data


@pytest.mark.parametrize("FDR,reliable", [(True, True), (True, False),
                                          (False, True)])
def test_fz_nz_pass_matches_jax(FDR, reliable):
    data = _table()
    kw = dict(test_name="fz_nz", alpha=0.01, n_obs_min=50, FDR=FDR,
              correct_reliable_only=reliable, tile=48)
    want, wres = jax_pw(data, return_result=True, **kw)
    got, gres = pw_univar_neighbors(data, return_result=True, device="cpu",
                                    **kw)
    # n_obs_min splits the pairs
    assert 0.2 < gres.suff_power.mean() < 0.9
    np.testing.assert_array_equal(gres.suff_power, wres.suff_power)
    assert sum(map(len, got.values())) > 40
    for v in range(data.shape[1]):
        assert list(got[v]) == list(want[v])
        if got[v]:
            np.testing.assert_allclose(np.array(list(got[v].values())),
                                       np.array(list(want[v].values())),
                                       rtol=1e-10, atol=0)
    np.testing.assert_array_equal(np.isnan(gres.pvals), np.isnan(wres.pvals))
    np.testing.assert_allclose(gres.stats, wres.stats, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("given_cor", [False, True])
def test_fz_host_path_matches_jax(given_cor):
    """fz's host path (``return_result=True``): the port's cor_matrix, or
    an explicit ``cor_mat`` (the JAX package's ``have_cor``), condensed,
    with scipy p-values and BH, against the JAX package's host path on the
    same table, ``n_obs_min`` above n for a part of the runs."""
    from flashweave_tpu_torch.ops.univariate import cor_matrix

    rng = np.random.default_rng(4)
    base = rng.normal(size=(300, 120))
    data = base.copy()
    data[:, 1::4] = 0.6 * base[:, 0::4] + 0.4 * base[:, 1::4]
    data[:, 2::4] = 0.8 * data[:, 1::4] + 0.2 * base[:, 2::4]
    data[:, 5] = 1.0                                   # zero variance
    for n_obs_min in (20, 400):
        kw = dict(test_name="fz", alpha=0.01, n_obs_min=n_obs_min, tile=48)
        if given_cor:
            kw["cor_mat"] = cor_matrix(data, device="cpu").numpy()
        want, wres = jax_pw(data, return_result=True, **kw)
        got, gres = pw_univar_neighbors(data, return_result=True,
                                        device="cpu", **kw)
        np.testing.assert_array_equal(gres.suff_power, wres.suff_power)
        np.testing.assert_array_equal(np.isnan(gres.pvals),
                                      np.isnan(wres.pvals))
        np.testing.assert_allclose(gres.stats, wres.stats, rtol=1e-12,
                                   atol=1e-14)
        assert [list(got[v]) for v in got] == [list(want[v]) for v in want]
        assert (sum(map(len, got.values())) > 40) == (n_obs_min == 20)
        if given_cor:
            # without return_result the dicts alone, in condensed order
            alone = pw_univar_neighbors(data, device="cpu", **kw)
            assert [list(alone[v].items()) for v in alone] == \
                [list(got[v].items()) for v in got]
