"""The table generator: values, groups, seeds, permutations, transform."""

import numpy as np
import pytest
import torch

from benchmark.tables import grouped_levels, host_tables, sparse_levels
from helpers import tiny


def test_levels_and_groups():
    gen = torch.Generator().manual_seed(3)
    t = grouped_levels(40000, 24, 8, 3, 0.35, 0.9, gen).numpy()
    assert t.dtype == np.int8 and t.shape == (40000, 24)
    assert set(np.unique(t)) == {0, 1, 2}
    # 90% zeros, the nonzero levels equally common
    share = np.bincount(t.ravel(), minlength=3) / t.size
    assert np.allclose(share, [0.9, 0.05, 0.05], atol=0.005)
    nz = t != 0
    # within a group two columns share a nonzero row where neither value
    # was redrawn and the base is nonzero, or by chance:
    # 0.65^2 0.1 + (1 - 0.65^2) 0.1^2
    both = (nz[:, 0] & nz[:, 1]).mean()
    assert abs(both - (0.4225 * 0.1 + 0.5775 * 0.01)) < 0.004
    # and agree on its level far more often than chance
    same = (t[:, 0] == t[:, 1])[nz[:, 0] & nz[:, 1]].mean()
    assert same > 0.85
    # across groups, by chance alone
    assert abs((nz[:, 0] & nz[:, 8]).mean() - 0.01) < 0.002
    assert abs((t[:, 0] == t[:, 8])[nz[:, 0] & nz[:, 8]].mean() - 0.5) < 0.05


@pytest.mark.parametrize("zero_share", [0.0, 0.5, 0.97])
def test_zero_share(zero_share):
    gen = torch.Generator().manual_seed(4)
    t = sparse_levels((200000,), 4, zero_share, gen).numpy()
    share = np.bincount(t, minlength=4) / t.size
    rest = (1 - zero_share) / 3
    assert np.allclose(share, [zero_share, rest, rest, rest], atol=0.005)


def test_seed_determines_tables():
    cell = tiny("otu98k-n8k.hef-k0")
    a, pa = host_tables(cell.config, cell.traffic, 2**31 + 77, "cpu")
    b, pb = host_tables(cell.config, cell.traffic, 2**31 + 77, "cpu")
    c, _ = host_tables(cell.config, cell.traffic, 2**31 + 78, "cpu")
    assert len(a) == 2 and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(np.array_equal(x, y) for x, y in zip(pa, pb))
    assert not np.array_equal(a[0], c[0])
    assert a[0].dtype == np.float32 and a[0].shape == (1200, 64)
    assert np.array_equal(pa[0], np.arange(64))
    assert sorted(pa[1]) == list(range(64)) and \
        not np.array_equal(pa[1], pa[0])
    assert np.array_equal(a[1], a[0][:, pa[1]])


def test_log1p_transform():
    cell = tiny("otu65k.hes-k0")
    (t, _), _ = host_tables(cell.config, cell.traffic, 5, "cpu")
    vals = np.unique(t)
    assert np.allclose(vals, np.log1p([0.0, 1.0, 2.0]).astype(np.float32))
