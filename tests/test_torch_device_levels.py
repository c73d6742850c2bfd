"""The device-levels route of the PyTorch port's LGL
(``learning.lgl._device_levels``: the discrete table uploaded once, cast
and checked on its device, levels and max_vals from its level marginals)
against the JAX package's ``flashweave_tpu.learning.lgl._device_levels``
and against ``get_levels`` / ``get_max_vals``, on the CPU.

Both return None on the same tables (a value negative, not an integer or
above 63); elsewhere the same int8 table, levels and max_vals.  A small
mi_nz LGL that takes the route equals the JAX package's network.
"""

import warnings

import numpy as np
import pytest
import torch

from flashweave_tpu.learning import lgl as jlgl
from flashweave_tpu_torch.learning import lgl as tlgl
from flashweave_tpu_torch.utils.misc import get_levels, get_max_vals


def _tables():
    rng = np.random.default_rng(4)
    nz3 = rng.integers(0, 3, (300, 40))
    nz3[rng.random(nz3.shape) < 0.6] = 0
    full = rng.integers(0, 64, (200, 70))
    full[:64, 0] = np.arange(64)                  # every level 0..63
    zeros = rng.integers(0, 4, (50, 9))
    zeros[:, 3] = 0
    return {
        "binary": rng.integers(0, 2, (120, 30)).astype(np.float64),
        "3-level nz": nz3.astype(np.float64),
        "8-level": rng.integers(0, 8, (150, 25)).astype(np.float64),
        "0..63": full.astype(np.float64),
        "n = 1": rng.integers(0, 5, (1, 12)).astype(np.float64),
        "a column of zeros": zeros.astype(np.float64),
        "float32": rng.integers(0, 6, (80, 20)).astype(np.float32),
        "float64": rng.integers(0, 6, (80, 20)).astype(np.float64),
        "int8": rng.integers(0, 3, (60, 10)).astype(np.int8),
        "uint16": rng.integers(0, 64, (60, 10)).astype(np.uint16),
        "uint32": rng.integers(0, 9, (60, 10)).astype(np.uint32),
        "uint64": rng.integers(0, 9, (60, 10)).astype(np.uint64),
    }


TABLES = _tables()
NONE_VALUES = [0.5, -1.0, 64.0, 127.0, 128.0, 300.0]


def _jax(data):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # numpy's cast of 300.0 to int8
        return jlgl._device_levels(data)


@pytest.mark.parametrize("name", list(TABLES))
def test_device_levels_match_jax(name):
    data = TABLES[name]
    want = _jax(data)
    got = tlgl._device_levels(data, "cpu")
    assert want is not None and got is not None
    state, levels, max_vals = got
    table, jlevels, jmax_vals = want
    np.testing.assert_array_equal(levels, jlevels)
    np.testing.assert_array_equal(max_vals, jmax_vals)
    np.testing.assert_array_equal(levels, get_levels(data))
    np.testing.assert_array_equal(max_vals, get_max_vals(data))
    assert state.data.dtype == torch.int8
    np.testing.assert_array_equal(state.data.numpy(), np.asarray(table))
    np.testing.assert_array_equal(state.dataT.numpy(), np.asarray(table).T)
    np.testing.assert_array_equal(state.levels_np, levels)
    np.testing.assert_array_equal(state.levels.numpy(), levels)
    np.testing.assert_array_equal(state.max_vals.numpy(), max_vals)
    assert state.L == int(max_vals.max()) + 1
    # the level marginals the state keeps are the table's
    for v in range(state.L):
        np.testing.assert_array_equal(state.marg[v].numpy(),
                                      (data == v).sum(axis=0))


@pytest.mark.parametrize("value", NONE_VALUES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_levels_none_where_jax_is_none(value, dtype):
    data = TABLES["8-level"].astype(dtype)
    data[7, 3] = value
    assert _jax(data) is None
    assert tlgl._device_levels(data, "cpu") is None


def test_device_levels_none_for_integer_tables_past_63():
    data = TABLES["8-level"].astype(np.int16)
    for value in (64, 127, 128, 300, -1):
        d = data.copy()
        d[0, 0] = value
        assert _jax(d) is None
        assert tlgl._device_levels(d, "cpu") is None


@pytest.mark.parametrize("dtype,values", [
    (np.uint16, (64, 128, 259, 300)),
    (np.uint32, (64, 259, 2 ** 16 + 5)),
    (np.uint64, (64, 259, 2 ** 32 + 5, 2 ** 63 + 5, 2 ** 64 - 1)),
])
def test_device_levels_none_for_unsigned_tables_past_63(dtype, values):
    """Unsigned tables (cast and checked on the host): None past 63, also
    where the int8 cast wraps a value onto 0..63 (259 -> 3)."""
    data = TABLES["8-level"].astype(dtype)
    for value in values:
        d = data.copy()
        d[0, 0] = value
        assert _jax(d) is None
        assert tlgl._device_levels(d, "cpu") is None


def test_lgl_takes_the_device_route_and_equals_jax(monkeypatch):
    """mi_nz, p = 60, single: the port's LGL takes the device route on
    the CPU (every call of _device_levels finds the table) and its network
    equals the JAX package's: the same edges, weights within rtol 1e-9."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, 3, (400, 12))
    data = np.repeat(base, 5, axis=1)
    flip = rng.random(data.shape) < 0.35
    data = np.where(flip, rng.integers(0, 3, data.shape), data)
    data = data.astype(np.float64)
    found = []
    levels_fn = tlgl._device_levels

    def recorded(*args, **kwargs):
        out = levels_fn(*args, **kwargs)
        found.append(out is not None)
        return out

    monkeypatch.setattr(tlgl, "_device_levels", recorded)
    kw = dict(test_name="mi_nz", max_k=3, parallel="single", verbose=False,
              time_limit=0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jlgl.LGL(data, **kw).graph
        got = tlgl.LGL(data, device="cpu", **kw).graph
    assert found == [True]
    we, ge = list(want.edges()), list(got.edges())
    assert len(we) > 20
    assert [(u, v) for u, v, _ in ge] == [(u, v) for u, v, _ in we]
    np.testing.assert_allclose([w for *_, w in ge], [w for *_, w in we],
                               rtol=1e-9, atol=0)
