"""The kernels' work counts against hand-worked shapes."""

import numpy as np

from benchmark.spec import load_module


def facts(**kw):
    base = {"n": 4, "p": 3, "levels": 3, "test": "mi_nz",
            "table": np.zeros((4, 3), np.float32),
            "reference": {"pairs": 3, "powered": 2, "reliable": 2,
                          "candidates": 1}}
    base.update(kw)
    return base


def test_k1():
    w = load_module("counts", "k1").work(facts())
    # 3 pairs, (3-1)^2 = 4 joint counts over 4 samples, 2 ops each
    assert w["ops"] == 2 * 4 * 4 * 3
    assert w["bytes"] == 4 * 3 + 17 * 3
    assert w["peak"] == "int8_ops_per_s"


def test_k2_joint_nonzeros():
    table = np.array([[1, 2, 0],      # row: 2 nonzero -> 1 shared pair
                      [1, 1, 1],      # 3 nonzero -> 3
                      [0, 0, 5],      # 1 -> 0
                      [0, 0, 0]], np.float32)
    k2 = load_module("counts", "k2")
    assert k2.joint_nonzeros(table) == 4
    # the same by pairs: (0,1) rows 0,1; (0,2) row 1; (1,2) row 1
    w = k2.work(facts(table=table))
    assert w["ops"] == 7 * 4 + 4 * 3
    assert w["bytes"] == 8 * 4 * 3 + 12 * 3
    assert w["peak"] == "fp64_flops_per_s"


def test_k8_fronts():
    k8 = load_module("counts", "k8")
    mi = k8.work(facts())
    assert mi["ops"] == 0 and mi["peak"] is None
    assert mi["bytes"] == 3 + 16 * 2 + 24 * 1 + 800
    given = k8.work(facts(test="fz_nz"))
    assert given["bytes"] == 3 + 8 * 2 + 32 * 1 + 800
