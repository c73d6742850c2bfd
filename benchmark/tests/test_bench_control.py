"""The comparison fails what it must: the control (the reference in
float32, TF32 off, put in the program's place) and runs whose timed path
is broken underneath (an answer altered where it is produced, a pair's
answer left out, half of each block left out) come out not correct, at a
tiny size on the CPU; the same run unbroken comes out correct.  At the
cells' own size the control runs on the card (``benchmark/control.py``)."""

import numpy as np
import pytest
import torch

import flashweave_tpu_torch.ops.univariate as uv
from benchmark import compare as cmp
from benchmark.harness import reference_network, run_cell
from benchmark.tables import host_tables
from helpers import tiny

CELLS = ("otu98k-n8k.hef-k0", "otu65k.hes-k0")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(name, seed):
    cell = tiny(name, otus=128)
    tables, _ = host_tables(cell.config, cell.traffic, seed, "cpu")
    ref, _ = reference_network(cell, tables[0], "cpu")
    ctl, _ = reference_network(cell, tables[0], "cpu", torch.float32)
    reading = cmp.compare(ctl, ref)
    ok, checks = cmp.verdict([reading], cell.limits, 0)
    assert not ok
    assert reading["weight_gap"] > cell.limits["weight_gap"]


def strongest(stat, valid):
    """Index of the block's pair with the largest |statistic|."""
    s = torch.where(valid, stat.abs(), -1.0)
    return np.unravel_index(int(torch.argmax(s)), s.shape)


def break_mi(fault):
    orig = uv.mi_univar_stats

    def block(dataT, marg, levels, max_vals, start, tile, L, y_start=0,
              y_len=None, *rest):
        stat, df, n_obs, suff = orig(dataT, marg, levels, max_vals, start,
                                     tile, L, y_start, y_len, *rest)
        stat, suff = stat.clone(), suff.clone()
        q = stat.shape[1]
        valid = (torch.arange(start, start + tile)[:, None]
                 < torch.arange(y_start, y_start + q)[None, :]) & suff
        i, j = strongest(stat, valid)
        if fault == "altered":
            stat[i, j] *= 1 + 1e-6
        elif fault == "left_out":
            suff[i, j] = False
        else:
            suff[:, : q // 2] = False
        return stat, df, n_obs, suff

    return "mi_univar_stats", block


def break_fz(fault):
    orig = uv.fz_nz_stats

    def block(data, start, tile, y_start=0, y_len=None):
        r, N = orig(data, start, tile, y_start, y_len)
        r, N = r.clone(), N.clone()
        q = r.shape[1]
        valid = (torch.arange(start, start + tile)[:, None]
                 < torch.arange(y_start, y_start + q)[None, :]) & (N >= 20)
        i, j = strongest(r, valid)
        if fault == "altered":
            r[i, j] *= 1 + 1e-6
        elif fault == "left_out":
            N[i, j] = 0
        else:
            N[:, : q // 2] = 0
        return r, N

    return "fz_nz_stats", block


BREAK = {"otu98k-n8k.hef-k0": break_mi, "otu65k.hes-k0": break_fz}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [None, "altered", "left_out", "half"])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = tiny(name)
    if fault is not None:
        monkeypatch.setattr(uv, *BREAK[name](fault))
    out = run_cell(cell, 21, 0.1, False, "cpu", 0.0)
    assert out["correct"] is (fault is None), out["checks"]


def test_control_script_reads_both_sides(monkeypatch, capsys):
    """``control.py`` as it runs on the card, here at a tiny size (on the
    CPU where no card is visible): a program seed reads its two networks,
    a control seed reads the float32 reference against the float64 one."""
    import json

    from benchmark import control

    name = "otu98k-n8k.hef-k0"
    monkeypatch.setattr(control, "load_cell", lambda _: tiny(name))
    assert control.main(["--workload", name, "--program-seeds", "4",
                         "--control-seeds", "5"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(r["kind"], r.get("table")) for r in rows] == \
        [("program", 0), ("program", 1), ("control", None)]
    assert all(r["edges"] > 0 for r in rows)
    assert rows[0]["edge_diff"] == 0 and rows[1]["edge_diff"] == 0
    assert rows[2]["weight_gap"] > tiny(name).limits["weight_gap"]
