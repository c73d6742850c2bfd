"""Cells are found by name from their files; a cell added as data alone
(here an LGL cell, max_k 3) is found and its LGL call built and run on
the CPU without measuring; a measured run without a card fails."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark.harness import build_call, counters
from benchmark.spec import REPO, load_cell
from benchmark.tables import host_tables
from benchmark.timer import StageTimer
from helpers import add_cell, data_root


def test_real_cells():
    hef = load_cell("otu98k-n8k.hef-k0")
    hes = load_cell("otu65k.hes-k0")
    assert (hef.test_name, hef.max_k, hef.chips) == ("mi_nz", 0, 1)
    assert (hes.test_name, hes.max_k) == ("fz_nz", 0)
    assert hef.config["otus"] == 98304 and hef.config["samples"] == 8192
    assert hes.config["otus"] == 65536 and hes.config["samples"] == 2048
    assert hef.config["reduced"] == [] and hes.config["reduced"] == []
    e2e = {"network_s", "peak_device_gib", "setup_s"}
    assert {m["name"] for m in hef.end_to_end} == e2e
    layer = {m["name"] for m in hef.per_layer}
    assert "k1_roofline_pct" in layer and "k2_roofline_pct" not in layer
    layer = {m["name"] for m in hes.per_layer}
    assert "k2_roofline_pct" in layer and "k1_roofline_pct" not in layer
    assert all(m["moves"] == "network_s" for m in hef.per_layer)


def test_lgl_cell_added_as_data(tmp_path):
    root = data_root(tmp_path)
    cell = add_cell(
        root, "tiny.hef-k3", "tiny", "hef-k3", {"edge_diff": 0},
        config_body={"name": "tiny", "samples": 1200, "otus": 40,
                     "table": {"kind": "grouped", "levels": 3, "group": 5,
                               "noise": 0.35, "zero_share": 0.9,
                               "dtype": "float32"},
                     "reduced": []},
        traffic_body={"mode": {"sensitive": False, "heterogeneous": True},
                      "max_k": 3, "loop": "closed", "clients": 1,
                      "tables": 2, "transform": "none",
                      "reference": "mi_nz_lgl",
                      "lgl": {"parallel": "multi_il", "time_limit": 0.0,
                              "convergence_threshold": 0.0,
                              "n_obs_min": 20, "alpha": 0.01, "hps": 5}},
        metrics=("prepare_s",))
    assert (cell.test_name, cell.max_k, cell.reference) == \
        ("mi_nz", 3, "mi_nz_lgl")
    assert "prepare_s" in {m["name"] for m in cell.per_layer}
    tables, perms = host_tables(cell.config, cell.traffic, 9, "cpu")
    assert tables[0].shape == (1200, 40)
    c0 = counters()
    timer = StageTimer("cpu")
    graph = build_call(cell, "cpu")(tables[0], timer).graph
    assert graph.n_edges() > 0
    assert {"prepare", "univariate", "engine_init", "conditional",
            "postprocess"} <= set(timer.stages)
    assert counters()["tests_dispatched"] > c0["tests_dispatched"]


@pytest.mark.parametrize("loop", [{"loop": "open", "clients": 1},
                                  {"loop": "closed", "clients": 4},
                                  {}])
def test_loop_the_harness_does_not_drive_is_refused(tmp_path, loop):
    root = data_root(tmp_path)
    body = dict(load_cell("otu65k.hes-k0").traffic)
    for key in ("loop", "clients"):
        body.pop(key)
    body.update(loop)
    with pytest.raises(ValueError, match="harness drives only"):
        add_cell(root, "otu65k.x", "otu65k", "x", {"edge_diff": 0},
                 traffic_body=body)


def cli(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


ARGS = ("--workload", "otu98k-n8k.hef-k0", "--seed", "1", "--seconds", "1")


def test_measured_run_without_card_fails():
    res = cli(REPO, *ARGS)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA" in res.stderr


def test_checkout_without_the_port_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_out"))
    res = cli(tmp_path, *ARGS)
    assert res.returncode != 0 and res.stdout == ""
    assert not (tmp_path / "flashweave_tpu_torch").exists()
    assert np.all([p.suffix != ".so" for p in tmp_path.rglob("*")])
