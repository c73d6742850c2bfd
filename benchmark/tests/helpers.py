"""Tiny cells for the tests: the real cells' files at a small size, or a
new cell added as data only, in a temporary benchmark root."""

import copy
import json
import shutil
from pathlib import Path

from benchmark.spec import BENCH_DIR, REPO, load_cell

# enough samples that a group's pairs, jointly nonzero in ~5% of them at
# the cells' 90% zeros, reach n_obs_min
TINY = {"samples": 1200, "otus": 64}


def tiny(name, **size):
    """The real cell ``name`` with its table cut to a tiny size."""
    cell = load_cell(name)
    cell.config = dict(copy.deepcopy(cell.config), **dict(TINY, **size))
    return cell


def data_root(tmp: Path) -> Path:
    """A copy of BENCHMARK.json and the benchmark's data files under
    ``tmp`` (``tmp/BENCHMARK.json``, ``tmp/benchmark/...``)."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for kind in ("configs", "traffic", "workloads"):
        shutil.copytree(BENCH_DIR / kind, tmp / "benchmark" / kind)
    return tmp


def add_cell(tmp: Path, name, config, traffic, limits, config_body=None,
             traffic_body=None, metrics=()):
    """Add a cell to the data root ``tmp`` by files and entries only."""
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    bench = tmp / "benchmark"
    if config_body is not None:
        (bench / "configs" / f"{config}.json").write_text(
            json.dumps(config_body))
        spec["configs"].append({"name": config, "source": "test",
                                "file": f"benchmark/configs/{config}.json",
                                "reduced": [], "why": "test"})
    if traffic_body is not None:
        (bench / "traffic" / f"{traffic}.json").write_text(
            json.dumps(traffic_body))
    (bench / "workloads" / f"{name}.json").write_text(json.dumps(
        {"config": config, "traffic": traffic, "limits": limits}))
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": traffic, "chips": 1, "why": "test"})
    for m in spec["per_layer"]:
        if m["name"] in metrics:
            m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return load_cell(name, root=bench, repo=tmp)
