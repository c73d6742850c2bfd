"""Finding a cell and everything it names, by name, in the files of the
benchmark.

``BENCHMARK.json`` (at the root of the checkout) lists the configurations,
cells and metrics.  A cell's files:

- ``configs/<config>.json``: the deployment (the table's shape and how it
  is drawn, the guarantees);
- ``traffic/<traffic>.json``: the mix (the mode flags, ``max_k``, the
  ``LGL`` settings, the loop, the tables and their order, the transform);
- ``workloads/<cell>.json``: the cell's own limits of the comparison that
  decides ``correct``;
- ``metrics/<metric>.py``, ``counts/<kernel>.py``, ``reference/<name>.py``:
  modules loaded from their files (a name may hold ``.`` or ``-``).

A later cell, metric, count or reference is a new file and a new entry;
nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent

# FlashWeave's two mode flags and the test each selects
# (sensitive: continuous Fisher-z tests, else discrete mutual information;
# heterogeneous: the zero-adjusted "_nz" form)
TESTS = {(False, False): "mi", (False, True): "mi_nz",
         (True, False): "fz", (True, True): "fz_nz"}


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark_spec(repo: Path = REPO) -> dict:
    return load_json(repo / "BENCHMARK.json")


def load_module(kind: str, name: str, root: Path = BENCH_DIR):
    """The module ``<root>/<kind>/<name>.py``, loaded from its file (once a
    process) as ``benchmark.<kind>.<name>``."""
    key = f"benchmark.{kind}.{name}"
    mod = sys.modules.get(key)
    if mod is not None:
        return mod
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind}"
                                f" named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: Dict[str, float]  # workloads/<cell>.json
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports

    @property
    def test_name(self) -> str:
        mode = self.traffic["mode"]
        return TESTS[(bool(mode["sensitive"]), bool(mode["heterogeneous"]))]

    @property
    def max_k(self) -> int:
        return int(self.traffic["max_k"])

    @property
    def reference(self) -> str:
        """The reference module's name: the traffic's ``reference``, else
        the test's name."""
        return self.traffic.get("reference", self.test_name)


# the loops the harness drives: (loop, clients)
LOOPS = {("closed", 1)}


def check_loop(traffic: dict, name: str) -> None:
    """Refuse a traffic mix whose loop the harness does not drive, rather
    than run it as another."""
    loop = (traffic.get("loop"), traffic.get("clients"))
    if loop not in LOOPS:
        raise ValueError(f"traffic/{name}.json asks for loop {loop[0]!r} "
                         f"with {loop[1]!r} clients; the harness drives "
                         f"only {sorted(LOOPS)}")


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load_cell(name: str, spec: Optional[dict] = None,
              root: Path = BENCH_DIR, repo: Path = REPO) -> Cell:
    spec = benchmark_spec(repo) if spec is None else spec
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = load_json(repo / conf["file"])
    traffic = load_json(root / "traffic" / f"{entry['traffic']}.json")
    own = load_json(root / "workloads" / f"{name}.json")
    if own.get("config") != entry["config"] or \
            own.get("traffic") != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json names another config or "
                         "traffic than BENCHMARK.json")
    check_loop(traffic, entry["traffic"])
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, ())]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic, limits=dict(own["limits"]), end_to_end=e2e,
                per_layer=layer)
