#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one cell,
at the cell's own size, in one process on the card.

    python3 benchmark/control.py --workload <cell> \
        --program-seeds 1,2,... --control-seeds 101,102,103

For each program seed: the cell's tables, one timed call (the window's
``LGL``) on each, each network read against the reference's as a run
reads it (the lower readings).  For each control seed: the reference
computed in float32 (TF32 off), the precision below the float64 the
configuration states, put in the program's place and read against the
float64 reference (the upper readings).  One JSON line a reading; the
benchmark's own runs never run this."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import compare as cmp  # noqa: E402
from benchmark.harness import (build_call, check_networks,  # noqa: E402
                               reference_network)
from benchmark.spec import load_cell  # noqa: E402
from benchmark.tables import host_tables  # noqa: E402
from benchmark.timer import StageTimer  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    args = ap.parse_args(argv)
    import torch

    cell = load_cell(args.workload)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        from flashweave_tpu_torch.ops import kernels

        kernels.load_library()
    call = build_call(cell, dev)
    for seed in args.program_seeds:
        t0 = time.perf_counter()
        tables, perms = host_tables(cell.config, cell.traffic, seed, dev)
        p = tables[0].shape[1]
        nets = [(k, cmp.graph_network(call(t, StageTimer(dev)).graph, p))
                for k, t in enumerate(tables)]
        readings, facts = check_networks(cell, nets, tables, perms, dev)
        for (k, net), r in zip(nets, readings):
            print(json.dumps({"kind": "program", "seed": seed, "table": k,
                              "edges": len(net[0]), **r, "facts": facts,
                              "s": time.perf_counter() - t0}), flush=True)
        del tables, nets
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        tables, _ = host_tables(cell.config, cell.traffic, seed, dev)
        ref, facts = reference_network(cell, tables[0], dev)
        t1 = time.perf_counter()
        ctl, _ = reference_network(cell, tables[0], dev, torch.float32)
        print(json.dumps({"kind": "control", "seed": seed,
                          "edges": len(ref[0]), "control_edges": len(ctl[0]),
                          **cmp.compare(ctl, ref), "facts": facts,
                          "reference_s": t1 - t0,
                          "s": time.perf_counter() - t0}), flush=True)
        del tables
    return 0


if __name__ == "__main__":
    sys.exit(main())
