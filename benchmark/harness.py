"""One run of one cell: set-up, the measured window, the comparison with
the reference, the metrics, the result's line.

The window drives the port's entry, ``flashweave_tpu_torch.learning.lgl.
LGL``, on host numpy tables, as a closed loop of one client: a call as
soon as the one before it has returned, over the cell's tables in turn,
in whole rounds, until the calls have taken ``--seconds``; the last call
is let finish.  Each call is timed from the table on the host to the
returned network; between two calls the harness keeps the network as two
arrays for the check.  Set-up (process start to the first timed call)
finds or builds the kernels' library, makes the tables and learns one
network to warm up.  After the
window the device's peak is read, the program's state freed, and every
network the window returned is compared with the reference's network of
its table (``compare``)."""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, List

from . import THREADS
from . import compare as cmp
from .spec import BENCH_DIR, Cell, load_cell, load_module

# top-level module names the process that prints a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "flashweave_tpu")


class GcPauses:
    """The Python collector's pauses while installed: their count and
    seconds by generation (a note on standard error, no metric)."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._t = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.count[g] += 1
            self.seconds[g] += time.perf_counter() - self._t

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def note(self) -> dict:
        return {"count": self.count, "seconds": self.seconds}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def process_age() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def lgl_params(cell: Cell) -> dict:
    return dict(cell.traffic["lgl"])


def build_call(cell: Cell, device):
    """The timed call: ``call(table, timer)`` learns the cell's network of
    a host table through the port's ``LGL``, timed by ``timer``."""
    from flashweave_tpu_torch.learning.lgl import LGL

    kw = lgl_params(cell)

    def call(table, timer):
        return LGL(table, test_name=cell.test_name, max_k=cell.max_k,
                   device=device, stage_timer=timer, verbose=False, **kw)

    return call


def counters() -> Dict[str, int]:
    """The port's counters: each hand kernel's launches and the
    conditional tests dispatched."""
    from flashweave_tpu_torch.ops import condtests, kernels

    out = dict(kernels.launch_counts())
    out["tests_dispatched"] = int(condtests.N_TESTS_DISPATCHED)
    return out


def reference_network(cell: Cell, table, device, dtype=None):
    """((keys, weights), facts) of the reference's network of a host
    table, worked out on ``device``."""
    import torch

    mod = load_module("reference", cell.reference)
    t = torch.from_numpy(table).to(device)
    return mod.network(t, lgl_params(cell), dtype or torch.float64)


def check_networks(cell: Cell, nets, tables, perms, device):
    """(readings, facts): each returned network (table index, its
    ``compare.graph_network`` arrays, None where the call failed) read
    against the reference's network of its table."""
    import torch

    p = tables[0].shape[1]
    ref, facts = reference_network(cell, tables[0], device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    refs, seen, readings = {}, {}, []
    for k, net in nets:
        if net is None:
            continue
        sig = (k, net[0].tobytes(), net[1].tobytes())
        if sig not in seen:
            if k not in refs:
                refs[k] = ref if k == 0 else cmp.permuted(ref, perms[k], p)
            seen[sig] = cmp.compare(net, refs[k])
        readings.append(seen[sig])
    return readings, facts


def facts_of(cell: Cell, tables, ref_facts) -> dict:
    n, p = tables[0].shape
    levels = (int(tables[0].max()) + 1 if cell.test_name.startswith("mi")
              else None)
    return {"n": n, "p": p, "levels": levels, "table": tables[0],
            "test": cell.test_name, "reference": ref_facts}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_origin: float) -> dict:
    """One run of ``cell`` on ``device``; the result's object (with the
    run's ``record.Run`` under the key ``_run``)."""
    import torch

    from . import tracing
    from .record import Run
    from .tables import host_tables
    from .timer import StageTimer

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    marks = [("start", time.perf_counter())]
    if cuda:
        from flashweave_tpu_torch.ops import kernels

        kernels.load_library()
    marks.append(("library", time.perf_counter()))
    tables, perms = host_tables(cell.config, cell.traffic, seed, dev)
    if cuda:
        torch.cuda.empty_cache()
    marks.append(("tables", time.perf_counter()))
    call = build_call(cell, dev)
    call(tables[-1], StageTimer(dev))                 # warm-up
    marks.append(("warm-up", time.perf_counter()))
    gc.collect()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    c0 = counters()
    prof = tracing.start() if trace else None
    setup_s = time.perf_counter() - t_origin
    p = tables[0].shape[1]
    nets, stages, failed, window_s = [], [], 0, 0.0
    with torch.profiler.record_function(tracing.WINDOW), \
            GcPauses() as pauses:
        # whole rounds over the tables, until the calls have taken
        # ``seconds``; between two calls the harness keeps the returned
        # network as two arrays and lets the program's objects go, as a
        # user's process would, and that time is no call's
        while window_s < seconds or len(nets) % len(tables):
            k = len(nets) % len(tables)
            timer = StageTimer(dev)
            t_call = time.perf_counter()
            with torch.profiler.record_function(tracing.CALL):
                try:
                    graph = call(tables[k], timer).graph
                except Exception:       # a failed call counts, the loop goes on
                    log(traceback.format_exc())
                    failed += 1
                    graph = None
            secs = time.perf_counter() - t_call
            window_s += secs
            stages.append(dict(timer.stages, call=secs))
            nets.append((k, None if graph is None
                         else cmp.graph_network(graph, p)))
            del graph
    c1 = counters()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    tr = tracing.stop(prof, cell.name) if trace else None
    del call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    readings, ref_facts = check_networks(cell, nets, tables, perms, dev)
    check_s = time.perf_counter() - t2
    correct, checks = cmp.verdict(readings, cell.limits, failed)
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    run = Run(cell=cell, networks=len(nets), window_s=window_s,
              setup_s=setup_s, peak_bytes=peak, stages=stages,
              counters={k: c1[k] - c0[k] for k in c1},
              facts=facts_of(cell, tables, ref_facts), device_kind=kind,
              trace=tr, extra={
                  "check_s": check_s, "gc": pauses.note(),
                  "setup_parts": {"imports": marks[0][1] - t_origin, **{
                      name: t - marks[i][1]
                      for i, (name, t) in enumerate(marks[1:])}}})
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type, "kind": kind,
                   "count": cell.chips if cuda else 1,
                   "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(nets), "failed": failed,
           "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_seconds()
        device_info["window_s"] = tr.window_seconds()
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    out["_run"] = run
    return out


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def report(out: dict) -> None:
    """The run's notes and, last, each compared number beside its limit
    on standard error; the result's line on standard output."""
    run = out.pop("_run")
    log(f"card: {power_limit()}")
    log(f"networks {run.networks} in {run.window_s:.3f} s, set-up "
        f"{run.setup_s:.3f} s, check {run.extra['check_s']:.3f} s, "
        f"counters {json.dumps(run.counters)}")
    log("set-up parts (s): " + json.dumps(run.extra["setup_parts"]))
    log("collector pauses in the window (gen 0, 1, 2): "
        + json.dumps(run.extra["gc"]))
    for i, st in enumerate(run.stages):
        log(f"call {i}: " + " ".join(f"{k} {v:.4f}" for k, v in st.items()))
    if run.trace is not None:
        for path in sorted((BENCH_DIR / "counts").glob("k*.py")):
            mod = load_module("counts", path.stem)
            held = sum(mod.KERNEL in k.name
                       for k in run.trace.in_window(run.trace.kernels))
            log(f"trace {path.stem}: {held} launches held of "
                f"{run.counters.get(mod.COUNTER, 0)}")
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)


def main(argv, t0: float) -> int:
    args = parse(argv)
    origin = t0 - process_age()
    cell = load_cell(args.workload)
    if cell.chips == 1:
        # one process, one card: the port would mesh over every visible one
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    torch.set_num_threads(THREADS)

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " visible")
        return 3
    import flashweave_tpu_torch  # noqa: F401  (fails outside a checkout)

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   origin)
    bad = forbidden_modules()
    if bad:
        log(f"loaded in the process: {', '.join(bad)}; no result")
        return 4
    report(out)
    return 0
