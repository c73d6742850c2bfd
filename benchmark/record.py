"""What one run recorded, as the metric readers (``metrics/<name>.py``)
see it, and the arithmetic they share.

A reader is ``read(run) -> float or None``; None leaves the metric out of
the result's line (it found nothing to read)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .spec import BENCH_DIR, load_json, load_module
from .tracing import Trace

GIB = float(1 << 30)


@dataclass
class Run:
    cell: object                    # spec.Cell
    networks: int                   # calls made in the window
    window_s: float                 # the calls' host seconds
    setup_s: float                  # process start to the first timed call
    peak_bytes: Optional[int]       # device memory peak over the window
    stages: List[Dict[str, float]]  # each call's StageTimer seconds
    counters: Dict[str, int]        # the port's counters over the window
    facts: dict                     # the table and the reference's counts
    device_kind: str = ""
    trace: Optional[Trace] = None
    extra: dict = field(default_factory=dict)

    def stage_mean(self, name: str) -> Optional[float]:
        """Mean seconds a call of the StageTimer stage ``name``, or None
        where no call entered it."""
        if not self.stages or not any(name in s for s in self.stages):
            return None
        return sum(s.get(name, 0.0) for s in self.stages) / len(self.stages)


def peaks(kind: str) -> Optional[dict]:
    """The published peaks of the card named ``kind`` (peaks.json)."""
    table = load_json(BENCH_DIR / "peaks.json")["devices"]
    for key, row in table.items():
        if key in kind:
            return row
    return None


def roofline_pct(run: Run, count: str) -> Optional[float]:
    """100 x the least time of the work of the launches of ``count``'s
    kernel that the trace holds, over their device time.

    The least time is the larger of the operations at the matching peak
    and the bytes at the memory bandwidth.  The profiler may lose launches,
    so the work counted is the window's work (one network's, times the
    calls) in the share of the port's launches that the trace holds."""
    if run.trace is None:
        return None
    mod = load_module("counts", count)
    held = [k for k in run.trace.in_window(run.trace.kernels)
            if mod.KERNEL in k.name]
    launched = run.counters.get(mod.COUNTER, 0)
    peak = peaks(run.device_kind)
    if not held or not launched or peak is None:
        return None
    w = mod.work(run.facts)
    share = min(len(held), launched) / launched * run.networks
    t_ops = w["ops"] * share / peak[w["peak"]] if w["peak"] else 0.0
    t_mem = w["bytes"] * share / peak["hbm_bytes_per_s"]
    busy = sum(k.end - k.start for k in held) / 1e6
    return 100.0 * max(t_ops, t_mem) / busy
