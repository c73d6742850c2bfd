"""The traced run: ``torch.profiler`` over the measured window, and what
the metrics read from its trace.

The trace is exported as Chrome JSON to a fixed file inside the checkout
(``benchmark/_out/``) and read back: every kernel, copy and memset on the
device (the hand kernels, launched through ctypes, are linked to no
PyTorch op, so only the trace's device activities see them), and every
profiler range on the host thread that ran the window (the program's
``uv_*`` ranges, the benchmark's ``bench_window``, ``network`` around
each timed call and its StageTimer's ``stage:<name>``).  The device's busy
and idle time are taken over the timed calls.  Times are microseconds on
the trace's clock."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from .spec import BENCH_DIR

TRACE_DIR = BENCH_DIR / "_out"
WINDOW = "bench_window"
CALL = "network"        # one timed call of the window
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_CAT = "user_annotation"
BREAKDOWN_ENTRIES = 10

Interval = Tuple[float, float]


def start():
    """A running profiler of host and device activity."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def stop(prof, name: str) -> "Trace":
    """Stop ``prof``, export its trace to ``_out/<name>.trace.json`` and
    read it."""
    prof.__exit__(None, None, None)
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{name}.trace.json"
    prof.export_chrome_trace(str(path))
    return Trace.load(path)


@dataclass
class Op:
    name: str
    start: float
    end: float


@dataclass
class Trace:
    device_ops: List[Op] = field(default_factory=list)
    kernels: List[Op] = field(default_factory=list)
    ranges: List[Op] = field(default_factory=list)     # the window's thread
    window: Optional[Interval] = None
    calls: List[Interval] = field(default_factory=list)  # the timed calls

    @classmethod
    def load(cls, path: Path) -> "Trace":
        with open(path) as f:
            return cls.from_events(json.load(f).get("traceEvents", []))

    @classmethod
    def from_events(cls, events) -> "Trace":
        tr = cls()
        host: Dict[object, List[Op]] = {}
        window_tid = None
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat = str(ev.get("cat", "")).lower()
            op = Op(str(ev.get("name", "")), float(ev["ts"]),
                    float(ev["ts"]) + float(ev["dur"]))
            if cat in DEVICE_CATS:
                tr.device_ops.append(op)
                if cat == "kernel":
                    tr.kernels.append(op)
            elif cat == RANGE_CAT:
                tid = (ev.get("pid"), ev.get("tid"))
                host.setdefault(tid, []).append(op)
                if op.name == WINDOW:
                    tr.window = (op.start, op.end)
                    window_tid = tid
        tr.ranges = sorted(host.get(window_tid, []), key=lambda o: o.start)
        tr.calls = [(o.start, o.end) for o in tr.in_window(tr.ranges)
                    if o.name == CALL]
        tr.device_ops.sort(key=lambda o: o.start)
        tr.kernels.sort(key=lambda o: o.start)
        return tr

    def in_window(self, ops: List[Op]) -> List[Op]:
        if self.window is None:
            return []
        lo, hi = self.window
        return [o for o in ops if o.start >= lo and o.end <= hi]

    def busy(self) -> List[Interval]:
        """The union of the device's operations, clipped to the calls."""
        merged = merge([(o.start, o.end) for o in self.device_ops])
        return [iv for a, b in self.calls for iv in clip(merged, a, b)]

    def busy_seconds(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def window_seconds(self) -> float:
        """The traced window: the timed calls' host seconds (the harness's
        bookkeeping between two calls is no call's)."""
        return sum(b - a for a, b in self.calls) / 1e6

    def range_seconds(self, name: str) -> float:
        """Host seconds inside the window's calls of the range ``name``."""
        return sum(o.end - o.start for o in self.in_window(self.ranges)
                   if o.name == name) / 1e6

    def breakdown(self) -> dict:
        """The device operations with the most time by name (cut to
        ``NAME_CHARS``), and the device's idle time by what the host was
        doing: each gap split among the innermost ranges open on the host
        over it."""
        by_op: Dict[str, float] = {}
        for o in self.in_window(self.device_ops):
            name = short_name(o.name)
            by_op[name] = by_op.get(name, 0.0) + (o.end - o.start) / 1e6
        by_gap: Dict[str, float] = {}
        busy = self.busy()
        gaps = [g for call in self.calls
                for g in idle_gaps(clip(busy, *call), call)]
        for a, b, label in split_gaps(gaps, innermost(self.ranges)):
            by_gap[label] = by_gap.get(label, 0.0) + (b - a) / 1e6
        top = (lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]])
        return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


NAME_CHARS = 96


def short_name(name: str) -> str:
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def merge(intervals: List[Interval]) -> List[Interval]:
    """The union of intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(merged: List[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in merged
            if b > lo and a < hi]


def idle_gaps(busy: List[Interval], window: Interval) -> List[Interval]:
    """The parts of ``window`` that the disjoint sorted ``busy`` leaves."""
    gaps, t = [], window[0]
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if window[1] > t:
        gaps.append((t, window[1]))
    return gaps


def innermost(ranges: List[Op]) -> List[Op]:
    """The timeline of the innermost open range: ``ranges`` (one thread's,
    nested) cut into disjoint sorted pieces, each named after the deepest
    range that holds it; the window's own range reads ``harness`` (between
    the calls)."""
    out: List[Op] = []
    stack: List[Op] = []
    t = None

    def emit(upto):
        if stack and t is not None and upto > t:
            name = stack[-1].name
            out.append(Op("harness" if name == WINDOW else name, t, upto))

    for r in sorted(ranges, key=lambda o: (o.start, -o.end)):
        while stack and stack[-1].end <= r.start:
            emit(stack[-1].end)
            t = stack.pop().end
        emit(r.start)
        stack.append(r)
        t = r.start
    while stack:
        emit(stack[-1].end)
        t = stack.pop().end
    return out


def split_gaps(gaps: List[Interval], pieces: List[Op]):
    """(start, end, name) of each part of each gap (sorted, disjoint)
    under each piece of :func:`innermost`'s timeline; a part under none
    reads ``outside``."""
    out, i = [], 0
    for a, b in gaps:
        while i < len(pieces) and pieces[i].end <= a:
            i += 1
        t, j = a, i
        while t < b:
            if j < len(pieces) and pieces[j].start < b:
                p = pieces[j]
                if p.start > t:
                    out.append((t, p.start, "outside"))
                    t = p.start
                end = min(p.end, b)
                if end > t:
                    out.append((t, end, p.name))
                    t = end
                j += 1
            else:
                out.append((t, b, "outside"))
                t = b
    return out
