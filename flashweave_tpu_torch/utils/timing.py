"""Structured per-stage timing, the port's profiler spans and a
``torch.profiler`` hook.

PyTorch counterpart of ``flashweave_tpu/utils/timing.py``.  Device work is
queued asynchronously, so on a CUDA device every stage edge synchronises:
a stage's seconds then include the device work it enqueued, not just the
host's time to enqueue it.

A span (:func:`span`) is a ``torch.profiler`` range: one cheap call when no
profiler runs, and on the device trace's clock when one does.  Spans nest
on the host thread that opens them, so each one's parent is the span open
around it.  The stages are spans ``stage:<name>``; :func:`gc_spans` makes
each pause of the Python collector a span ``gc:<generation>``.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, Optional

import torch


def span(name: str):
    """A profiler range ``name`` (a context manager)."""
    return torch.profiler.record_function(name)


class _GcSpans:
    """A ``gc.callbacks`` hook: a span ``gc:<generation>`` from the start
    of each collection to its stop."""

    def __init__(self) -> None:
        self._open = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._open = span(f"gc:{info['generation']}")
            self._open.__enter__()
        elif self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None


@contextlib.contextmanager
def gc_spans():
    """The collector's pauses as spans while the block runs; the hook is
    removed whether the block returns or raises."""
    hook = _GcSpans()
    gc.callbacks.append(hook)
    try:
        yield
    finally:
        gc.callbacks.remove(hook)


class StageTimer:
    """Accumulates wall-clock seconds per named pipeline stage, each stage
    a span ``stage:<name>``.  On a CUDA device it also reads the device's
    memory peak (``torch.cuda.max_memory_allocated``, never reset here) at
    each stage edge and keeps, in ``peaks``, the mark of each stage inside
    which it rose."""

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self.device = device
        self.stages: Dict[str, float] = {}
        self.peaks: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        cuda = self.device is not None and self.device.type == "cuda"
        with span(f"stage:{name}"):
            if cuda:
                torch.cuda.synchronize(self.device)
                mark = torch.cuda.max_memory_allocated(self.device)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.synchronize(self.device)
                    peak = torch.cuda.max_memory_allocated(self.device)
                    if peak > mark:
                        self.peaks[name] = max(peak, self.peaks.get(name, 0))
                self.stages[name] = (
                    self.stages.get(name, 0.0) + time.perf_counter() - t0
                )

    def summary(self) -> str:
        total = sum(self.stages.values())
        lines = ["Stage timings:"]
        for name, secs in self.stages.items():
            frac = 100.0 * secs / total if total > 0 else 0.0
            peak = (f"  peak {self.peaks[name] / 2**30:.3f} GiB"
                    if name in self.peaks else "")
            lines.append(f"\t{name:<12} {secs:8.3f}s  ({frac:4.1f}%){peak}")
        lines.append(f"\t{'total':<12} {total:8.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(profile_dir: Optional[str]):
    """Record a ``torch.profiler`` trace (CPU and, when present, CUDA
    activity) into ``profile_dir/trace.json`` (no-op if falsy).  The file
    opens in Perfetto or chrome://tracing."""
    if not profile_dir:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
