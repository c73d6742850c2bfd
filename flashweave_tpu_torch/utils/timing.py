"""Structured per-stage timing and a ``torch.profiler`` hook.

PyTorch counterpart of ``flashweave_tpu/utils/timing.py``.  Device work is
queued asynchronously, so on a CUDA device every stage edge synchronises:
a stage's seconds then include the device work it enqueued, not just the
host's time to enqueue it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


class StageTimer:
    """Accumulates wall-clock seconds per named pipeline stage."""

    def __init__(self, device: Optional[torch.device] = None) -> None:
        self.device = device
        self.stages: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.stages[name] = (
                self.stages.get(name, 0.0) + time.perf_counter() - t0
            )

    def summary(self) -> str:
        total = sum(self.stages.values())
        lines = ["Stage timings:"]
        for name, secs in self.stages.items():
            frac = 100.0 * secs / total if total > 0 else 0.0
            lines.append(f"\t{name:<12} {secs:8.3f}s  ({frac:4.1f}%)")
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
