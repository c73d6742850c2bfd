"""The StageTimer the benchmark hands ``LGL`` (``stage_timer=``).

It keeps the port's ``utils.timing.StageTimer`` interface (``stage(name)``,
``stages``) and behaviour (on a CUDA device each stage edge synchronises,
so a stage's seconds hold the device work it queued), and makes each
stage a profiler range ``stage:<name>``, so that a traced run can say what
the host was doing in an idle gap of the device."""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


class StageTimer:
    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.stages: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        with torch.profiler.record_function(f"stage:{name}"):
            self._sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._sync()
                self.stages[name] = (self.stages.get(name, 0.0)
                                     + time.perf_counter() - t0)
