#!/usr/bin/env python3
"""One LGL of the PyTorch port on one CUDA card at bench.py's scale cells.

    python3 lgl_scale.py mi_nz|fz_nz|fz P

Builds bench.py's scale table (``_synth_table(2048, P, 8, seed=0)``,
bench.py:265-271 as ``lgl_scale_bench`` builds it at :346; fz_nz and fz on
its log1p, in float64 as ``chip_smoke.py``'s phase 10) and runs ``LGL`` once
with bench.py's settings (max_k=3, multi_il, time_limit=0,
convergence_threshold=0, n_obs_min=20) through ``chip_smoke.phase_lgl``,
with the window digests at their defaults (on the card).  While it runs, a line every 60 s gives the seconds
so far, the conditional tests dispatched, the host's resident and peak
memory and the device memory allocated, so a run cut by a time limit
(``timeout 1800 python3 lgl_scale.py fz_nz 65536``) still says how far it
got.  At the end: the card line, then one JSON line with the stage seconds,
edges, tests dispatched, peak device bytes, the host's peak resident bytes,
the engine's route and window-method calls, the turbo windows by candidate
count and ``hiton.WINDOW_STATS``.
"""

from __future__ import annotations

import json
import sys
import threading
import time

import torch


def progress(stop: threading.Event, t0: float, every: float = 60.0):
    from chip_smoke import peak_rss_bytes, rss_bytes
    from flashweave_tpu_torch.ops import condtests as ct

    while not stop.wait(every):
        print("progress " + json.dumps({
            "sec": time.perf_counter() - t0,
            "cond_tests": ct.N_TESTS_DISPATCHED, "rss_bytes": rss_bytes(),
            "peak_rss_bytes": peak_rss_bytes(),
            "device_bytes": torch.cuda.memory_allocated()}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: lgl_scale.py needs a CUDA card")
    from chip_smoke import (card_line, fznz_table, peak_rss_bytes, phase_lgl,
                            synth_table)

    test_name, p = sys.argv[1], int(sys.argv[2])
    data = (fznz_table(2048, p, 8, seed=0) if test_name.startswith("fz")
            else synth_table(2048, p, 8, seed=0))
    print(card_line(), flush=True)
    stop = threading.Event()
    t0 = time.perf_counter()
    th = threading.Thread(target=progress, args=(stop, t0), daemon=True)
    th.start()
    try:
        out, _ = phase_lgl("cuda", data, test_name)
    finally:
        stop.set()
        th.join()
    out["peak_rss_bytes"] = peak_rss_bytes()
    print(card_line())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
