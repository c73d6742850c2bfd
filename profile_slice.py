#!/usr/bin/env python3
"""Where the time goes in a slice run of the PyTorch port on one CUDA card.

    python3 profile_slice.py mi|mi_nz|fz_nz|fz [n p [levels]]

Runs the slice LGL of ``chip_smoke.py`` (max_k=3, multi_il, 2048 x 10,000 by
default; a discrete table has 3 levels unless ``levels`` says otherwise,
e.g. ``profile_slice.py mi 2048 10000 12`` for phase 6; fz_nz and fz run on
log1p of the table, as phases 5 and 9 do; p = 65,536 and p = 98,304 take
bench.py's scale table, grouped by 8 from seed 0, as phases 8, 10 and 12 do,
so that ``profile_slice.py fz 2048 65536`` profiles phase 10 and
``profile_slice.py mi_nz 2048 98304`` phase 12a) once to warm up, then
once under ``torch.profiler`` and prints the stage seconds, the card's busy
share (CUDA kernel and copy time over wall time), the largest CUDA entries
by device time, each hand kernel's device ms and launches (K5,
``mi_cond_stats``, the conditional G-test of the mi window tests, K6,
``mi_window_digest``, the window digest's log p and reduction, and K7,
``mi_turbo_digest``, the turbo windows, beside K1-K4), the device work of
each window digest (the profiler ranges ``cont_digest``, ``mi_digest`` and ``turbo_digest``: calls, device ms,
launches, largest kernels; beside them the op tree's count, which misses
the hand kernels) and the search layer's window counts
(``hiton.WINDOW_STATS``: speculative windows by kind; turbo windows tried,
on the turbo digest, held in full, lost to an interleaving rejection or an
elimination); then profiles the host side of a third LGL run and of one
univariate pass with cProfile and prints their largest entries.
"""

from __future__ import annotations

import cProfile
import io
import json
import pstats
import sys
import time

import torch


DIGESTS = ("cont_digest", "mi_digest", "turbo_digest")


# each wrapper of ops/kernels.py and the name its kernels carry
KERNEL_NAMES = {"mi_univar_stats": "mi_univar_stats_kernel",
                "fz_nz_stats": "fz_nz_stats_kernel",
                "pair_ctab_planes": "mi_pair_ctabs_kernel",
                "mi_univar_stats_planes": "mi_univar_stats_planes_",
                "mi_cond_stats": "mi_cond_stats_kernel",
                "mi_window_digest": "mi_window_digest_",
                "mi_turbo_digest": "mi_turbo_digest_kernel"}


def hand_kernels(cuda, launches):
    """Device ms and profiler launches of each hand kernel of the library
    (``KERNEL_NAMES``; K4's count and epilogue kernels together, K6's tile
    and merge kernels together) beside the wrapper's own launch count
    ``launches`` (one K4 call may launch several sub-blocks, one K6 call
    two kernels)."""
    out = {}
    for name, calls in launches.items():
        hits = [e for e in cuda if KERNEL_NAMES[name] in e.key]
        out[name] = {"wrapper_launches": calls,
                     "kernel_launches": sum(e.count for e in hits),
                     "device_ms": sum(e.self_device_time_total
                                      for e in hits) / 1e3}
    return out


def range_kernels(events, name, top=12):
    """The device work under the profiler range ``name`` (a window digest's,
    ``DIGESTS``): its calls, device milliseconds and launches, and the
    largest (kernel, launches, ms).  A device activity (kernel, copy,
    memset) belongs to the range when the host call that launched it (its
    CUDA runtime event, matched by correlation id) ran inside one of the
    range's calls on the range's thread: the profiler links a kernel
    launched through ctypes (the hand kernels) to no PyTorch op, so the op
    tree alone misses them.  ``op_tree`` gives the device milliseconds and
    launches of the op tree alone (the kernels linked to a PyTorch op
    under the range's calls), the count that misses them."""
    import bisect

    calls = {}
    tree = [0, 0.0]

    def walk(ev):
        for k in ev.kernels:
            tree[0] += 1
            tree[1] += k.duration / 1e3
        for child in ev.cpu_children:
            walk(child)

    for ev in events:
        if ev.name == name and ev.device_type.name == "CPU":
            calls.setdefault(ev.thread, []).append(
                (ev.time_range.start, ev.time_range.end))
            walk(ev)
    for spans in calls.values():
        spans.sort()
    device = {ev.id: ev for ev in events if ev.device_type.name == "CUDA"}
    by = {}
    for ev in events:
        if (ev.device_type.name != "CPU" or not ev.name.startswith("cuda")
                or ev.id not in device or ev.thread not in calls):
            continue
        spans = calls[ev.thread]
        i = bisect.bisect_right(spans, (ev.time_range.start, float("inf"))) - 1
        if i < 0 or ev.time_range.start > spans[i][1]:
            continue
        k = device[ev.id]
        c, t = by.get(k.name, (0, 0.0))
        by[k.name] = (c + 1, t + (k.time_range.end - k.time_range.start) / 1e3)
    rows = sorted(by.items(), key=lambda kv: -kv[1][1])
    return {"calls": sum(len(v) for v in calls.values()),
            "device_ms": sum(t for _, t in by.values()),
            "launches": sum(c for c, _ in by.values()),
            "op_tree": {"device_ms": tree[1], "launches": tree[0]},
            "by_kernel": [[k[:60], c, t] for k, (c, t) in rows[:top]]}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: profile_slice.py needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import card_line, fznz_table, synth_table
    from flashweave_tpu_torch.learning import hiton
    from flashweave_tpu_torch.learning.lgl import LGL
    from flashweave_tpu_torch.ops import kernels as K
    from flashweave_tpu_torch.ops.univariate import pw_univar_neighbors
    from flashweave_tpu_torch.state import from_numpy_continuous, from_numpy_state
    from flashweave_tpu_torch.utils.timing import StageTimer

    test_name = sys.argv[1]
    n, p = (int(a) for a in sys.argv[2:4]) if len(sys.argv) > 2 else (2048, 10_000)
    levels = int(sys.argv[4]) if len(sys.argv) > 4 else 3
    continuous = test_name.startswith("fz")
    group, seed = (8, 0) if p in (65_536, 98_304) else (5, 1)
    data = (fznz_table(n, p, group, seed) if continuous
            else synth_table(n, p, group, seed=seed, levels=levels))
    dev = torch.device("cuda", 0)
    kw = dict(test_name=test_name, max_k=3, parallel="multi_il", time_limit=0.0,
              convergence_threshold=0.0, verbose=False, n_obs_min=20, device=dev)
    print(card_line(), flush=True)
    LGL(data, **kw)                                   # warm-up
    timer = StageTimer(dev)
    hiton.WINDOW_STATS = windows = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        LGL(data, stage_timer=timer, **kw)
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
    hiton.WINDOW_STATS = None
    # device-side entries only (kernels and copies): an aten:: op also
    # carries the device time of the kernels it launched, and a profiler
    # range (the digest's cont_digest) spans the kernels inside it on the
    # device's timeline
    cuda = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in cuda) / 1e6
    top = sorted(cuda, key=lambda e: -e.self_device_time_total)[:12]
    print(json.dumps({
        "test": test_name, "n": n, "p": p, "levels": levels, "wall_sec": wall,
        "stages": timer.stages, "device_busy_sec": busy,
        "device_busy_share": busy / wall,
        "top_device": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                       for e in top],
        "hand_kernels": hand_kernels(cuda, launches),
        "windows": windows,
        **{name: range_kernels(prof.events(), name) for name in DIGESTS}}),
        flush=True)

    def host_profile(what, fn, *args, top=10, **kwargs):
        prof_host = cProfile.Profile()
        t0 = time.perf_counter()
        prof_host.runcall(fn, *args, **kwargs)
        print(f"{what} under cProfile: {time.perf_counter() - t0:.3f} s")
        out = io.StringIO()
        pstats.Stats(prof_host, stream=out).sort_stats("tottime").print_stats(top)
        print(out.getvalue(), flush=True)

    host_profile("LGL", LGL, data, top=15, **kw)
    st = (from_numpy_continuous(data, dev) if continuous
          else from_numpy_state(data, None, None, dev))
    host_profile("univariate pass", pw_univar_neighbors, data, test_name=test_name,
                 alpha=0.01, hps=5, n_obs_min=20, state=st)
    return 0


if __name__ == "__main__":
    sys.exit(main())
