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
the hand kernels), K8's launches (``univar_extract``) and the search layer's window counts
(``hiton.WINDOW_STATS``: speculative windows by kind; turbo windows tried,
on the turbo digest, held in full, lost to an interleaving rejection or an
elimination); then profiles the host side of a third LGL run and of one
univariate pass with cProfile and prints their largest entries.

    python3 profile_slice.py split mi_nz [n p]

splits the preparation of the table (host route and device route, each
part alone) and the univariate pass alone (its profiler ranges ``uv_*``:
host seconds, device ms and launches each; beside it the pass through
K8's plain version; cProfile), on the grouped table at 2048 x 98,304 by
default (phase 12's).
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
                "mi_turbo_digest": "mi_turbo_digest_kernel",
                "univar_extract": "mi_univar_extract_kernel"}


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
        if getattr(k, "is_user_annotation", False) or k.name in DIGESTS \
                or k.name.startswith("uv_"):
            continue        # a range's own span on the device's timeline
        c, t = by.get(k.name, (0, 0.0))
        by[k.name] = (c + 1, t + (k.time_range.end - k.time_range.start) / 1e3)
    rows = sorted(by.items(), key=lambda kv: -kv[1][1])
    return {"calls": sum(len(v) for v in calls.values()),
            "device_ms": sum(t for _, t in by.values()),
            "launches": sum(c for c, _ in by.values()),
            "op_tree": {"device_ms": tree[1], "launches": tree[0]},
            "by_kernel": [[k[:60], c, t] for k, (c, t) in rows[:top]]}


def synced(fn, dev):
    """(fn's result, its seconds), the card synchronised before and after."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def prepare_split(data, dev):
    """Seconds of the parts of the discrete table's preparation, on each of
    its two routes: the host route (``get_levels``, ``get_max_vals``, then
    ``state.from_numpy_state``'s max, cast, checks, upload, transpose and
    level marginals, each taken alone) and the device route (the table
    uploaded as it is, cast and checked on the card with one transfer of
    the verdict, the level marginals, levels and max_vals from them in one
    transfer), and ``lgl._device_levels`` whole."""
    import numpy as np

    from flashweave_tpu_torch.learning import lgl
    from flashweave_tpu_torch.ops.kernels import level_marginals
    from flashweave_tpu_torch.utils.misc import get_levels, get_max_vals

    out = {}
    host = {}
    _, host["get_levels"] = synced(lambda: get_levels(data), dev)
    _, host["get_max_vals"] = synced(lambda: get_max_vals(data), dev)
    _, host["max"] = synced(lambda: data.max(initial=0), dev)
    dint, host["cast"] = synced(lambda: data.astype(np.int8), dev)
    _, host["checks"] = synced(
        lambda: dint.min(initial=0) < 0 or not np.array_equal(dint, data), dev)
    t, host["upload"] = synced(lambda: torch.from_numpy(dint).to(dev), dev)
    _, host["transpose"] = synced(lambda: t.T.contiguous(), dev)
    L = int(data.max()) + 1
    _, host["level_marginals"] = synced(lambda: level_marginals(t, L), dev)
    out["host_route"] = host
    del t
    card = {}
    x, card["upload"] = synced(
        lambda: torch.from_numpy(np.ascontiguousarray(data)).to(dev), dev)

    def check():
        d8 = x.to(torch.int8)
        bad = (d8.to(x.dtype) != x).any() | (d8 < 0).any()
        return d8, torch.stack([bad.long(), d8.max().long()]).cpu()

    (d8, verdict), card["cast_and_check"] = synced(check, dev)
    marg, card["level_marginals"] = synced(
        lambda: level_marginals(d8, int(verdict[1]) + 1), dev)

    def levels():
        present = marg > 0
        lv = present.sum(0, dtype=torch.int32)
        top = torch.arange(marg.shape[0], device=dev, dtype=torch.int32)
        mx = torch.where(present, top[:, None], 0).amax(0)
        return torch.stack([lv, mx]).cpu()

    _, card["levels_transfer"] = synced(levels, dev)
    out["device_route"] = card
    del x, d8, marg
    _, out["device_levels_sec"] = synced(
        lambda: lgl._device_levels(data, dev), dev)
    torch.cuda.empty_cache()
    return out


def range_split(prof, prefix="uv_"):
    """Host seconds (the ranges' own durations, waits included), calls,
    device ms and launches of every profiler range named ``prefix...``."""
    events = prof.events()
    names = sorted({ev.name for ev in events if ev.name.startswith(prefix)
                    and ev.device_type.name == "CPU"})
    out = {}
    for name in names:
        spans = [ev for ev in events
                 if ev.name == name and ev.device_type.name == "CPU"]
        dev = range_kernels(events, name, top=4)
        out[name] = {"calls": len(spans),
                     "host_sec": sum(ev.time_range.end - ev.time_range.start
                                     for ev in spans) / 1e6,
                     "device_ms": dev["device_ms"],
                     "launches": dev["launches"],
                     "top": dev["by_kernel"]}
    return out


def split_main(test_name, n, p) -> int:
    """``profile_slice.py split TEST [n p]``: the preparation's parts
    (:func:`prepare_split`), then the univariate pass once to warm up,
    once timed alone, once through K8's plain version
    (``univar_extract_ref``, the extraction before K8), once under
    torch.profiler with its ranges split (:func:`range_split`: the block
    function, the extraction, the tally's transfer, the sort, BH, the
    transfer, the dicts) and once under cProfile."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import card_line, plain_extraction, synth_table
    from flashweave_tpu_torch.learning.lgl import _device_levels
    from flashweave_tpu_torch.ops import kernels as K
    from flashweave_tpu_torch.ops.univariate import pw_univar_neighbors

    group, seed = (8, 0) if p in (65_536, 98_304) else (5, 1)
    data = synth_table(n, p, group, seed=seed)
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    print("prepare " + json.dumps(prepare_split(data, dev)), flush=True)
    st = _device_levels(data, dev)[0]
    kw = dict(test_name=test_name, alpha=0.01, hps=5, n_obs_min=20, state=st)
    pw_univar_neighbors(data, **kw)                    # warm-up
    info = {}
    _, sec = synced(lambda: pw_univar_neighbors(data, info=info, **kw), dev)
    with plain_extraction():
        _, plain_sec = synced(lambda: pw_univar_neighbors(data, **kw), dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        K.reset_launch_counts()
        _, prof_sec = synced(lambda: pw_univar_neighbors(data, **kw), dev)
        launches = K.launch_counts()
    print("pass " + json.dumps({
        "test": test_name, "n": n, "p": p, "sec": sec, "info": info,
        "plain_extract_sec": plain_sec,
        "profiled_sec": prof_sec, "launches": launches,
        "ranges": range_split(prof)}), flush=True)
    prof_host = cProfile.Profile()
    t0 = time.perf_counter()
    prof_host.runcall(pw_univar_neighbors, data, **kw)
    print(f"univariate pass under cProfile: {time.perf_counter() - t0:.3f} s")
    text = io.StringIO()
    pstats.Stats(prof_host, stream=text).sort_stats("tottime").print_stats(12)
    print(text.getvalue(), flush=True)
    return 0


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

    if sys.argv[1] == "split":
        n, p = ((int(a) for a in sys.argv[3:5]) if len(sys.argv) > 3
                else (2048, 98_304))
        return split_main(sys.argv[2], n, p)
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
