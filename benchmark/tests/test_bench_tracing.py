"""The trace's arithmetic: the union of overlapping device intervals, the
idle share, the gaps' labels, the roofline share."""

import pytest

from benchmark import tracing
from benchmark.record import Run, roofline_pct
from helpers import tiny


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def test_union_of_overlapping_intervals():
    assert tracing.merge([(5, 7), (0, 2), (1, 3), (3, 4), (6, 6.5)]) == \
        [(0, 4), (5, 7)]
    assert tracing.clip([(0, 4), (5, 7)], 1, 6) == [(1, 4), (5, 6)]
    assert tracing.idle_gaps([(1, 4), (5, 6)], (0, 10)) == \
        [(0, 1), (4, 5), (6, 10)]


def trace():
    return tracing.Trace.from_events([
        ev("user_annotation", "bench_window", 0, 100),
        ev("user_annotation", "network", 0, 50),
        ev("user_annotation", "stage:univariate", 0, 30),
        ev("user_annotation", "uv_fill", 20, 10),
        ev("user_annotation", "network", 50, 50),
        ev("user_annotation", "other thread", 0, 100, tid=2),
        ev("kernel", "void mi_univar_stats_kernel<3>(Block)", 0, 10),
        ev("kernel", "void mi_univar_stats_kernel<3>(Block)", 5, 10),
        ev("gpu_memcpy", "Memcpy HtoD", 12, 6),
        ev("gpu_memset", "Memset", 32, 8),
        ev("kernel", "mi_univar_extract_kernel", 60, 10),
        ev("kernel", "outside the window", 150, 10),
    ])


def test_busy_idle_and_labels():
    tr = trace()
    assert tr.window == (0, 100)
    assert tr.busy() == [(0, 18), (32, 40), (60, 70)]
    assert tr.busy_seconds() == pytest.approx(36e-6)
    assert tr.window_seconds() == pytest.approx(100e-6)
    assert tr.range_seconds("uv_fill") == pytest.approx(10e-6)
    b = tr.breakdown()
    ops = dict(b["device_ops"])
    assert ops["mi_univar_stats_kernel<3>(Block)"] == pytest.approx(2e-5)
    assert "outside the window" not in ops
    # the gaps 18-32 (2 us in stage:univariate outside uv_fill, 10 in
    # uv_fill, the innermost range there, 2 in the network after its
    # stage), 40-60 and 70-100 (in a network, outside its stages)
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"stage:univariate": 2e-6, "uv_fill": 10e-6, "network": 52e-6})


def test_innermost_timeline_and_harness_gaps():
    r = [tracing.Op("bench_window", 0, 100), tracing.Op("network", 10, 40),
         tracing.Op("a", 12, 20), tracing.Op("b", 20, 30),
         tracing.Op("network", 50, 90)]
    pieces = [(p.name, p.start, p.end) for p in tracing.innermost(r)]
    assert pieces == [("harness", 0, 10), ("network", 10, 12),
                      ("a", 12, 20), ("b", 20, 30), ("network", 30, 40),
                      ("harness", 40, 50), ("network", 50, 90),
                      ("harness", 90, 100)]
    parts = tracing.split_gaps([(5, 15), (35, 55), (95, 120)],
                               tracing.innermost(r))
    assert parts == [(5, 10, "harness"), (10, 12, "network"),
                     (12, 15, "a"), (35, 40, "network"),
                     (40, 50, "harness"), (50, 55, "network"),
                     (95, 100, "harness"), (100, 120, "outside")]


def test_roofline_share_scales_lost_launches():
    cell = tiny("otu98k-n8k.hef-k0", samples=1000, otus=64)
    run = Run(cell=cell, networks=2, window_s=1.0, setup_s=1.0,
              peak_bytes=0, stages=[], device_kind="NVIDIA H100 80GB HBM3",
              counters={"mi_univar_stats": 4, "univar_extract": 4},
              facts={"n": 1000, "p": 64, "levels": 3, "test": "mi_nz",
                     "table": None, "reference": {}}, trace=trace())
    # 2 of 4 launches held, 20 us of device time: half of two networks'
    # work, here bound by its bytes
    pairs = 64 * 63 // 2
    ops = 2 * 4 * 1000 * pairs
    nbytes = 1000 * 64 + 17 * pairs
    want = 100 * max(ops / 1.979e15, nbytes / 3.35e12) / 20e-6
    assert roofline_pct(run, "k1") == pytest.approx(want)
    run.trace = None
    assert roofline_pct(run, "k1") is None


def test_window_is_the_timed_calls():
    tr = tracing.Trace.from_events([
        ev("user_annotation", "bench_window", 0, 100),
        ev("user_annotation", "network", 0, 40),
        ev("user_annotation", "network", 60, 40),     # 40-60: the harness
        ev("kernel", "k", 30, 40),                    # runs across the gap
    ])
    assert tr.calls == [(0, 40), (60, 100)]
    assert tr.window_seconds() == pytest.approx(80e-6)
    assert tr.busy() == [(30, 40), (60, 70)]
    assert dict(tr.breakdown()["idle_gaps"]) == pytest.approx(
        {"network": 60e-6})
