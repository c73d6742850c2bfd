"""The readers of the port's prepare, assembly and collector spans on a
synthetic trace: seconds a network inside each span (the collector's three
generations summed), None where the span is absent or the run untraced."""

import pytest

from benchmark import tracing
from benchmark.record import Run
from benchmark.spec import benchmark_spec, load_module
from helpers import tiny

READERS = {"prep_convert_s": "prep_convert", "prep_upload_s": "prep_upload",
           "asm_collect_s": "asm_collect", "asm_adj_s": "asm_adj"}


def ev(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def spans_trace():
    """Two networks, each the port's call with its stages and parts; one
    pause of each generation, each inside an assembly span; a span of each
    name on another thread and one outside the window."""
    events = [ev("bench_window", 0, 1000)]
    for t0 in (0, 500):
        events += [
            ev("network", t0, 400),
            ev("lgl", t0 + 5, 390),
            ev("stage:prepare", t0 + 10, 60),
            ev("prep_convert", t0 + 10, 20),
            ev("prep_upload", t0 + 30, 30),
            ev("stage:postprocess", t0 + 200, 150),
            ev("asm_collect", t0 + 200, 70),
            ev("asm_merge", t0 + 270, 10),
            ev("asm_adj", t0 + 280, 60),
        ]
    events += [ev("gc:0", 210, 4), ev("gc:1", 700, 6), ev("gc:2", 790, 10)]
    events += [ev(name, 0, 900, tid=2) for name in
               (*READERS.values(), "gc:0", "gc:1", "gc:2")]
    events += [ev("asm_adj", 2000, 10)]
    return tracing.Trace.from_events(events)


def run(trace, networks=2):
    return Run(cell=tiny("otu65k.hes-k0"), networks=networks, window_s=1.0,
               setup_s=1.0, peak_bytes=0, stages=[], counters={}, facts={},
               trace=trace)


@pytest.mark.parametrize("name,want", [
    ("prep_convert_s", 20e-6), ("prep_upload_s", 30e-6),
    ("asm_collect_s", 70e-6), ("asm_adj_s", 60e-6),
    # (4 + 6 + 10) us over 2 networks
    ("gc_s", 10e-6)])
def test_seconds_a_network(name, want):
    assert load_module("metrics", name).read(run(spans_trace())) == \
        pytest.approx(want)


@pytest.mark.parametrize("name", [*READERS, "gc_s"])
def test_none_where_the_span_is_absent(name):
    empty = tracing.Trace.from_events([ev("bench_window", 0, 100),
                                       ev("network", 0, 100)])
    mod = load_module("metrics", name)
    assert mod.read(run(empty)) is None
    assert mod.read(run(None)) is None
    assert mod.read(run(spans_trace(), networks=0)) is None


def test_collector_generations_are_summed():
    events = [ev("bench_window", 0, 100), ev("network", 0, 100),
              ev("gc:2", 10, 8)]
    gc_s = load_module("metrics", "gc_s")
    assert gc_s.read(run(tracing.Trace.from_events(events), networks=1)) \
        == pytest.approx(8e-6)
    assert gc_s.SPANS == ("gc:0", "gc:1", "gc:2")


def test_entries_read_program_spans_and_move_network_s():
    per_layer = {m["name"]: m for m in benchmark_spec()["per_layer"]}
    both = ["otu98k-n8k.hef-k0", "otu65k.hes-k0"]
    for name in [*READERS, "gc_s"]:
        m = per_layer[name]
        assert (m["source"], m["moves"], m["unit"]) == \
            ("program_span", "network_s", "s")
        assert m["workloads"] == (["otu65k.hes-k0"]
                                  if name == "prep_convert_s" else both)
    assert per_layer["asm_adj_s"]["layer"] == per_layer["prepare_s"]["layer"]
