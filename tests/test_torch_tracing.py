"""The port's profiler spans (``utils.timing``): the stages, the parts of
prepare and of the graph assembly, the call's own spans and the
collector's pauses, each nested where it runs, on the calling thread;
the hook on ``gc.callbacks`` lasts one ``LGL`` call; the network does not
depend on whether a profiler runs."""

import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flashweave_tpu_torch.learning.lgl import LGL
from flashweave_tpu_torch.ops import univariate as uv
from flashweave_tpu_torch.utils import timing

CALLER = "test_caller"
STAGE = {"prep_convert": "stage:prepare", "prep_upload": "stage:prepare",
         "prep_check": "stage:prepare", "prep_levels": "stage:prepare",
         "asm_collect": "stage:postprocess", "asm_merge": "stage:postprocess",
         "asm_adj": "stage:postprocess", "lgl_order": "lgl",
         "lgl_release": "lgl"}
# fz_nz has no levels to check or count; the uint16 table of mi_nz is
# cast to int8 on the host, the float32 table of fz_nz to float64
SPANS = {"mi_nz": list(STAGE),
         "fz_nz": [s for s in STAGE if s not in ("prep_check", "prep_levels")]}


def _table(test_name):
    rng = np.random.default_rng(3)
    base = rng.integers(0, 3, (300, 8))
    data = np.repeat(base, 5, axis=1)
    flip = rng.random(data.shape) < 0.35
    data = np.where(flip, rng.integers(0, 3, data.shape), data)
    if test_name == "mi_nz":
        return data.astype(np.uint16)
    return np.log1p(data).astype(np.float32)


def _lgl(test_name, data=None, **kw):
    return LGL(_table(test_name) if data is None else data,
               test_name=test_name, max_k=0, verbose=False, device="cpu",
               n_obs_min=20, **kw)


def _traced(fn):
    """(fn's result, the profiler's events) with ``fn`` run inside the
    range ``CALLER``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(CALLER):
            out = fn()
    return out, prof.events()


def _parents(ev):
    out = []
    while ev.cpu_parent is not None:
        ev = ev.cpu_parent
        out.append(ev.name)
    return out


def _edges(graph):
    return sorted((u, v, w) for u, nb in graph.adj.items()
                  for v, w in nb.items())


@pytest.mark.parametrize("test_name", ["mi_nz", "fz_nz"])
def test_spans_nest_in_their_stage_and_the_call(test_name):
    _, events = _traced(lambda: _lgl(test_name))
    caller = [e for e in events if e.name == CALLER]
    assert len(caller) == 1
    thread = caller[0].thread
    for name in SPANS[test_name]:
        found = [e for e in events if e.name == name]
        assert found, name
        for e in found:
            assert e.thread == thread, name
            chain = _parents(e)
            assert chain[0] == STAGE[name], chain
            assert chain[-2:] == ["lgl", CALLER], chain
    for stage in ("stage:prepare", "stage:univariate", "stage:postprocess"):
        assert [_parents(e) for e in events if e.name == stage] == \
            [["lgl", CALLER]], stage


@pytest.mark.parametrize("test_name", ["mi_nz", "fz_nz"])
def test_graph_with_a_profiler_equals_the_graph_without(test_name):
    plain = _lgl(test_name).graph
    traced, _ = _traced(lambda: _lgl(test_name).graph)
    assert _edges(plain)
    assert _edges(traced) == _edges(plain)


@pytest.mark.parametrize("raises", [False, True])
def test_gc_hook_lasts_one_call(monkeypatch, raises):
    before = list(gc.callbacks)
    seen = []
    real = uv.pw_univar_neighbors

    def pass_(*args, **kw):
        seen.append(len(gc.callbacks))
        if raises:
            raise RuntimeError("the pass failed")
        return real(*args, **kw)

    monkeypatch.setattr(uv, "pw_univar_neighbors", pass_)
    if raises:
        with pytest.raises(RuntimeError, match="the pass failed"):
            _lgl("mi_nz")
    else:
        assert _edges(_lgl("mi_nz").graph)
    assert seen == [len(before) + 1]
    assert gc.callbacks == before


class _CollectingDict(dict):
    """Neighbour dicts whose walk forces a collection of generation 1."""

    def items(self):
        gc.collect(1)
        return super().items()


def test_collection_in_the_assembly_is_a_gc_span():
    data = _table("mi_nz")
    nbrs = _CollectingDict(uv.pw_univar_neighbors(
        data.astype(np.int64), test_name="mi_nz", n_obs_min=20,
        device="cpu"))
    res, events = _traced(lambda: _lgl("mi_nz", data, all_univar_nbrs=nbrs))
    assert _edges(res.graph)
    pauses = [_parents(e) for e in events if e.name == "gc:1"]
    assert ["asm_collect", "stage:postprocess", "lgl", CALLER] in pauses


def test_stage_timer_keeps_the_peak_of_the_stage_it_rose_in(monkeypatch):
    marks = iter([10, 50, 50, 50, 50, 80])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: next(marks) << 30)
    timer = timing.StageTimer(torch.device("cuda"))
    for name in ("prepare", "univariate", "postprocess"):
        with timer.stage(name):
            pass
    assert timer.peaks == {"prepare": 50 << 30, "postprocess": 80 << 30}
    text = timer.summary()
    assert "peak 50.000 GiB" in text and "peak 80.000 GiB" in text
    assert "univariate" in text and text.count("peak") == 2
