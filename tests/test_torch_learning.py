"""End-to-end: the PyTorch port's ``learn_network(..., device="cpu")``
against ``flashweave_tpu.learn_network`` on the same synthetic table.

single / single_il must give identical edge sets with weights within rtol
1e-9 (mi, mi_nz) or atol 2e-5 (fz_nz, see ``test_fz_nz_network_equals_jax``);
multi_il interleaves feed-forward mid-search, so its networks are compared
through the reference's tolerance model (as tests/test_learning.py does for
the JAX package).  The search-layer copies in the port must match their JAX
files except for the documented lines.
"""

import difflib
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import flashweave_tpu as fw
import flashweave_tpu_torch as fwt
from flashweave_tpu.utils.testing import compare_graph_results

ROOT = Path(__file__).resolve().parent.parent


def _synth_table(n, p, group, seed=1):
    """Grouped 3-level table, built like bench.py's synthetic LGL input."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 3, (n, p // group)).astype(np.int8)
    data = np.repeat(base, group, axis=1)
    flip = rng.random((n, p)) < 0.35
    data = np.where(flip, rng.integers(0, 3, (n, p), dtype=np.int8), data)
    return data.astype(np.float64)


@pytest.fixture(scope="module")
def table():
    return _synth_table(400, 60, 5)


def _both(data, sensitive=False, **kw):
    kw = dict(sensitive=sensitive, verbose=False, time_limit=0.0, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = fw.learn_network(data, **kw)
        got = fwt.learn_network(data, device="cpu", **kw)
    return fw.graph(want), fwt.graph(got)


@pytest.mark.parametrize("het,max_k,parallel", [
    (False, 0, "single"), (True, 0, "single"),
    (False, 3, "single"), (False, 3, "single_il"),
    (True, 3, "single"), (True, 3, "single_il"),
])
def test_network_equals_jax(table, het, max_k, parallel):
    want, got = _both(table, heterogeneous=het, max_k=max_k,
                      parallel_mode=parallel)
    we = list(want.edges())
    ge = list(got.edges())
    assert len(we) > 20
    assert [(u, v) for u, v, _ in ge] == [(u, v) for u, v, _ in we]
    np.testing.assert_allclose([w for *_, w in ge], [w for *_, w in we],
                               rtol=1e-9, atol=0)


@pytest.mark.parametrize("het", [False, True])
def test_multi_il_within_tolerance_model(table, het):
    want, got = _both(table, heterogeneous=het, max_k=3,
                      parallel_mode="multi_il")
    slack = (dict(approx_nbr_diff=22, approx_weight_meandiff=0.25) if not het
             else dict(approx_nbr_diff=4, approx_weight_meandiff=0.1))
    assert compare_graph_results(want, got, **slack)


@pytest.mark.parametrize("max_k,parallel", [
    (0, "single"), (3, "single"), (3, "single_il"),
])
def test_fz_nz_network_equals_jax(table, max_k, parallel):
    """fz_nz (``sensitive=True, heterogeneous=True``): identical edges.
    Weights are compared with atol 2e-5: the pcor DP rounds every
    numerator to 5 decimals (flashweave_tpu/ops/statfuns.py:295), so a
    last-bit difference in a masked correlation between torch and XLA can
    move a weight by one 1e-5 grid step."""
    want, got = _both(table, sensitive=True, heterogeneous=True,
                      max_k=max_k, parallel_mode=parallel)
    we = list(want.edges())
    ge = list(got.edges())
    assert len(we) > 20
    assert [(u, v) for u, v, _ in ge] == [(u, v) for u, v, _ in we]
    np.testing.assert_allclose([w for *_, w in ge], [w for *_, w in we],
                               rtol=0, atol=2e-5)


def test_fz_nz_multi_il_within_tolerance_model(table):
    want, got = _both(table, sensitive=True, heterogeneous=True, max_k=3,
                      parallel_mode="multi_il")
    assert got.n_edges() > 20
    assert compare_graph_results(want, got, approx_nbr_diff=4,
                                 approx_weight_meandiff=0.1)


def test_auto_mode_is_single_il(table):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = fwt.learn_network(table[:, :20], sensitive=False, max_k=1,
                                verbose=False, device="cpu")
    assert res.parameters["parallel"] == "single_il"


def test_cuda_device_raises_without_cuda(table, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fwt.learn_network(table, sensitive=False, verbose=False)


def test_default_mode_fz_equals_jax(table):
    """``learn_network(x, sensitive=True)`` with every other argument at
    its default is fz (FlashWeave-S, the API default), max_k 3, single_il:
    the JAX package's network, weights within atol 2e-5 (the pcor DP's
    grid)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = fwt.graph(fwt.learn_network(table, sensitive=True,
                                          verbose=False, device="cpu"))
        want = fw.graph(fw.learn_network(table, sensitive=True, verbose=False,
                                         parallel_mode="single_il"))
    ge, we = list(got.edges()), list(want.edges())
    assert len(we) > 20
    assert [(u, v) for u, v, _ in ge] == [(u, v) for u, v, _ in we]
    np.testing.assert_allclose([w for *_, w in ge], [w for *_, w in we],
                               rtol=0, atol=2e-5)


# lines each copy may differ in: its header docstring and the scheduler's
# multi-process probe
_ALLOWED = {
    "hiton.py": set(),
    "bnb.py": set(),
    "scheduler.py": {
        "import jax",
        "from ..parallel.distributed import process_count, process_index",
        "and jax.process_count() > 1)",
        "and process_count() > 1)",
        "if self._multiproc and jax.process_index() != 0:",
        "if self._multiproc and process_index() != 0:",
    },
}


# si_hiton_pc's device, (edited text, JAX text): each edit appears once in
# hiton.py, inside si_hiton_pc, and is undone before the copies are compared
_DEVICE_EDITS = [
    ('test_name: str = "mi", device="cuda",\n                **kwargs)',
     'test_name: str = "mi", **kwargs)'),
    ("cor_mat=cor_mat, device=device,", "cor_mat=cor_mat,"),
    ("n_obs_min=cfg.n_obs_min, device=device)", "n_obs_min=cfg.n_obs_min)"),
    ("cor_matrix(data, device=device).cpu(),\n                             "
     "dtype=np.float64)", "cor_matrix(data), dtype=np.float64)"),
]


def _undo_device_edits(src):
    head, fn = src.split("\ndef si_hiton_pc(", 1)
    fn, sep, tail = fn.partition("\ndef ")
    for edited, jax_text in _DEVICE_EDITS:
        assert src.count(edited) == 1 and fn.count(edited) == 1, edited
        fn = fn.replace(edited, jax_text)
    return head + "\ndef si_hiton_pc(" + fn + sep + tail


@pytest.mark.parametrize("test_name", ["mi_nz", "fz_nz", "fz"])
@pytest.mark.parametrize("T", [0, 13])
def test_si_hiton_pc_on_cpu_equals_jax(table, test_name, T):
    """The one-variable search on the CPU: the same PC set as the JAX
    package's ``si_hiton_pc``, stats and p-values within this file's
    tolerances (mi_nz rtol 1e-9; fz_nz and fz atol 2e-5, the pcor DP's
    grid)."""
    from flashweave_tpu.learning.hiton import si_hiton_pc as jax_si_hiton_pc
    from flashweave_tpu_torch.learning.hiton import si_hiton_pc

    data = table if test_name == "mi_nz" else np.log1p(table)
    want = jax_si_hiton_pc(T, data, test_name=test_name, max_k=3)
    got = si_hiton_pc(T, data, test_name=test_name, max_k=3, device="cpu")
    assert got.phase == want.phase == "F"
    assert list(got.state_results) == list(want.state_results)
    assert len(got.state_results) > 0
    tol = (dict(rtol=1e-9, atol=0) if test_name == "mi_nz"
           else dict(rtol=0, atol=2e-5))
    np.testing.assert_allclose(np.array(list(got.state_results.values())),
                               np.array(list(want.state_results.values())),
                               **tol)


@pytest.mark.parametrize("name", sorted(_ALLOWED))
def test_search_layer_copies_match_jax(name):
    jax_src = (ROOT / "flashweave_tpu" / "learning" / name).read_text()
    port_src = (ROOT / "flashweave_tpu_torch" / "learning" / name).read_text()
    assert port_src.startswith(f'"""Copy of ``flashweave_tpu/learning/{name}``')
    # the port's header paragraphs precede the JAX docstring's first line
    jax_body = jax_src[len('"""'):]
    body = port_src[port_src.index(jax_body.splitlines()[0]):]
    if name == "hiton.py":
        body = _undo_device_edits(body)
    diff = [
        line[1:].strip() for line in difflib.ndiff(
            jax_body.splitlines(), body.splitlines())
        if line[:1] in "+-" and line[1:].strip()
    ]
    assert set(diff) <= _ALLOWED[name], diff


def test_lgl_profile_dir_writes_trace(table, tmp_path):
    from flashweave_tpu_torch.learning.lgl import LGL

    data = table[:200, :20].astype(np.int64)
    res = LGL(data, test_name="mi", max_k=0, verbose=False, device="cpu",
              profile_dir=str(tmp_path))
    assert res.graph.n_nodes == 20
    assert (tmp_path / "trace.json").stat().st_size > 0
