"""The port's copies of the JAX package's host modules (``types``,
``utils/misc``, ``utils/testing``, ``preprocessing``, ``io``, ``native``)
must stay the JAX files: the code below each module docstring is
identical apart from the lines listed here, and ``native/fast_dlm.cpp`` is
identical byte for byte.
A change to one of the JAX host modules must be copied over.  Their results
agree too: ``normalize_data`` gives the JAX package's matrix byte for byte in
all four modes, and ``save_network`` / ``load_network`` round-trip a
network."""

import ast
import difflib
import re
import warnings
from pathlib import Path

import numpy as np
import pytest

import flashweave_tpu as fw
import flashweave_tpu_torch as fwt

ROOT = Path(__file__).resolve().parent.parent

# lines each copy may differ in below its docstring
_ALLOWED = {
    "types.py": set(),
    # the profiler spans' helper (the spans themselves are undone first)
    "utils/misc.py": {"from .timing import span"},
    "utils/testing.py": set(),
    "preprocessing.py": set(),
    "io.py": set(),
    # the compiled parser goes into flashweave_tpu_torch/_build/
    "native/__init__.py": {
        '_BUILD = os.path.join(os.path.dirname(_DIR), "_build")',
        'so_path = os.path.join(_DIR, f"_fast_dlm_{tag}.so")',
        'so_path = os.path.join(_BUILD, f"_fast_dlm_{tag}.so")',
        'os.makedirs(_BUILD, exist_ok=True)',
    },
}


# the port's profiler spans in each copy, undone before the copies are
# compared: each ``with span("<name>"):`` line goes and its block moves
# back one level
_SPANS = {"utils/misc.py": ["asm_collect", "asm_merge", "asm_adj"]}


def _code(path: Path):
    """Source lines after the module docstring."""
    src = path.read_text()
    doc = ast.parse(src).body[0]
    assert isinstance(doc, ast.Expr) and isinstance(doc.value, ast.Constant)
    return src.splitlines()[doc.end_lineno:]


def _undo_spans(lines, names):
    out, found, block = [], [], None
    for line in lines:
        indent = len(line) - len(line.lstrip())
        if block is not None and line.strip() and indent <= block:
            block = None
        m = re.fullmatch(r'(\s*)with span\("(\w+)"\):', line)
        if m and block is None:
            found.append(m.group(2))
            block = len(m.group(1))
            continue
        out.append(line[4:] if block is not None and line.strip() else line)
    assert found == names, found
    return out


@pytest.mark.parametrize("rel", sorted(_ALLOWED))
def test_host_copy_matches_jax(rel):
    port = ROOT / "flashweave_tpu_torch" / rel
    assert port.read_text().startswith(
        f'"""Copy of ``flashweave_tpu/{rel}`` for the PyTorch port.')
    diff = [
        line[1:].strip() for line in difflib.ndiff(
            _code(ROOT / "flashweave_tpu" / rel),
            _undo_spans(_code(port), _SPANS.get(rel, [])))
        if line[:1] in "+-" and line[1:].strip()
    ]
    assert set(diff) <= _ALLOWED[rel], diff


def test_native_source_identical():
    rel = Path("native") / "fast_dlm.cpp"
    assert ((ROOT / "flashweave_tpu_torch" / rel).read_bytes()
            == (ROOT / "flashweave_tpu" / rel).read_bytes())


def _counts(n=120, p=40, seed=5):
    """Counts with ~50% zeros; neighbouring column pairs share a base."""
    rng = np.random.default_rng(seed)
    base = np.repeat(rng.poisson(4.0, (n, p // 2)), 2, axis=1)
    data = (base + rng.poisson(1.0, (n, p))).astype(np.float64)
    data[rng.random((n, p)) < 0.5] = 0.0
    return data


@pytest.mark.parametrize("test_name", ["mi", "mi_nz", "fz", "fz_nz"])
def test_normalize_data_equals_jax(test_name):
    data = _counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = fw.normalize_data(data, test_name=test_name, verbose=False)
        got = fwt.normalize_data(data, test_name=test_name, verbose=False)
    assert got.data.dtype == want.data.dtype
    assert got.data.tobytes() == want.data.tobytes()
    assert list(got.header or []) == list(want.header or [])


def test_save_load_network_round_trip(tmp_path):
    data = _counts(150, 20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = fwt.learn_network(data, sensitive=True, heterogeneous=True,
                                max_k=0, verbose=False, device="cpu")
    path = str(tmp_path / "net.edgelist")
    fwt.save_network(path, res)
    back = fwt.load_network(path)
    assert isinstance(back, fwt.FWResult)
    g, h = fwt.graph(res), fwt.graph(back)
    assert g.n_edges() > 0
    assert sorted(h.edges()) == pytest.approx(sorted(g.edges()))
    # the JAX package reads the port's file as the same network
    j = fw.graph(fw.load_network(path))
    assert sorted(j.edges()) == sorted(h.edges())
