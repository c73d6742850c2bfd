"""Nothing of the benchmark imports jax or the JAX package (whole
top-level names: ``flashweave_tpu_torch`` begins with ``flashweave_tpu``
and is allowed), the references import nothing of the port, and a run
that finds jax loaded prints no result."""

import ast
import subprocess
import sys

from benchmark import harness
from benchmark.spec import BENCH_DIR, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "flashweave_tpu"}


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not imported(f) & FORBIDDEN, f
    assert set(harness.FORBIDDEN) == FORBIDDEN


def test_references_import_nothing_of_the_port():
    for f in sorted((BENCH_DIR / "reference").rglob("*.py")):
        assert "flashweave_tpu_torch" not in imported(f), f
        assert imported(f) <= {"__future__", "contextlib", "math", "typing",
                               "numpy", "torch"}, f


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "flashweave_tpu_torch.fake", sys)
    assert "flashweave_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


SCRIPT = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "flashweave_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
from helpers import tiny
from benchmark.harness import run_cell, forbidden_modules
out = run_cell(tiny("otu98k-n8k.hef-k0"), 3, 0.1, False, "cpu", 0.0)
assert out["correct"] and forbidden_modules() == []
print("OK")
"""


def test_a_run_loads_no_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(REPO),
                          str(BENCH_DIR / "tests")], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("OK")
