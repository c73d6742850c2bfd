"""The PyTorch port must run without jax: a fresh interpreter that refuses
to import jax or jaxlib imports ``flashweave_tpu_torch`` and learns an
mi_nz network on the CPU."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"jax is blocked: {name}")
        return None

sys.meta_path.insert(0, _NoJax())

import numpy as np
import flashweave_tpu_torch as fwt

rng = np.random.default_rng(0)
base = rng.integers(0, 3, (200, 6))
data = np.repeat(base, 5, axis=1)
flip = rng.random(data.shape) < 0.3
data = np.where(flip, rng.integers(0, 3, data.shape), data).astype(float)
res = fwt.learn_network(data, sensitive=False, heterogeneous=True, max_k=3,
                        n_obs_min=20, verbose=False, device="cpu")
assert fwt.graph(res).n_edges() > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
assert not bad, bad
print("NOJAX_OK", fwt.graph(res).n_edges())
"""


def test_port_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout


def test_no_jax_import_in_port_sources():
    files = sorted((ROOT / "flashweave_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    pat = re.compile(r"^\s*(import|from)\s+jax(lib)?\b", re.M)
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits
