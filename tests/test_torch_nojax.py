"""The PyTorch port must run without jax and without the JAX package: a
fresh interpreter that refuses to import jax, jaxlib or ``flashweave_tpu``
imports ``flashweave_tpu_torch``, normalizes a table, learns mi_nz,
fz_nz and fz networks on the CPU (mi_nz also through the device window
digest, fz_nz also through the continuous one, fz on both conditioning
routes), saves and loads a network, and
runs the univariate pass of a 10-level table through the default block
function (K4's plain version) and the planes route (K3's, then
``mi_planes_stats``), both through the default device extraction.  A second
interpreter imports ``flashweave_tpu_torch.parallel`` (distributed, mesh,
scaling) and ``utils.testing`` the same way and runs the scaling harness on
a CPU mesh."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import os
import sys
import tempfile

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flashweave_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, _NoJax())

import numpy as np
import flashweave_tpu_torch as fwt

rng = np.random.default_rng(0)
base = rng.integers(0, 3, (200, 6))
data = np.repeat(base, 5, axis=1)
flip = rng.random(data.shape) < 0.3
data = np.where(flip, rng.integers(0, 3, data.shape), data).astype(float)
norm = fwt.normalize_data(data, test_name="fz_nz", verbose=False)
assert norm.data.shape == data.shape
nets = {}
for sensitive in (False, True):
    res = fwt.learn_network(data, sensitive=sensitive, heterogeneous=True,
                            max_k=3, n_obs_min=20, verbose=False,
                            device="cpu")
    g = fwt.graph(res)
    assert g.n_edges() > 0
    path = os.path.join(tempfile.mkdtemp(), "net.edgelist")
    fwt.save_network(path, res)
    back = fwt.load_network(path).graph
    assert sorted(back.edges()) == sorted(g.edges())
    print("NET", sensitive, g.n_edges())
    nets[sensitive] = sorted(g.edges())
from flashweave_tpu_torch.ops import condtests
# mi_nz through the window digest on the device
condtests.FORCE_DEV_DIGEST = True
res = fwt.learn_network(data, sensitive=False, heterogeneous=True, max_k=3,
                        n_obs_min=20, verbose=False, device="cpu")
condtests.FORCE_DEV_DIGEST = None
assert [e[:2] for e in sorted(fwt.graph(res).edges())] == [
    e[:2] for e in nets[False]]
print("NET dev_digest", fwt.graph(res).n_edges())
# fz_nz through the continuous window digest on the device
condtests.FORCE_CONT_DEV = True
res = fwt.learn_network(data, sensitive=True, heterogeneous=True, max_k=3,
                        n_obs_min=20, verbose=False, device="cpu")
condtests.FORCE_CONT_DEV = None
assert [e[:2] for e in sorted(fwt.graph(res).edges())] == [
    e[:2] for e in sorted(g.edges())]
print("NET cont_dev", fwt.graph(res).n_edges())
# fz, the default mode, on both of its conditioning routes
nets = []
for onfly in (False, True):
    condtests.FORCE_COR_ONFLY = onfly
    res = fwt.learn_network(data, sensitive=True, max_k=3, n_obs_min=20,
                            verbose=False, device="cpu")
    nets.append(sorted(fwt.graph(res).edges()))
condtests.FORCE_COR_ONFLY = False
assert nets[0] and [e[:2] for e in nets[0]] == [e[:2] for e in nets[1]]
print("NET fz", len(nets[0]))
from flashweave_tpu_torch.ops import univariate as U
base = rng.integers(0, 10, (800, 6))
ten = np.repeat(base, 5, axis=1)
flip = rng.random(ten.shape) < 0.3
ten = np.where(flip, rng.integers(0, 10, ten.shape), ten).astype(float)
kw = dict(test_name="mi", n_obs_min=20, device="cpu")
default = U.pw_univar_neighbors(ten, **kw)
planes = U.pw_univar_neighbors(ten, block_fn=U.mi_planes_block, **kw)
# the default route is the extraction: p-sorted dicts
from flashweave_tpu_torch.types import PSortedNbrs
assert all(isinstance(d, PSortedNbrs) for d in default.values())
assert [list(default[v]) for v in default] == [list(planes[v]) for v in planes]
assert sum(map(len, planes.values())) > 0
res = fwt.learn_network(ten, sensitive=False, normalize=False, max_k=1,
                        verbose=False, device="cpu")
print("PLANES", fwt.graph(res).n_edges())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flashweave_tpu"))
assert not bad, bad
print("NOJAX_OK")
"""


def test_port_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout
    assert "NET True" in proc.stdout and "NET False" in proc.stdout
    assert "NET fz" in proc.stdout
    assert "NET cont_dev" in proc.stdout
    assert "NET dev_digest" in proc.stdout
    assert "PLANES" in proc.stdout


def test_no_jax_import_in_port_sources():
    files = sorted((ROOT / "flashweave_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "profile_slice.py",
              ROOT / "kernel_levels.py"]
    pat = re.compile(r"^\s*(import|from)\s+(jax(lib)?|flashweave_tpu)\b(?!_)",
                     re.M)
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits


_PARALLEL = r"""
import sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flashweave_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, _NoJax())

import numpy as np
from flashweave_tpu_torch.parallel import distributed, mesh, scaling
from flashweave_tpu_torch.utils import testing

assert not distributed.initialize_from_env(backend="gloo")
assert distributed.process_count() == 1 and distributed.is_primary()
m = mesh.get_mesh(devices=["cpu"] * 4)
rng = np.random.default_rng(0)
data = rng.integers(0, 3, (120, 24)).astype(float)
data[:, 1] = data[:, 0]
res = scaling.univar_scaling(data, "mi_nz", device_counts=(1, 4), repeats=1,
                             device="cpu")
assert len({r["n_significant"] for r in res.values()}) == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flashweave_tpu"))
assert not bad, bad
print("PARALLEL_OK")
"""


def test_parallel_runs_with_jax_blocked():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("FLASHWEAVE_")}
    proc = subprocess.run([sys.executable, "-c", _PARALLEL], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PARALLEL_OK" in proc.stdout
