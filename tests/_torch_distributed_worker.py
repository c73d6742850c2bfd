"""Worker program for the 2-process CPU check of the PyTorch port's
multi-process mesh.

Launched by tests/test_torch_distributed.py with the FLASHWEAVE_* variables;
refuses to import jax, jaxlib and flashweave_tpu, joins the gloo process
group (``parallel.distributed.initialize_from_env``), builds the global mesh
from two CPU shards a process (four shards), and runs the univariate pass,
a mi_nz conditional batch, an fz batch and a multi_il LGL with a time limit
and convergence (the rank-0 broadcast clock) through the sharded paths.
Every process writes its results to ``FLASHWEAVE_TEST_OUT.rank<r>.npz``.
"""

import os
import sys


class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flashweave_tpu"):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, _NoJax())
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from flashweave_tpu_torch.learning.lgl import LGL  # noqa: E402
from flashweave_tpu_torch.ops import univariate as uv  # noqa: E402
from flashweave_tpu_torch.ops.condtests import CondTestEngine  # noqa: E402
from flashweave_tpu_torch.parallel.distributed import (  # noqa: E402
    initialize_from_env, process_count, process_index)
from flashweave_tpu_torch.parallel.mesh import get_mesh  # noqa: E402
from flashweave_tpu_torch.utils.misc import get_levels, get_max_vals  # noqa: E402


def main():
    out_path = os.environ["FLASHWEAVE_TEST_OUT"]
    assert initialize_from_env(backend="gloo"), "FLASHWEAVE_* variables missing"
    assert process_count() == 2, process_count()
    rank = process_index()
    mesh = get_mesh(devices=["cpu"] * 2)
    assert (mesh.size, mesh.first) == (4, 2 * rank), (mesh.size, mesh.first)

    # tests/test_distributed.py's construction
    rng = np.random.default_rng(3)
    n, p = 128, 96
    base = rng.integers(0, 3, (n, p // 4)).astype(np.int8)
    data = np.repeat(base, 4, axis=1)
    flip = rng.random((n, p)) < 0.4
    data = np.where(flip, rng.integers(0, 3, (n, p), dtype=np.int8),
                    data).astype(np.float64)
    lv, mx = get_levels(data), get_max_vals(data)

    nbrs = uv.pw_univar_neighbors(data, "mi_nz", alpha=0.05, n_obs_min=10,
                                  levels=lv, max_vals=mx, mesh=mesh,
                                  device="cpu")
    pairs = sorted(
        (T, Y, st, pv) for T, d in nbrs.items() for Y, (st, pv) in d.items()
        if T < Y
    )

    engine = CondTestEngine(data, "mi_nz", 3, levels=lv, max_vals=mx,
                            hps=5, n_obs_min=10, mesh=mesh, device="cpu")
    B = 300
    X = rng.integers(0, p, B).astype(np.int32)
    Y = (X + 1 + rng.integers(0, p - 1, B).astype(np.int32)) % p
    Zs = rng.integers(0, p, (B, 3)).astype(np.int32)
    kv = rng.integers(0, 4, B).astype(np.int32)
    stat, pval, df, suff = engine.mi_tests_raw(X, Y, Zs, kv)

    cont = np.where(data > 0, np.log1p(data), 0.0)
    eng_fz = CondTestEngine(cont, "fz", 3, hps=5, n_obs_min=10, mesh=mesh,
                            device="cpu")
    assert eng_fz.cor_device
    fstat, fpval, _, _ = eng_fz.fz_tests_raw(X, Y, Zs, kv)

    # the multi-process clock: checkpoint and convergence decisions must
    # be the same on both processes, or their collectives would desync
    res = LGL(data, test_name="mi_nz", max_k=3, parallel="multi_il",
              time_limit=0.02, convergence_threshold=0.01, n_obs_min=10,
              verbose=False, device="cpu", mesh=mesh)
    net = np.array(sorted(res.graph.edges()), dtype=np.float64).reshape(-1, 3)

    np.savez(out_path + f".rank{rank}",
             pairs=np.array(pairs, dtype=np.float64).reshape(-1, 4),
             stat=stat, pval=pval, df=df, suff=suff, fstat=fstat,
             fpval=fpval, net=net)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
