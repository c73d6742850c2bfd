"""Two-process check of the PyTorch port's multi-process mesh (the port's
counterpart of tests/test_distributed.py).

Two OS processes join one gloo process group over localhost
(``flashweave_tpu_torch.parallel.distributed.initialize_from_env``), each
with two CPU shards, so the global mesh has four, and run the sharded
univariate pass, a mi_nz conditional batch, an fz batch and a multi_il LGL
(tests/_torch_distributed_worker.py, which refuses to import jax and the
JAX package).  Rank 0's univariate pairs and conditional raw results must
equal the single-process JAX reference of tests/test_distributed.py within
its tolerances (pairs rtol 1e-10; mi stat rtol 1e-10 / atol 1e-12, p rtol
1e-10, df and suff equal; fz stat rtol 1e-9 / atol 1e-12, p rtol 1e-9), and
equal the unmeshed port in one process exactly; both ranks must hold the
same results and the same network.  Each process gets 180 s: a hang fails
the test instead of holding the suite.
"""

import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_distributed_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _port_single_process():
    """The unmeshed port on the worker's data and batches."""
    from flashweave_tpu_torch.ops import univariate as uv
    from flashweave_tpu_torch.ops.condtests import CondTestEngine
    from flashweave_tpu_torch.utils.misc import get_levels, get_max_vals

    rng = np.random.default_rng(3)
    n, p = 128, 96
    base = rng.integers(0, 3, (n, p // 4)).astype(np.int8)
    data = np.repeat(base, 4, axis=1)
    flip = rng.random((n, p)) < 0.4
    data = np.where(flip, rng.integers(0, 3, (n, p), dtype=np.int8),
                    data).astype(np.float64)
    lv, mx = get_levels(data), get_max_vals(data)
    nbrs = uv.pw_univar_neighbors(data, "mi_nz", alpha=0.05, n_obs_min=10,
                                  levels=lv, max_vals=mx, device="cpu")
    pairs = sorted((T, Y, st, pv) for T, d in nbrs.items()
                   for Y, (st, pv) in d.items() if T < Y)
    engine = CondTestEngine(data, "mi_nz", 3, levels=lv, max_vals=mx, hps=5,
                            n_obs_min=10, device="cpu")
    B = 300
    X = rng.integers(0, p, B).astype(np.int32)
    Y = (X + 1 + rng.integers(0, p - 1, B).astype(np.int32)) % p
    Zs = rng.integers(0, p, (B, 3)).astype(np.int32)
    kv = rng.integers(0, 4, B).astype(np.int32)
    stat, pval, df, suff = engine.mi_tests_raw(X, Y, Zs, kv)
    cont = np.where(data > 0, np.log1p(data), 0.0)
    eng_fz = CondTestEngine(cont, "fz", 3, hps=5, n_obs_min=10, device="cpu")
    fstat, fpval, _, _ = eng_fz.fz_tests_raw(X, Y, Zs, kv)
    return (np.array(pairs, dtype=np.float64).reshape(-1, 4), stat, pval,
            df, suff, fstat, fpval)


def test_two_process_parity(tmp_path):
    out = str(tmp_path / "dist_out")
    port = _free_port()
    env_base = {k: v for k, v in os.environ.items()
                if not k.startswith(("JAX_", "XLA_", "FLASHWEAVE_"))}
    procs = []
    for rank in range(2):
        env = dict(env_base, FLASHWEAVE_COORDINATOR=f"127.0.0.1:{port}",
                   FLASHWEAVE_NUM_PROCESSES="2",
                   FLASHWEAVE_PROCESS_ID=str(rank), FLASHWEAVE_TEST_OUT=out,
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=180)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, o in zip(procs, outs):
        assert proc.returncode == 0, o.decode(errors="replace")[-4000:]
    r0 = np.load(out + ".rank0.npz")
    r1 = np.load(out + ".rank1.npz")
    for k in r0.files:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert len(r0["net"]) > 0

    from test_distributed import _reference_results

    exp_pairs, stat, pval, df, suff, fstat, fpval = _reference_results()
    exp_arr = np.array(exp_pairs, dtype=np.float64).reshape(-1, 4)
    assert r0["pairs"].shape == exp_arr.shape and len(exp_arr) > 0
    np.testing.assert_allclose(r0["pairs"], exp_arr, rtol=1e-10, atol=0)
    np.testing.assert_allclose(r0["stat"], stat, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(r0["pval"], pval, rtol=1e-10, atol=0)
    np.testing.assert_array_equal(r0["df"], df)
    np.testing.assert_array_equal(r0["suff"], suff)
    np.testing.assert_allclose(r0["fstat"], fstat, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(r0["fpval"], fpval, rtol=1e-9, atol=1e-300)

    for k, want in zip(("pairs", "stat", "pval", "df", "suff", "fstat",
                        "fpval"), _port_single_process()):
        np.testing.assert_array_equal(r0[k], want, err_msg=k)
