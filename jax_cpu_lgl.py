#!/usr/bin/env python3
"""The JAX package's LGL on the CPU in float64, as a reference for the port.

    python3 jax_cpu_lgl.py

Builds bench.py's 10k-OTU table (``_synth_table(2048, 10000, 5)``,
bench.py:265-271, as ``lgl_bench`` builds it at :310) and runs
``flashweave_tpu``'s ``LGL`` with bench.py's settings (``lgl_run``,
bench.py:274-284: mi_nz, max_k=3, multi_il, time_limit=0,
convergence_threshold=0, n_obs_min=20) on the CPU under x64.
Off the TPU the JAX engine digests its windows on the host in float64
(``dev_digest`` off) and takes the turbo windows through its turbo digest
(``turbo_mxu``, on under x64), as the port's CPU runs do.  Prints one JSON
line: edges, conditional tests dispatched, seconds and stages.  This is a
tool of the reference, not of the port: it imports jax.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def main() -> int:
    from bench import _synth_table
    from flashweave_tpu.learning.lgl import LGL
    from flashweave_tpu.ops import condtests as ct
    from flashweave_tpu.utils.timing import StageTimer

    data = _synth_table(2048, 10_000, 5)
    ct.N_TESTS_DISPATCHED = 0
    timer = StageTimer()
    t0 = time.perf_counter()
    res = LGL(data, test_name="mi_nz", max_k=3, parallel="multi_il",
              time_limit=0.0, convergence_threshold=0.0, verbose=False,
              n_obs_min=20, stage_timer=timer)
    print(json.dumps(dict(
        n=2048, p=10_000, group=5, edges=res.graph.n_edges(),
        cond_tests=int(ct.N_TESTS_DISPATCHED),
        total_sec=time.perf_counter() - t0, stages=dict(timer.stages),
        backend=jax.default_backend(), x64=bool(jax.config.jax_enable_x64))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
