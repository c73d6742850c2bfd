"""The benchmark of ``flashweave_tpu_torch``, the PyTorch and CUDA port.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA card it is
started on and prints one JSON line.  Everything that belongs to one
configuration, traffic mix, cell, metric, kernel count or reference sits in
a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json``, ``metrics/<metric>.py``, ``counts/<kernel>.py``
and ``reference/<test>.py``.  Nothing here imports jax or the JAX package.
"""

# host threads of a run's one process (torch's intra-op pool, OpenMP,
# BLAS): a fixed few, so that a run loads the shared host alike every time.
# ``run.py`` sets the variables before numpy or torch is imported.
THREADS = 4
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
