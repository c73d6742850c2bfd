#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result's JSON object; the numbers that decide ``correct`` close standard
error.  The exit code is not 0, and nothing is printed to standard output,
where no card (or fewer than the cell asks for) is visible, where the port
is not in the checkout, or where jax or the JAX package was loaded."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import THREADS, THREAD_VARS  # noqa: E402

for var in THREAD_VARS:
    os.environ[var] = str(THREADS)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
