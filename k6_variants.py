#!/usr/bin/env python3
"""K6's design choices on one CUDA card: the kernel as it stands against
builds of its source that each undo one choice.

    python3 k6_variants.py [--iters 20]

Inputs, built with this checkout's ``chip_smoke.py``: phase 2f's first case
(K5's results of 1,048,576 tests on the headline table, nz 2, in the
segments of ``segment_counts(1 << 20, 0)``) and the same tests all at df
27, the headline's longest chain (x = |stat| n_obs + 1e-4 n_obs, every
power check passed).

Variants, each a copy of ``csrc/mi_window_digest.cu`` and
``csrc/mi_digest.cuh`` under the git-ignored ``_build/k6_variants/`` with
one textual change (each must apply exactly once), built alone with the
library's nvcc flags, all started together:

- ``shipped``: the sources as they are (tile 2048, as ``k6_tile`` picks at
  this size, and ``shipped_tile1024``);
- ``libdevice``: the one-exp logsumexp step through libdevice's exp() and
  log() in place of ``mi_digest.cuh``'s ``core::`` main paths (the same
  bits);
- ``min_blocks_N``: ``__launch_bounds__``' blocks an SM N in place of 4,
  which sets the registers ptxas may give a thread (N = 2, 3, 5);
- ``no_chain``: each test's log p replaced by -x, so the run is the
  staging, the class sort, the segment reduction and the merge without the
  chains (its digest differs and is not held).

Each variant: ptxas's registers and spills of the tile kernel, equality
with the plain version (``condtests._mi_digest``) on both inputs, and the
mean of ``iters`` calls after warm-up by CUDA events (``ms``) and on the
device alone from torch.profiler (``device_ms``, both kernels).  The
shipped build runs first and again last, so drift on the card shows as a
difference between the two.  Prints the card line and one JSON line a
variant.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from flashweave_tpu_torch.ops import kernels as K  # noqa: E402

CHAIN = "xs[p] = d ? fw_digest::mi_logp_x(xs[p], d, lg) : 0.0;"
STEP = ("return __dadd_rn(m, core::log_main(__dadd_rn(1.0, "
        "core::exp_main(d))));")
BLOCKS = "constexpr int MIN_BLOCKS = 4;"

# name: (file, text, replacement), None for the sources as they are
VARIANTS = {
    "shipped": None,
    "libdevice": ("mi_digest.cuh", STEP,
                  "return __dadd_rn(m, log(__dadd_rn(1.0, exp(d))));"),
    "min_blocks_2": ("mi_window_digest.cu", BLOCKS,
                     BLOCKS.replace("4", "2")),
    "min_blocks_3": ("mi_window_digest.cu", BLOCKS,
                     BLOCKS.replace("4", "3")),
    "min_blocks_5": ("mi_window_digest.cu", BLOCKS,
                     BLOCKS.replace("4", "5")),
    "no_chain": ("mi_window_digest.cu", CHAIN,
                 "xs[p] = d ? -xs[p] : 0.0;"),
}
FILES = ("mi_digest.cuh", "mi_window_digest.cu")


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def build_all(base: Path) -> dict:
    """{name: (CDLL, nvcc log)}, every variant compiled at once."""
    procs = {}
    for name, change in VARIANTS.items():
        d = base / name
        d.mkdir(parents=True, exist_ok=True)
        for f in FILES:
            text = (K.SRC_DIR / f).read_text()
            if change and change[0] == f:
                if text.count(change[1]) != 1:
                    raise RuntimeError(f"{name}: {change[1]!r} is not in "
                                       f"{f} exactly once")
                text = text.replace(change[1], change[2])
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", str(d / "k6.so"),
             str(d / "mi_window_digest.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(base / name / "k6.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fw_mi_window_digest.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, i32, i32, i32,
            ctypes.c_double, ptr, ptr, ptr, ptr]
        lib.fw_mi_window_digest.restype = i32
        out[name] = (lib, log)
    return out


def launcher(lib, tests, counts, ends, B, NC, tile, log_alpha, lg):
    """(a call of the variant's K6 on the current stream, its output)."""
    stat, df, nobs, suff = tests
    tiles = -(-B // tile)
    scratch = torch.empty(tiles * K.K6_SCRATCH_TILE_BYTES, dtype=torch.uint8,
                          device="cuda")
    out = torch.empty((3, NC), dtype=torch.float64, device="cuda")

    def run():
        err = lib.fw_mi_window_digest(
            stat.data_ptr(), df.data_ptr(), nobs.data_ptr(), suff.data_ptr(),
            counts.data_ptr(), ends.data_ptr(), B, NC, 108, tile, log_alpha,
            lg.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K6 variant launch: CUDA error {err}")

    return run, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("k6_variants.py needs a CUDA card")
    smoke = load_smoke()
    print(smoke.card_line(), flush=True)
    libs = build_all(HERE / "_build" / "k6_variants")

    from flashweave_tpu_torch.state import from_numpy_state

    head = from_numpy_state(smoke.headline_table(), None, None, "cuda")
    tests = smoke.k5_outputs(head, smoke.k5_descriptors(98_304, 1 << 20,
                                                        seed=4), 2, "cuda")
    del head
    stat, df, nobs, suff = tests
    df27 = (stat.abs() + 1e-4, torch.full_like(df, 27), nobs,
            torch.ones_like(suff))
    counts_h = smoke.segment_counts(1 << 20, 0)
    B, NC = int(counts_h.sum()), len(counts_h)
    both = torch.from_numpy(np.stack([counts_h, np.cumsum(counts_h)])).cuda()
    counts, ends = both[0], both[1]
    lg = K._lgamma_table(108, "cuda")
    inputs = {"headline": tests, "df27": df27}
    want = {k: K.mi_window_digest_ref(*t, counts, B, smoke.LOG_ALPHA, 108)
            for k, t in inputs.items()}
    runs = [("shipped", 2048)] + [(n, 2048) for n in VARIANTS
                                  if n != "shipped"]
    runs += [("shipped", 1024), ("shipped", 2048)]
    for name, tile in runs:
        lib, log = libs[name]
        rep = smoke.ptxas_report(log).get("mi_window_digest")
        row = {"variant": name if tile == 2048 else f"{name}_tile{tile}",
               "tile": tile, "ptxas": rep}
        for what, t in inputs.items():
            run, out = launcher(lib, t, counts, ends, B, NC, tile,
                                smoke.LOG_ALPHA, lg)
            run()
            torch.cuda.synchronize()
            row[what] = {"equal": bool(torch.equal(out, want[what])),
                         "ms": smoke.time_ms(run, args.iters),
                         "device_ms": smoke.device_ms(run, args.iters)}
        print(json.dumps(row), flush=True)
    print(smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
