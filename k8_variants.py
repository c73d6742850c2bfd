#!/usr/bin/env python3
"""K8's design choices on one CUDA card: the kernel as it stands against
builds of its source that each change one choice.

    python3 k8_variants.py [--iters 20]

Inputs, built with this checkout's ``chip_smoke.py``, 512 x 10,000 blocks
but the first: phase 2h's headline block (K1's outputs on the headline
table, 512 x 98,304, nz 2: df 1 alone); a binary block (K1 at L = 2, nz 0,
the path of learn_network's defaults: df 1); a 10-level block (K4, max_df
81); its block of a 12-level table of 2..12 levels a variable (K4's
outputs: df 1..121 mixed), as it lies and dealt by df (the most divergence
a warp of consecutive pairs meets); and its fz_nz block (K2's, the given
front).  Each input prints its lane use and the share of its tiles that
mix chain classes (``chip_smoke.k8_lane_use``, from the SASS counts of
this build).

Variants, each a copy of ``csrc/mi_univar_extract.cu`` and
``csrc/mi_digest.cuh`` under the git-ignored ``_build/k8_variants/`` with
textual changes (each must apply exactly once), built alone with the
library's nvcc flags, all started together:

- ``shipped``: the sources as they are;
- ``min_blocks_3``: ``__launch_bounds__``' blocks an SM 3 in place of 4,
  which lets ptxas give a thread 80 registers;
- ``always_sort``: a tile of one chain class sorted too, in place of
  its chains in tile order;
- ``never_sort``: every tile's chains in tile order, a lane a pair, as
  they lie (no class sort);
- ``no_chain``: each chain's log p replaced by -x, so the run is the
  staging, the class sort and the compaction without the chains (its
  candidates differ and are not held).

Each variant: ptxas's registers and spills, the blocks an SM holds,
equality with the plain version (``kernels.univar_extract_ref``: the tally
exactly, the candidates as a set bit for bit) on every input, and the mean
of ``iters`` calls after warm-up by CUDA events (``ms``) and on the device
alone from torch.profiler (``device_ms``; null where it lost launches).
The shipped build runs first and again last, so drift on the card shows as
a difference between the two.  Prints the card line and one JSON line a
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

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from flashweave_tpu_torch.ops import kernels as K  # noqa: E402

BLOCKS = "constexpr int MIN_BLOCKS = 4;"
CHAIN = "return fw_digest::mi_logp_x(x, df, lg);"
ONE_CLASS = "if (span[0] == span[1]) {"
SOURCE = "mi_univar_extract.cu"

# name: [(file, text, replacement), ...]
VARIANTS = {
    "shipped": [],
    "min_blocks_3": [(SOURCE, BLOCKS, BLOCKS.replace("4", "3"))],
    "always_sort": [(SOURCE, ONE_CLASS, "if (false) {")],
    "never_sort": [(SOURCE, ONE_CLASS, "if (true) {")],
    "no_chain": [(SOURCE, CHAIN, "return -x;")],
}
FILES = ("mi_digest.cuh", SOURCE)


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def build_all(base: Path) -> dict:
    """{name: (CDLL, nvcc log)}, every variant compiled at once."""
    procs = {}
    for name, changes in VARIANTS.items():
        d = base / name
        d.mkdir(parents=True, exist_ok=True)
        for f in FILES:
            text = (K.SRC_DIR / f).read_text()
            for file, old, new in changes:
                if file != f:
                    continue
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: {old!r} is not in {f} "
                                       "exactly once")
                text = text.replace(old, new)
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", str(d / "k8.so"),
             str(d / SOURCE)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(base / name / "k8.so"))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fw_univar_extract.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
            ctypes.c_double, i32, i32, ptr, ptr, i64, ptr, ptr, ptr, ptr, ptr,
            ptr, i32, ptr]
        lib.fw_univar_extract.restype = i32
        lib.fw_univar_extract_blocks_per_sm.argtypes = [ptr]
        lib.fw_univar_extract_blocks_per_sm.restype = i32
        out[name] = (lib, log)
    return out


def blocks_per_sm(lib) -> int:
    n = ctypes.c_int(0)
    if lib.fw_univar_extract_blocks_per_sm(ctypes.byref(n)):
        raise RuntimeError("K8 variant: the occupancy query failed")
    return n.value


def launcher(lib, grid, buf, front, outs, thresh, reliable, max_df):
    """A call of the variant's K8 on the current stream into ``buf`` (its
    tally zeroed first), as ``kernels.univar_extract`` makes it."""
    t, q = outs[0].shape
    if front == "mi":
        stat, df, nobs, suff = outs
        logp = None
    else:
        logp, stat, suff = outs
        df = nobs = None
    ptr = (lambda x: None if x is None else x.data_ptr())

    def run():
        buf.tally.zero_()
        err = lib.fw_univar_extract(
            0 if front == "mi" else 1, stat.data_ptr(), ptr(logp), ptr(df),
            ptr(nobs), suff.data_ptr(), int(suff.dim() == 0), t, q, 0, 0,
            float(thresh), int(reliable), int(max_df), buf.lg.data_ptr(),
            ptr(buf.edges), buf.cap, buf.tally.data_ptr(),
            buf.sched.data_ptr(), buf.X.data_ptr(), buf.Y.data_ptr(),
            buf.logp.data_ptr(), buf.stat.data_ptr(), grid,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K8 variant launch: CUDA error {err}")

    return run


def same(got, want) -> bool:
    """The tally exactly and the candidates as a set, bit for bit."""
    if not torch.equal(got.tally, want.tally):
        return False
    kept = int(want.tally[0])

    def key(buf):
        x, y, lp, st = buf.candidates(kept)
        k = x.long() * (1 << 32) + y.long()
        o = torch.argsort(k)
        return k[o], lp[o].view(torch.int64), st[o].view(torch.int64)

    return all(torch.equal(a, b) for a, b in zip(key(got), key(want)))


def inputs(smoke):
    """{name: (front, outs, max_df, pairs)} of the blocks."""
    from flashweave_tpu_torch.ops import univariate as U
    from flashweave_tpu_torch.state import (from_numpy_continuous,
                                            from_numpy_state)

    head = from_numpy_state(smoke.headline_table(), None, None, "cuda")
    out = {"headline": ("mi", K.mi_univar_stats(
        head.dataT, head.marg, head.levels, head.max_vals, 0, 512, head.L, 0,
        98_304, 2, 5.0, 20.0), 4, 98_304 * 98_303 // 2)}
    del head
    pairs = 10_000 * 9_999 // 2
    st = from_numpy_state(smoke.synth_table(2048, 10_000, 5, levels=2), None,
                          None, "cuda")
    out["binary"] = ("mi", K.mi_univar_stats(
        st.dataT, st.marg, st.levels, st.max_vals, 0, 512, st.L, 0, 10_000,
        0, 5.0, 20.0), 1, pairs)

    def k4(table, L):
        st = from_numpy_state(table, None, None, "cuda")
        return K.mi_univar_stats_planes(st.dataT, st.marg, st.levels,
                                        st.max_vals, 0, 512, L, 0, 10_000, 0,
                                        5.0, 20.0)

    out["levels_10"] = ("mi", k4(smoke.synth_table(2048, 10_000, 5,
                                                   levels=10), 10), 81, pairs)
    outs = k4(smoke.mixed_levels_table(2048, 10_000), 12)
    out["mixed"] = ("mi", outs, 121, pairs)
    out["mixed_dealt"] = ("mi", smoke.dealt_by_df(outs), 121, pairs)
    del st, outs
    table = from_numpy_continuous(smoke.fznz_table(2048, 10_000), "cuda")
    out["fz_nz"] = ("given", U._given_scores(
        K.fz_nz_stats(table, 0, 512, 0, 10_000), 20.0), 0, pairs)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("k8_variants.py needs a CUDA card")
    from flashweave_tpu_torch.ops.univariate import _extract_edges

    smoke = load_smoke()
    print(smoke.card_line(), flush=True)
    libs = build_all(HERE / "_build" / "k8_variants")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smoke.LOGP_OPS.update({c: v["ops"] for c, v in smoke.logp_call_ops(
        smoke.library_sass(K.load_library()[1].path)).items()})
    cases = inputs(smoke)
    for name, (front, outs, max_df, _) in cases.items():
        if front == "mi":
            print(json.dumps({"input": name, "lane_use": smoke.k8_lane_use(
                outs, 0, 0, max_df, K.K8_TILE)}), flush=True)
    bufs = {}
    for name, (front, outs, max_df, pairs) in cases.items():
        t, q = outs[0].shape
        edges = _extract_edges(0.01, pairs)
        want = K.ExtractBuffers(t * q, "cuda", edges, max_df)
        K.univar_extract_ref(want, front, outs, 0, 0, smoke.LOG_ALPHA, True,
                             max_df)
        bufs[name] = (want, K.ExtractBuffers(t * q, "cuda", edges, max_df))
    runs = list(VARIANTS) + ["shipped"]
    for name in runs:
        lib, log = libs[name]
        per_sm = blocks_per_sm(lib)
        row = {"variant": name, "blocks_per_sm": per_sm,
               "ptxas": smoke.ptxas_report(log).get("mi_univar_extract")}
        for what, (front, outs, max_df, _) in cases.items():
            want, got = bufs[what]
            run = launcher(lib, sms * per_sm, got, front, outs,
                           smoke.LOG_ALPHA, True, max_df)
            run()
            torch.cuda.synchronize()
            row[what] = {"equal": same(got, want),
                         "ms": smoke.time_ms(run, args.iters),
                         "device_ms": smoke.device_ms(run, args.iters)}
        print(json.dumps(row), flush=True)
    print(smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
