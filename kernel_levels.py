#!/usr/bin/env python3
"""K1's and K4's times at several level counts, in this checkout and others.

    python3 kernel_levels.py [--kernels k4] [--levels 12,48,127]
                             [--table spread] [CHECKOUT ...]
    python3 kernel_levels.py --kernels k1,k4 --levels 2,3,4,5,6,7,8 \\
                             --table synth [CHECKOUT ...]

Kernels: ``k1`` (``ops.kernels.mi_univar_stats``) and ``k4``
(``ops.kernels.mi_univar_stats_planes``), each timed at the level counts
its checkout's wrapper takes (``K1_LEVELS``, ``PLANES_LEVELS``) and skipped
at the others.  Tables, built with this checkout's ``chip_smoke.py``:

- ``spread`` (the default): ``spread_table(2048, 2050, L)``, each variable
  three levels drawn from 0..L-1, at the block 512 x 2,048, nz 0;
- ``synth``: ``synth_table(2048, 10_000, 5, levels=L)`` at the slices'
  block 512 x 10,000, nz 0, and at L = 3 also nz 2 (case ``3/nz2``, the
  3-level slice's nz-uniform state).

Each time is CUDA events around 10 calls (3 on ``spread``) after two
warm-ups, in a fresh process per checkout and round, each building its
checkout's kernels.  The rounds run this checkout, then each other one,
then all again in reverse order, so that drift on the card shows as a
difference between rounds.  Prints the card line, one JSON line a run,
then the mean ms of each case, checkout and kernel as a table (one row a
case).  Unpack another checkout into the git-ignored ``_scratch/`` with
``git archive``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
TABLES = {
    # name: (block, calls timed)
    "spread": ((0, 512, 0, 2048), 3),
    "synth": ((0, 512, 0, 10_000), 10),
}


def smoke_module():
    spec = importlib.util.spec_from_file_location("_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def child(root: str, kernels, levels, table: str) -> None:
    """One run: the named kernels of the checkout at ``root`` at every L
    of ``levels`` that its wrappers take."""
    sys.path.insert(0, root)
    import torch

    import flashweave_tpu_torch
    from flashweave_tpu_torch.ops import kernels as K
    from flashweave_tpu_torch.state import from_numpy_state

    if not Path(flashweave_tpu_torch.__file__).resolve().is_relative_to(
            Path(root).resolve()):
        raise RuntimeError(f"imported {flashweave_tpu_torch.__file__}, "
                           f"not the checkout at {root}")
    smoke = smoke_module()
    K.load_library()
    wrappers = {"k1": (K.mi_univar_stats, K.K1_LEVELS),
                "k4": (K.mi_univar_stats_planes, K.PLANES_LEVELS)}
    (s, tile, ys, ylen), calls = TABLES[table]
    out = {"checkout": root, **{k: {} for k in kernels}}
    for L in levels:
        data = (smoke.spread_table(2048, 2050, L) if table == "spread"
                else smoke.synth_table(2048, 10_000, 5, levels=L))
        st = from_numpy_state(data, None, None, "cuda")
        for nz in (0, 2) if table == "synth" and L == 3 else (0,):
            args = (st.dataT, st.marg, st.levels, st.max_vals, s, tile, L, ys,
                    ylen, nz, 5.0, 20.0)
            case = str(L) + (f"/nz{nz}" if nz else "")
            for k in kernels:
                fn, supported = wrappers[k]
                if L in supported:
                    out[k][case] = smoke.time_ms(lambda: fn(*args),
                                                 iters=calls)
        del st
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--kernels", default="k4")
    ap.add_argument("--levels", default="12,48,127")
    ap.add_argument("--table", choices=sorted(TABLES), default="spread")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: kernel_levels.py needs a "
                           "CUDA card")
    roots = [str(HERE)] + [str(Path(r).resolve()) for r in args.checkouts]
    print(smoke_module().card_line(), flush=True)
    runs = []
    for root in roots + roots[::-1]:
        res = subprocess.run([sys.executable, __file__, "--child", root,
                              args.kernels, args.levels, args.table],
                             capture_output=True, text=True, check=True,
                             timeout=900)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    cols = [(root, k) for root in roots for k in args.kernels.split(",")]
    cases = list(dict.fromkeys(c for r in runs for k in args.kernels.split(",")
                               for c in r[k]))
    print("case | " + " | ".join(f"{Path(r).name or r}:{k}" for r, k in cols))
    for case in cases:
        cells = []
        for root, k in cols:
            got = [r[k][case] for r in runs
                   if r["checkout"] == root and case in r[k]]
            cells.append(f"{sum(got) / len(got):.3f}" if got else "-")
        print(f"{case} | " + " | ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        root, kernels, levels, table = sys.argv[2:6]
        child(root, kernels.split(","), [int(L) for L in levels.split(",")],
              table)
        sys.exit(0)
    sys.exit(main())
