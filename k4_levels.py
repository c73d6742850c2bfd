#!/usr/bin/env python3
"""K4's time at several level counts, in this checkout and in others.

    python3 k4_levels.py [CHECKOUT ...]

Times K4 (``ops.kernels.mi_univar_stats_planes``) on one CUDA card at
L = 12, 48 and 127, on ``chip_smoke.spread_table(2048, 2050, L)`` (each
variable three levels drawn from 0..L-1), at the block 512 x 2,048 with
nz 0: CUDA events around 3 calls after two warm-ups, in a fresh process per
checkout and round, each building its checkout's kernels.  The rounds run
this checkout, then each other one, then all again in reverse order, so
that drift on the card shows as a difference between rounds.  Prints the
card line, one JSON line a run, then the mean ms per checkout and L.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
LEVELS = (12, 48, 127)
BLOCK = (0, 512, 0, 2048)


def child(root: str) -> None:
    """One run: K4 of the checkout at ``root`` at every L of LEVELS."""
    sys.path.insert(0, root)
    import torch

    import flashweave_tpu_torch
    from flashweave_tpu_torch.ops import kernels as K
    from flashweave_tpu_torch.state import from_numpy_state

    if not Path(flashweave_tpu_torch.__file__).resolve().is_relative_to(
            Path(root).resolve()):
        raise RuntimeError(f"imported {flashweave_tpu_torch.__file__}, "
                           f"not the checkout at {root}")
    spec = importlib.util.spec_from_file_location("_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    K.load_library()
    out = {"checkout": root}
    for L in LEVELS:
        st = from_numpy_state(smoke.spread_table(2048, 2050, L), None, None,
                              "cuda")
        s, tile, ys, ylen = BLOCK
        args = (st.dataT, st.marg, st.levels, st.max_vals, s, tile, L, ys,
                ylen, 0, 5.0, 20.0)
        out[str(L)] = smoke.time_ms(lambda: K.mi_univar_stats_planes(*args),
                                    iters=3)
        del st
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: k4_levels.py needs a CUDA card")
    roots = [str(HERE)] + [str(Path(r).resolve()) for r in sys.argv[1:]]
    spec = importlib.util.spec_from_file_location("_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    print(smoke.card_line(), flush=True)
    runs = []
    for root in roots + roots[::-1]:
        res = subprocess.run([sys.executable, __file__, "--child", root],
                             capture_output=True, text=True, check=True,
                             timeout=900)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for root in roots:
        mine = [r for r in runs if r["checkout"] == root]
        print(root, {L: sum(r[str(L)] for r in mine) / len(mine)
                     for L in LEVELS}, flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
