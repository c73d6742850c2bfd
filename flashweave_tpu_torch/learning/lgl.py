"""LGL: local-to-global learning (PyTorch port: mi, mi_nz, fz_nz, fz).

PyTorch counterpart of ``flashweave_tpu/learning/lgl.py`` (reference:
src/learning.jl:1-279): parameter resolution (auto time_limit / n_obs_min
heuristics), the univariate stage, the conditional neighborhood search and
weight assembly into the final symmetric graph.

The table is uploaded to the device once (:mod:`flashweave_tpu_torch.state`)
and serves both the univariate kernel and the conditioning engine: int8
(int16 when a value exceeds 127) with its levels, max_vals and level
marginals for the discrete tests (levels are counted on the host by
``utils.misc.get_levels`` / ``get_max_vals``), one contiguous float64
tensor for fz_nz and fz.

Execution modes:
- parallel="single" / "single_il": one target at a time (exact sequential
  reference semantics, still device-batched per conditioning chunk);
- parallel="multi_ep": many targets advance per round, without
  feed-forward or convergence;
- parallel="multi_il": round-based batched scheduler with feed-forward and
  convergence (learning/scheduler.py).
With a device mesh (``mesh=``, ``parallel.mesh``) the univariate pass and
the conditioning engine shard their work over it; multi_il and multi_ep on
CUDA build one over the largest power of two of the visible cards when
more than one is visible (the JAX package's lgl.py:238-247).
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Optional

import numpy as np

import torch

from ..device import resolve_device
from ..ops import univariate as uv
from ..ops.condtests import CondTestEngine
from ..state import from_numpy_continuous, from_numpy_state
from ..types import HitonState, LGLResult
from ..utils.misc import (
    get_levels,
    get_max_vals,
    is_zero_adjusted,
    isdiscrete,
    make_symmetric_graph,
    make_weights,
    maxweight,
)
from .hiton import HitonConfig
from .scheduler import RoundScheduler

VALID_PARALLEL = ("single", "single_il", "multi_ep", "multi_il")


def prepare_lgl(data, test_name, time_limit, parallel, max_k, n_obs_min, hps,
                verbose):
    """Parameter resolution heuristics (reference: src/learning.jl:1-81).
    Returns (levels, max_vals, time_limit, n_obs_min); levels and max_vals
    are None for continuous tests."""
    if time_limit == -1.0:
        if parallel == "multi_il" and max_k > 0:
            time_limit = float(round(math.log2(data.shape[1])))
            if verbose:
                print(f"Setting 'time_limit' to {time_limit} s.")
        else:
            time_limit = 0.0
    if time_limit != 0.0 and not parallel.endswith("_il"):
        warnings.warn("Using time_limit without interleaved parallelism is not advised.")

    levels = max_vals = None
    if isdiscrete(test_name):
        if verbose:
            print("Computing levels")
        levels = get_levels(data)
        max_vals = get_max_vals(data)

    if n_obs_min < 0:
        # reference quirk: `n_obs_min < 0 & is_zero_adjusted(test_name)`
        # parses as `n_obs_min < (0 & ...)` == `n_obs_min < 0`, so the auto
        # threshold applies to ALL tests (reference: src/learning.jl:51-64)
        if isdiscrete(test_name):
            max_level = int(np.max(levels))
            n_strata = min(max_level ** max_k, 8)
            n_obs_min = hps * 2 * 2 * n_strata
        else:
            n_obs_min = 20
        if verbose:
            print(f"Automatically setting 'n_obs_min' to {n_obs_min} for enhanced reliability")

    if n_obs_min > data.shape[0]:
        msg = (
            "Dataset has an insufficient number of observations, need at "
            f"least {n_obs_min} ('n_obs_min') for reliable tests"
        )
        if max_k > 0:
            msg += (". Try using a smaller 'max_k' parameter (at the cost of "
                    "higher numbers of indirect associations).")
        raise ValueError(msg)

    if verbose and is_zero_adjusted(test_name):
        n_unrel = int((np.count_nonzero(np.asarray(data), axis=0) < n_obs_min).sum())
        if n_unrel > 0:
            warnings.warn(
                f"{n_unrel} variables have insufficient observations "
                f"(< {n_obs_min} ('n_obs_min')) and will not be used for "
                "interaction prediction"
            )

    return levels, max_vals, time_limit, n_obs_min


def LGL(
    data,
    test_name: str = "mi",
    max_k: int = 3,
    alpha: float = 0.01,
    hps: int = 5,
    n_obs_min: int = -1,
    max_tests: int = int(10e6),
    convergence_threshold: float = 0.01,
    FDR: bool = True,
    parallel: str = "single",
    fast_elim: bool = True,
    no_red_tests: bool = True,
    weight_type: str = "cond_stat",
    edge_rule: str = "OR",
    verbose: bool = True,
    update_interval: float = 30.0,
    edge_merge_fun=maxweight,
    tmp_folder: str = "",
    debug: int = 0,
    time_limit: float = -1.0,
    header=None,
    meta_variable_mask=None,
    dense_cor: bool = True,
    recursive_pcor: bool = True,
    cache_pcor: bool = False,
    correct_reliable_only: bool = True,
    feed_forward: bool = True,
    track_rejections: bool = False,
    all_univar_nbrs: Optional[Dict] = None,
    tile: Optional[int] = None,
    stage_timer=None,
    profile_dir: str = "",
    device="cuda",
    mesh=None,
    **kwargs,
) -> LGLResult:
    """Learn a network via local-to-global HITON-PC (reference:
    src/learning.jl:203-279) on ``device``, or sharded over ``mesh`` (a
    :class:`..parallel.mesh.Mesh`, whose primary device then replaces
    ``device``).

    ``cache_pcor`` and ``dense_cor`` are accepted for API compatibility and
    have no effect (see the port's learn_network)."""
    if tmp_folder:
        warnings.warn("tmp_folder currently not implemented")
    if edge_rule != "OR":
        warnings.warn(f"edge_rule {edge_rule} not a valid option, setting it to OR")
        edge_rule = "OR"
    if parallel not in VALID_PARALLEL:
        raise ValueError(f"'{parallel}' not a valid parallel mode")
    dev = resolve_device(device)
    # multi-card: shard over a mesh (a power-of-two shard count, as the JAX
    # package keeps its batch buckets evenly divisible)
    if (mesh is None and parallel in ("multi_il", "multi_ep")
            and dev.type == "cuda" and torch.cuda.device_count() > 1):
        from ..parallel.mesh import get_mesh

        mesh = get_mesh(1 << (torch.cuda.device_count().bit_length() - 1))
    if mesh is not None:
        dev = mesh.primary

    from ..utils.timing import StageTimer, profiler_trace

    own_timer = stage_timer is None
    timer = StageTimer(dev) if own_timer else stage_timer
    with profiler_trace(profile_dir):
        result = _lgl_timed(
            data, test_name, max_k, alpha, hps, n_obs_min, max_tests,
            convergence_threshold, FDR, parallel, fast_elim, no_red_tests,
            weight_type, edge_merge_fun, debug, time_limit, header,
            recursive_pcor, correct_reliable_only, feed_forward,
            track_rejections, all_univar_nbrs, tile, update_interval,
            verbose, timer, dev, mesh, kwargs,
        )
    if verbose and own_timer:
        print(timer.summary())
    return result


def _lgl_timed(
    data, test_name, max_k, alpha, hps, n_obs_min, max_tests,
    convergence_threshold, FDR, parallel, fast_elim, no_red_tests,
    weight_type, edge_merge_fun, debug, time_limit, header, recursive_pcor,
    correct_reliable_only, feed_forward, track_rejections, all_univar_nbrs,
    tile, update_interval, verbose, timer, dev, mesh, kwargs,
) -> LGLResult:
    data = np.asarray(data)
    n, p = data.shape

    with timer.stage("prepare"):
        levels, max_vals, time_limit, n_obs_min = prepare_lgl(
            data, test_name, time_limit, parallel, max_k, n_obs_min, hps,
            verbose,
        )
        # ONE upload serves the univariate pass and the engine
        if isdiscrete(test_name):
            state = from_numpy_state(data, levels, max_vals, dev)
        else:
            state = from_numpy_continuous(data, dev)

    if all_univar_nbrs is None:
        if verbose:
            print("Computing univariate associations")
        with timer.stage("univariate"):
            all_univar_nbrs = uv.pw_univar_neighbors(
                data, test_name=test_name, alpha=alpha, hps=hps,
                n_obs_min=n_obs_min, FDR=FDR, levels=levels,
                max_vals=max_vals,
                correct_reliable_only=correct_reliable_only,
                tile=tile, state=state, mesh=mesh,
            )
        if verbose:
            nbr_nums = [len(v) for v in all_univar_nbrs.values()]
            print("\nUnivariate degree stats:")
            print(f"mean degree {np.mean(nbr_nums):.2f}, max {np.max(nbr_nums)}\n")
            if np.mean(nbr_nums) > p * 0.2:
                warnings.warn(
                    "The univariate network is exceptionally dense, "
                    "computations may be slow."
                )
    # fewest univariate neighbors first (reference: src/learning.jl:97-98)
    target_vars = sorted(all_univar_nbrs.keys(),
                         key=lambda x: len(all_univar_nbrs[x]))

    rej_dict: Dict[int, dict] = {}
    unfinished: Dict[int, HitonState] = {}

    if max_k == 0:
        nbr_dict = all_univar_nbrs
    else:
        if verbose:
            print("\nStarting conditioning search")
        with timer.stage("engine_init"):
            engine = CondTestEngine(
                data, test_name, max_k, hps=hps, n_obs_min=n_obs_min,
                recursive_pcor=recursive_pcor, state=state, mesh=mesh,
            )
        cfg = HitonConfig(
            test_name=test_name, max_k=max_k, alpha=alpha, hps=hps,
            n_obs_min=n_obs_min, max_tests=max_tests, fast_elim=fast_elim,
            no_red_tests=no_red_tests, weight_type=weight_type,
            time_limit=time_limit, track_rejections=track_rejections,
            debug=debug, bnb=bool(kwargs.pop("bnb", False)),
            cut_test_branches=bool(kwargs.pop("cut_test_branches", True)),
        )
        scheduler = RoundScheduler(
            engine, cfg, target_vars, all_univar_nbrs,
            feed_forward=(feed_forward and parallel.endswith("_il")),
            convergence_threshold=(
                convergence_threshold if parallel.endswith("_il") else 0.0
            ),
            update_interval=update_interval, verbose=verbose,
            sequential=(parallel in ("single", "single_il")),
        )
        with timer.stage("conditional"):
            nbr_states = scheduler.run()
        engine.release()
        nbr_dict = {T: st.state_results for T, st in nbr_states.items()}
        if time_limit != 0.0 or convergence_threshold != 0.0:
            for T, st in nbr_states.items():
                if st.unchecked_vars:
                    unfinished[T] = st
        if track_rejections:
            for T, st in nbr_states.items():
                if st.state_rejections:
                    rej_dict[T] = st.state_rejections

    if verbose:
        print("\nPostprocessing")
    with timer.stage("postprocess"):
        if edge_merge_fun is maxweight:
            from ..utils.misc import assemble_graph_bulk

            graph = assemble_graph_bulk(
                nbr_dict, all_univar_nbrs, weight_type, test_name,
                max_var=p, header=header,
            )
        else:
            weights_dict = {
                T: make_weights(nbr_dict[T], all_univar_nbrs[T], weight_type,
                                test_name)
                for T in nbr_dict
            }
            graph = make_symmetric_graph(
                weights_dict, "OR", edge_merge_fun=edge_merge_fun,
                max_var=p, header=header,
            )
    if verbose:
        print("Complete")
    return LGLResult(graph, rej_dict, unfinished)
