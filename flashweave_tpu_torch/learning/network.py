"""learn_network front-end of the PyTorch port (reference:
src/learning.jl:281-598).

PyTorch counterpart of ``flashweave_tpu/learning/network.py``, with the same
keywords plus ``device``.  Loading, normalization and the result type come
from the port's copies of the JAX package's host modules (``io``,
``preprocessing``, ``types``); the learning runs on ``device`` (default
``"cuda"``, which raises RuntimeError when CUDA is absent).
"""

from __future__ import annotations

import time
import warnings
from typing import Optional, Sequence

import numpy as np

from ..device import resolve_device
from ..io import load_data
from ..preprocessing import (
    combine_data,
    convert_to_target_prec,
    normalize_data,
)
from ..types import FWResult
from ..utils.misc import check_data, mode_string
from .lgl import LGL

VALID_PARALLEL_MODES = ("multi_il", "multi_ep", "single_il", "single", "auto")


def make_table(data_path: str, meta_data_path: Optional[str] = None,
               transposed: bool = False, make_sparse: bool = False, **kwargs):
    """Load + combine OTU and meta tables (reference: src/learning.jl:298-317)."""
    data, header, meta_data, meta_header = load_data(
        data_path, meta_data_path, transposed=transposed,
        make_sparse=make_sparse,
    )
    if meta_data is None:
        meta_mask = np.zeros(len(header), dtype=bool)
        check_data(data, header, meta_mask=meta_mask)
    else:
        assert data.shape[0] == meta_data.shape[0], (
            f"observations of data do not fit meta_data: {data.shape[0]} vs. "
            f"{meta_data.shape[0]}"
        )
        check_data(data, header)
        data, header, meta_mask = combine_data_with_meta(
            data, header, meta_data, meta_header
        )
    return data, header, meta_mask


def combine_data_with_meta(data, header, meta_data, meta_header):
    # reference: src/learning.jl:281-296
    n_meta = len(meta_header)
    from scipy import sparse as sp

    if sp.issparse(data):
        meta_arr = np.asarray(meta_data)
        if meta_arr.dtype == object or meta_arr.dtype.kind in "US":
            warnings.warn(
                "sparse OTU table combined with non-numeric meta variables; "
                "densifying the table for the combine step"
            )
            data = np.asarray(data.todense())
        else:
            comb = sp.hstack(
                [data.tocsr(), sp.csr_matrix(meta_arr.astype(np.float64))]
            ).tocsr()
            header_comb = list(header) + list(meta_header)
            meta_mask = np.concatenate(
                [np.zeros(comb.shape[1] - n_meta, dtype=bool),
                 np.ones(n_meta, dtype=bool)]
            )
            return comb, header_comb, meta_mask
    if meta_data.dtype == object or data.dtype == object:
        comb = np.empty((data.shape[0], data.shape[1] + n_meta), dtype=object)
        comb[:, : data.shape[1]] = data
        comb[:, data.shape[1]:] = meta_data
    else:
        comb = np.hstack([data, meta_data])
    header_comb = list(header) + list(meta_header)
    meta_mask = np.concatenate(
        [np.zeros(comb.shape[1] - n_meta, dtype=bool), np.ones(n_meta, dtype=bool)]
    )
    return comb, header_comb, meta_mask


def learn_network(
    data,
    meta_data_path: Optional[str] = None,
    sensitive: bool = True,
    heterogeneous: bool = False,
    max_k: int = 3,
    alpha: float = 0.01,
    conv: float = 0.01,
    header: Optional[Sequence[str]] = None,
    meta_mask: Optional[np.ndarray] = None,
    feed_forward: bool = True,
    fast_elim: bool = True,
    normalize: bool = True,
    track_rejections: bool = False,
    verbose: bool = True,
    transposed: bool = False,
    prec: int = 32,
    make_sparse: Optional[bool] = None,
    make_onehot: bool = True,
    max_tests: int = int(10e6),
    hps: int = 5,
    FDR: bool = True,
    n_obs_min: int = -1,
    cache_pcor: bool = False,
    time_limit: float = -1.0,
    update_interval: float = 30.0,
    parallel_mode: str = "auto",
    extra_data=None,
    share_data: bool = True,
    profile_dir: str = "",
    device="cuda",
    **experimental_kwargs,
) -> FWResult:
    """Learn an interaction network (reference: src/learning.jl:466-598).

    `data` may be a matrix (samples x variables), a path to a '.tsv' / '.csv'
    / '.biom' table (meta_data_path optionally alongside, reference
    src/learning.jl:354-371), or a list of paths to multiple datasets
    normalized independently (reference src/learning.jl:378-402).

    ``device`` is where the learning runs: ``"cuda"`` (default) needs a CUDA
    device and raises RuntimeError without one; ``"cpu"`` runs the plain
    PyTorch versions of the kernels.  The port drives one device, so
    ``parallel_mode="auto"`` resolves to ``"single_il"``.  Every mode is
    ported: mi and mi_nz (``sensitive=False``), fz_nz (``sensitive=True,
    heterogeneous=True``) and fz (``sensitive=True, heterogeneous=False``,
    the default).

    Documented divergences (accepted for API compatibility, no effect on
    results: all three are performance knobs of the reference's
    process-based runtime, which the port does not have):

    - ``share_data``: the reference copies or shared-memory-maps the table
      into worker processes (src/learning.jl:553-560).  Here the table is
      one upload to the device that every kernel reads; True and False are
      identical.
    - ``cache_pcor``: the reference memoizes partial-correlation recursion
      nodes in a per-worker dict (src/statfuns.jl:23-75).  The batched
      float64 pcor DP evaluates all nodes of a batch in one vectorized
      sweep, so there is nothing to cache: on the device for fz_nz and for
      fz past the wall on CUDA (``ops/statfuns.pcor_dp_tensor``, inside the
      engine's window digest), on the host otherwise
      (``ops/statfuns.pcor_dp``); the two agree bit for bit.
    - ``dense_cor``: the reference's toggle between a precomputed dense
      correlation matrix and on-the-fly correlations (src/learning.jl:42-47).
      fz's conditioning engine decides by size instead: the float64
      correlation matrix stays on the device up to
      ``ops.condtests.FZ_COR_BYTES`` (p <= 46,340), and past it each batch's
      correlations are built from the centered table; no p x p matrix is
      held on the host.  The flag has no effect.
    """
    # path-based entries
    if isinstance(data, (list, tuple)) and data and isinstance(data[0], str):
        paths = list(data)
        data_path = paths[0]
        if len(paths) > 1:
            extra = []
            for p in paths[1:]:
                X, extra_header, _, _ = load_data(p, None, transposed=transposed)
                extra.append((X, extra_header))
        else:
            extra = None
        return learn_network(
            data_path, meta_data_path, sensitive=sensitive,
            heterogeneous=heterogeneous, max_k=max_k, alpha=alpha, conv=conv,
            feed_forward=feed_forward, fast_elim=fast_elim, normalize=normalize,
            track_rejections=track_rejections, verbose=verbose,
            transposed=transposed, prec=prec, make_sparse=make_sparse,
            make_onehot=make_onehot, max_tests=max_tests, hps=hps, FDR=FDR,
            n_obs_min=n_obs_min, cache_pcor=cache_pcor, time_limit=time_limit,
            update_interval=update_interval, parallel_mode=parallel_mode,
            extra_data=extra, share_data=share_data, profile_dir=profile_dir,
            device=device, **experimental_kwargs,
        )
    if isinstance(data, str):
        if verbose:
            print("\n### Loading data ###\n")
        data, header, meta_mask = make_table(
            data, meta_data_path, transposed=transposed,
            make_sparse=bool(make_sparse),
        )
        transposed = False  # consumed by the loader
    elif meta_data_path is not None:
        raise AssertionError(
            "You provided a OTU matrix together with a meta data path, this "
            "is currently not supported. Use either "
            "'learn_network(<otu_table_path>, <meta_data_path>; ...)' or "
            "'learn_network(<otu_matrix>; ...)'."
        )

    from ..utils.timing import StageTimer

    dev = resolve_device(device)
    timer = StageTimer(dev)
    start_time = time.time()
    cont_mode = "fz" if sensitive else "mi"
    het_mode = "_nz" if heterogeneous else ""
    test_name = cont_mode + het_mode

    if parallel_mode == "auto":
        # reference: multi_il iff worker processes exist (src/learning.jl:486);
        # the port drives one device
        parallel_mode = "single_il"
    elif parallel_mode not in VALID_PARALLEL_MODES:
        raise ValueError(
            f'"{parallel_mode}" not a valid parallelization mode, choose one '
            f"of {VALID_PARALLEL_MODES}"
        )

    from scipy import sparse as sp

    if sp.issparse(data):
        data = data.tocsr()
    else:
        data = np.asarray(data)
        if make_sparse:
            data = sp.csr_matrix(data)
    if transposed:
        data = data.T
        if extra_data is not None:
            extra_data = [
                (X.T if sp.issparse(X) else np.asarray(X).T, h)
                for X, h in extra_data
            ]

    if meta_mask is None:
        meta_mask = np.zeros(data.shape[1], dtype=bool)
    meta_mask = np.asarray(meta_mask, dtype=bool)

    if header is None:
        header = ["X" + str(i + 1) for i in range(data.shape[1])]
        if extra_data is not None:
            offset = len(header)
            fixed = []
            for X, extra_header in extra_data:
                if extra_header is None:
                    extra_header = [
                        "X" + str(offset + i + 1) for i in range(X.shape[1])
                    ]
                    offset += X.shape[1]
                fixed.append((X, extra_header))
            extra_data = fixed
    header = list(header)

    check_data(data, header, meta_mask=meta_mask)

    if normalize:
        if verbose:
            print("### Normalizing ###\n")
        with timer.stage("normalize"):
            res = normalize_data(
                data, extra_data=extra_data, test_name=test_name,
                header=header, meta_mask=meta_mask, prec=prec,
                verbose=verbose, make_onehot=make_onehot,
            )
        input_data, header, meta_mask = res.data, res.header, res.meta_mask
        if verbose:
            print()
    else:
        warnings.warn("Skipping normalization, only experts should choose this option")
        if sp.issparse(data):
            data = np.asarray(data.todense())
        if extra_data is None:
            input_data = data
        else:
            res = combine_data(
                data, header, meta_mask, np.ones(data.shape[0], dtype=bool),
                None, [(X, h, np.ones(X.shape[0], dtype=bool)) for X, h in extra_data],
            )
            input_data, header, meta_mask = res.data, res.header, res.meta_mask
        input_data = convert_to_target_prec(input_data, prec, test_name=test_name)

    check_data(input_data, header, meta_mask=meta_mask)

    params_dict = dict(
        test_name=test_name, parallel=parallel_mode, max_k=max_k, alpha=alpha,
        convergence_threshold=conv, feed_forward=feed_forward,
        fast_elim=fast_elim, track_rejections=track_rejections,
        verbose=verbose, header=header, max_tests=max_tests, hps=hps, FDR=FDR,
        n_obs_min=n_obs_min, cache_pcor=cache_pcor, time_limit=time_limit,
        update_interval=update_interval, **experimental_kwargs,
    )

    if verbose:
        print("### Learning interactions ###\n")
        n_mvs = int(meta_mask.sum())
        print(f"Inferring network with {mode_string(heterogeneous, sensitive, max_k)}\n")
        print("\tRun information:")
        print(f"\tsensitive - {sensitive}")
        print(f"\theterogeneous - {heterogeneous}")
        print(f"\tmax_k - {max_k}")
        print(f"\talpha - {alpha}")
        print(f"\tOTUs - {input_data.shape[1] - n_mvs}")
        print(f"\tMVs - {n_mvs}\n")

    lgl_kwargs = dict(params_dict)
    lgl_kwargs.pop("header")
    lgl_results = LGL(input_data, header=header, stage_timer=timer,
                      profile_dir=profile_dir, device=dev, **lgl_kwargs)

    params_dict["heterogeneous"] = heterogeneous
    params_dict["sensitive"] = sensitive
    params_dict["stage_times"] = dict(timer.stages)

    net_result = FWResult(
        lgl_results, variable_ids=header, meta_variable_mask=meta_mask,
        parameters=params_dict,
    )
    if verbose:
        print()
        print(timer.summary())
        print(f"\nFinished inference. Total time taken: {round(time.time() - start_time, 3)}s")
    return net_result
