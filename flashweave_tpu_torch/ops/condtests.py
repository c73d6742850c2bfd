"""Batched conditional independence tests (discrete modes).

PyTorch counterpart of the discrete half of ``flashweave_tpu/ops/condtests.py``
(reference: src/tests.jl:184-276).  The HITON search layer
(``learning/hiton.py``, ``learning/scheduler.py``) ships flat batches of
(X, Y, Zs) descriptors; each batch becomes stratified contingency tables
(``contingency.cond_ctab_batch``), then signed MI, adjusted df and the power
check on the device.  p-values are finished on the host in float64.

``mi_tests_begin`` only enqueues device work and returns; ``mi_tests_finish``
copies the results to the host.  The scheduler advances the other half of a
round's targets in between, so host bookkeeping overlaps device time as it
did under JAX's asynchronous dispatch.

This engine serves mi and mi_nz with the host digest: ``dev_digest`` and
``turbo_mxu`` are False, so the scheduler takes its float64 host digest path
for every window.  fz (ROADMAP queue 1 item 7) and fz_nz (item 8) raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import statfuns as sf
from .contingency import cond_ctab_batch
from ..types import TestResult

# running count of conditional CI tests dispatched (bench/diagnostics)
N_TESTS_DISPATCHED = 0

# elements of one (n, B) descriptor-gather tensor per device call: bounds
# the temporaries of a chunk at a few hundred MB
CHUNK_ELEMS = 1 << 23


def _mi_cond_kernel(data, levels, maxv, X, Y, Zs, kvec, hps, max_k, L, S,
                    nz, nzu=False):
    """(stat, df, n_obs, suff) for B conditional MI tests.

    Mirrors the reference's dense MiTestCond test (reference:
    src/tests.jl:184-229): view trimming -> contingency -> nz slicing ->
    power check n/(lx*ly*lz) > hps -> signed MI + adjusted df.

    ``nzu`` (nz-uniform): every variable has 3 levels, so all nz offsets are
    1 and the x=0 / y=0 cells are structurally empty; the histogram spans
    the sliced (L-1)^2 * S cells and the statistics see the sliced table
    with zero offsets.  Same results as the general nz path."""
    B = X.shape[0]
    dev = data.device
    x = data[:, X]                                    # (n, B)
    y = data[:, Y]
    if nzu:
        ox = torch.ones(B, dtype=torch.long, device=dev)
        oy = ox
        mask = (x != 0) & (y != 0)
    elif nz:
        ox = (maxv[X] > 1).long()                     # (B,)
        oy = (maxv[Y] > 1).long()
        mask = ((x != 0) | (ox[None, :] == 0)) & ((y != 0) | (oy[None, :] == 0))
    else:
        ox = torch.zeros(B, dtype=torch.long, device=dev)
        oy = ox
        mask = torch.ones(x.shape, dtype=torch.bool, device=dev)
    ctab, occ = cond_ctab_batch(data, X, Y, Zs, kvec, mask, max_k, L, S,
                                reduced=nzu)
    zeros = torch.zeros(B, dtype=torch.long, device=dev)
    stat, df, n_obs = sf.mi_stats(ctab, zeros if nzu else ox,
                                  zeros if nzu else oy)
    if occ is None:
        levels_z = (ctab.sum(dim=(1, 2)) > 0).sum(dim=-1)   # occupied strata
    else:
        # compacted-strata mode: the EXACT occupied count (can exceed the
        # table width S; such tests fail the power check by construction)
        levels_z = occ
    if nz:
        lx_eff = (L - ox).to(torch.float64)
        ly_eff = (L - oy).to(torch.float64)
    else:
        lx_eff = levels[X].to(torch.float64)
        ly_eff = levels[Y].to(torch.float64)
    cells = lx_eff * ly_eff * levels_z.to(torch.float64)
    suff = torch.where(cells > 0,
                       n_obs / torch.where(cells > 0, cells, 1.0) > hps, True)
    stat = torch.where(suff, stat, 0.0)
    df = torch.where(suff, df, 0)
    return stat, df, n_obs, suff


class CondTestEngine:
    """Holds the device-resident discrete table and evaluates flat batches
    of conditional MI tests, returning reference-semantics results (host
    float64 p-values).

    ``state`` is a :class:`flashweave_tpu_torch.state.DiscreteState` already
    on the device (one upload serves the univariate pass and this engine);
    without it ``data`` is uploaded to ``device``."""

    def __init__(self, data: np.ndarray, test_name: str, max_k: int,
                 levels=None, max_vals=None, cor_mat=None, hps: int = 5,
                 n_obs_min: int = 0, recursive_pcor: bool = True,
                 state=None, device="cuda"):
        if not test_name.startswith("mi"):
            item = 8 if test_name.endswith("_nz") else 7
            raise NotImplementedError(
                f"{test_name} is not ported to PyTorch yet "
                f"(ROADMAP queue 1 item {item})")
        if state is None:
            from ..state import from_numpy_state

            state = from_numpy_state(data, levels, max_vals, device)
        self.state = state
        self.device = state.device
        self.mesh = None
        self.test_name = test_name
        self.max_k = max_k
        self.hps = hps
        self.n_obs_min = n_obs_min
        self.nz = test_name.endswith("_nz")
        self.discrete = True
        self.recursive_pcor = recursive_pcor
        self.cor_mat = cor_mat
        self.n, self.p = state.data.shape
        self.levels = state.levels_np
        self.max_vals = state.max_vals_np
        self.L = state.L
        self.S = self.L ** max_k if max_k > 0 else 1
        # occupied-strata cap (ZMapper-equivalent compaction): beyond n/hps
        # occupied strata the power check fails regardless
        cap = self.n if hps <= 0 else min(self.n, int(self.n // hps) + 1)
        self.S_hist = min(self.S, max(int(cap), 1))
        self.nzu = bool(self.nz and self.L == 3 and (self.max_vals > 1).all())
        # the scheduler's float64 host digest serves every window
        self.dev_digest = False
        self.turbo_mxu = False

    def _upload(self, a, shape=None):
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
        if shape is not None:
            t = t.reshape(shape)
        return t.to(self.device, non_blocking=True)

    def mi_tests_begin(self, X: np.ndarray, Y: np.ndarray, Zs: np.ndarray,
                       kvec: np.ndarray):
        """Enqueue B conditional MI tests on the device and return a handle
        for :meth:`mi_tests_finish` without waiting for them."""
        global N_TESTS_DISPATCHED
        B = len(X)
        N_TESTS_DISPATCHED += B
        chunk = max(1, CHUNK_ELEMS // max(self.n, 1))
        st = self.state
        handle = []
        for s0 in range(0, B, chunk):
            s1 = min(B, s0 + chunk)
            stat, df, n_obs, suff = _mi_cond_kernel(
                st.data, st.levels, st.max_vals, self._upload(X[s0:s1]),
                self._upload(Y[s0:s1]),
                self._upload(Zs[s0:s1], (s1 - s0, self.max_k)),
                self._upload(kvec[s0:s1]), float(self.hps), self.max_k,
                self.L, self.S_hist, self.nz, self.nzu)
            handle.append(torch.stack(
                [stat, df.to(torch.float64), n_obs, suff.to(torch.float64)]))
        return handle

    def mi_tests_finish_lazy(self, handle):
        """Wait for a mi_tests_begin handle WITHOUT computing p-values;
        returns (stat, df, n_obs, suff) in host float64 / int64 / bool."""
        if not handle:
            return (np.zeros(0), np.zeros(0, np.int64), np.zeros(0),
                    np.zeros(0, bool))
        arr = torch.cat(handle, dim=1).cpu().numpy()
        return (arr[0], arr[1].astype(np.int64), arr[2], arr[3] != 0)

    def mi_tests_finish(self, handle):
        """Wait for a mi_tests_begin handle; returns (stat, pval, df, suff)."""
        stat, df, n_obs, suff = self.mi_tests_finish_lazy(handle)
        pval = np.where(suff, sf.mi_pval(stat, df, n_obs), 1.0)
        return stat, pval, df, suff

    def mi_tests_raw(self, X: np.ndarray, Y: np.ndarray, Zs: np.ndarray,
                     kvec: np.ndarray):
        """Evaluate B conditional MI tests; Zs shape (B, max_k), padded with
        0.  Returns numpy arrays (stat, pval, df, suff)."""
        return self.mi_tests_finish(self.mi_tests_begin(X, Y, Zs, kvec))

    def mi_tests(self, X, Y, Zs, kvec) -> List[TestResult]:
        stat, pval, df, suff = self.mi_tests_raw(X, Y, Zs, kvec)
        return [
            TestResult(float(stat[i]), float(pval[i]), int(df[i]), bool(suff[i]))
            for i in range(len(X))
        ]
