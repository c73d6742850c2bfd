"""Batched conditional independence tests.

PyTorch counterpart of ``flashweave_tpu/ops/condtests.py`` (reference:
src/tests.jl:184-276) for mi, mi_nz, fz_nz and fz.  The HITON search layer
(``learning/hiton.py``, ``learning/scheduler.py``) ships flat batches:

- mi / mi_nz: (X, Y, Zs) descriptors become stratified contingency tables,
  then signed MI, adjusted df and the power check on the device: K5
  (``kernels.mi_cond_stats``, one launch a call) where the engine's ``k5``
  gate holds, else :func:`_mi_cond_kernel` (``contingency.cond_ctab_batch``,
  ``statfuns.mi_stats``) in chunks of tests;
- fz_nz: (T, candidate) pairs with their variable lists [T, cand, Zs...]
  become correlation submatrices over the rows where T and the candidate are
  both nonzero (:func:`_masked_cor_kernel`, reference src/statfuns.jl:138-155
  ``cor_subset!``);
- fz: (X, Y, Zs) tests become (max_k+2)^2 correlation submatrices, gathered
  from the (p, p) matrix on the device (:func:`_fz_cond_kernel`), or, past
  ``FZ_COR_BYTES``, built per batch from the centered table
  (:func:`_fz_cond_onfly_kernel`); the scheduler's fast windows take
  all-row correlations over variable lists instead
  (``masked_cor_begin(plain=True)``).  These are plain gathers and products,
  as the JAX package computes them outside any Pallas kernel.

p-values are finished on the host in float64.  ``mi_tests_begin`` and
``masked_cor_begin`` only enqueue device work and return; the ``*_finish``
methods copy the results to the host.  The scheduler advances the other half
of a round's targets in between, so host bookkeeping overlaps device time as
it did under JAX's asynchronous dispatch.

The continuous window digest (``cont_dev``: fz_nz, and fz's fast windows
on the on-the-fly route) stays on the device by default on CUDA
(:meth:`CondTestEngine.cont_tests_begin`, :func:`_cont_digest`): the
candidates' correlations, the float64 pcor DP (``statfuns.pcor_dp_tensor``),
the Fisher-z log-p and the per-candidate decisions, with one copy of (3, NC)
numbers to the host a round.  On the CPU the scheduler digests those
windows on the host in float64 (``statfuns.pcor_dp``).  fz's per-test
gather (``fz_tests_begin`` / ``fz_tests_finish``) runs the pcor DP on the
device too (``statfuns.pcor_dp_tensor``, bit for bit numpy's) and copies
back one statistic a test; its p-values are scipy's on the host.

The mi / mi_nz windows have two device digests where (L-1)^2 * S <= 128
(3-level nz tables and 2-level tables at max_k = 3):

- ``dev_digest`` (:meth:`CondTestEngine.mi_tests_begin_digest`, the JAX
  package's ``_mi_cond_digest_scan_fn``): the round's tests through K5 (or
  :func:`_mi_cond_kernel`), then the float64 log-p and the per-candidate
  decisions on the device, through K6 (``kernels.mi_window_digest``, whose
  plain version is :func:`_mi_digest`); on by default on CUDA, off on the
  CPU, where the scheduler digests the per-test results on the host
  (``scheduler._scan_digest``);
- ``turbo_mxu`` (:meth:`CondTestEngine.turbo_tests_begin`, the JAX
  package's ``_turbo_digest_fn``): every distinct (candidate, subset)
  pair's G-test of a full-target window, then each slot's tests through
  their pairs' log p and the same reduction, in one K7 launch
  (``kernels.mi_turbo_digest``) on the card; its plain version
  builds the pairs' joint tables from one batched product of 0/1
  level-indicator planes (:func:`_turbo_pair_stats`) and digests through
  :func:`_mi_digest`; on by default wherever its gate holds.

All three device digests reduce per candidate through
:func:`_digest_reduce` and return (3, NC) numbers, copied to the host once
a round.

On a device mesh (``CondTestEngine(..., mesh=...)``, ``parallel.mesh``) the
table (and fz's correlation state) is replicated onto each distinct device
and every ``*_begin`` shards its work over the shards, each running the
same per-chunk functions on its own device; the results are gathered
device-major onto the primary device and the padding stripped, so every
result equals the unmeshed engine's (the JAX package's ``shard_map``
variants ``_sharded_mi_cond_fn``, ``_mi_cond_scan_fn``,
``_mi_cond_digest_scan_fn``, ``_turbo_digest_fn``,
``_sharded_masked_cor_fn``, ``_sharded_fz_cond_fn``,
``_sharded_fz_cond_onfly_fn`` and ``_cont_digest_fn``):

- mi / mi_nz tests and fz tests: the batch padded to a multiple of the
  shard count and split into equal device-major pieces
  (:meth:`CondTestEngine._shards`); the on-the-fly Gram's row chunks follow
  the whole batch's size, so each test sums in the same order as unmeshed;
- masked correlations: whole ``MCOR_SEG`` segments a shard;
- the mi window digest: the tests sharded as above and gathered before the
  per-candidate reduction, which runs on the primary device (a candidate's
  tests may straddle shards);
- the turbo digest: whole windows a shard (each window holds its own
  candidates);
- the continuous digest: whole ``MCOR_SEG`` segments of candidates a shard.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import kernels
from . import statfuns as sf
from .contingency import cond_ctab_batch
from .univariate import _fz_center, cor_matrix
from ..parallel.mesh import gather, pad_to_multiple, put_replicated
from ..types import TestResult
from ..utils.timing import span

# running count of conditional CI tests dispatched (bench/diagnostics)
N_TESTS_DISPATCHED = 0

# elements of one (n, B) descriptor-gather tensor per device call of the
# plain route (:func:`_mi_cond_kernel`): bounds the temporaries of a chunk at
# a few hundred MB.  K5 builds no such tensor and takes a call in one launch
CHUNK_ELEMS = 1 << 23

# max elements in flight for the gathered (rows, B, m) masked-cor tensor
MCOR_ROW_BUDGET = 1 << 26

# (T, candidate) pairs per masked-correlation device call: keeps B*n*m
# memory bounded
MCOR_SEG = 256

# fz conditioning: the largest (p, p) float64 correlation matrix the engine
# keeps on the device, 8 p^2 bytes: p <= 46,340.  Past it each batch's
# submatrices are built from the centered table (the JAX package's bound,
# FZ_COR_MATERIALIZE_MAX = 52000, is its v5e's f32 HBM).  16 GiB of an 80 GB
# card leaves room for the float64 table and its centered copy (1 GB each at
# 2048 x 65,536), the univariate sweep's candidates (up to 1.6 GB) and the
# engine's batches; p = 65,536 (34 GB) goes on the fly, as on the TPU.  A
# byte count of its own, not the device's memory, so that the CPU and the
# card take the same route for the same p.
FZ_COR_BYTES = 16 << 30

# test hook: take the on-the-fly route at any p
FORCE_COR_ONFLY = False

# the continuous window digest (fz_nz, fz on the fly): bytes of one
# chunk's per-test (B, max_k + 2, max_k + 2) float64 submatrices; the pcor
# DP holds a few tensors of that size at once
CONT_SUB_BYTES = 1 << 27

# test hook: None puts the continuous window digest on the device where the
# engine's device is CUDA; True or False forces it either way
FORCE_CONT_DEV = None

# the mi / mi_nz digests' gate: (L-1)^2 * S histogram cells a test at most
DIGEST_CELLS = 128

# test hooks, where the digests' gates hold: None puts the mi / mi_nz
# window digest on the device where the engine's device is CUDA, and the
# turbo window digest on every device; True or False forces either way
FORCE_DEV_DIGEST = None
FORCE_TURBO_MXU = None

# the turbo window digest: bytes of one chunk's (n, windows, U * S) float32
# stratum planes (U subsets of S strata a window); the product's operands
# and the bool and index temporaries that build them stay within a small
# multiple of it
TURBO_PLANE_BYTES = 1 << 30


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


def _row_chunk(n, B, m):
    """Rows a step of the correlation kernels: the gathered (rows, B, m)
    tensor stays within ``MCOR_ROW_BUDGET`` elements."""
    return max(64, min(n, MCOR_ROW_BUDGET // max(B * m, 1)))


def _masked_cor_kernel(data, X, Y, var_idx, B, m, plain=False):
    """Correlation submatrices over the rows where X and Y are both nonzero
    (``plain``: over all rows, fz's fast windows past the p x p wall).

    data: (n, p) float table on the device; X, Y: (B,) and var_idx: (B, m)
    int64 column indices [X, Y, Z_total...] (padded entries repeat X).
    Returns one (B, m*m + 1) tensor: the (B, m, m) correlations (NaN -> 0,
    reference src/statfuns.jl:150) and the (B,) included row counts, so the
    host fetches once.  Rows go in chunks that keep the gathered (rows, B, m)
    tensor within ``MCOR_ROW_BUDGET`` elements.  The mask is a multiply, so
    nothing here waits for the device."""
    n = data.shape[0]
    chunk = _row_chunk(n, B, m)
    flat = var_idx.reshape(-1)
    n_obs = torch.zeros(B, dtype=data.dtype, device=data.device)
    S1 = torch.zeros((B, m), dtype=data.dtype, device=data.device)
    G = torch.zeros((B, m, m), dtype=data.dtype, device=data.device)
    for r0 in range(0, n, chunk):
        rows = data[r0:r0 + chunk]
        Vm = rows[:, flat].reshape(rows.shape[0], B, m)
        if plain:
            n_obs += rows.shape[0]
        else:
            mask = ((rows[:, X] != 0) & (rows[:, Y] != 0)).to(data.dtype)
            Vm = Vm * mask[..., None]
            n_obs += mask.sum(dim=0)
        S1 += Vm.sum(dim=0)
        G += torch.einsum("nbi,nbj->bij", Vm, Vm)
    safe_n = torch.where(n_obs > 0, n_obs, 1.0)
    mu = S1 / safe_n[:, None]
    cov = G - safe_n[:, None, None] * mu[:, :, None] * mu[:, None, :]
    d = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=1, dim2=2), min=0.0))
    denom = d[:, :, None] * d[:, None, :]
    C = torch.where(denom > 0, cov / torch.where(denom > 0, denom, 1.0), 0.0)
    return torch.cat([C.reshape(B, m * m), n_obs[:, None]], dim=1)


def _fz_index(X, Y, Zs, kvec, max_k):
    """(B, max_k + 2) variable indices [X, Y, Z_1..Z_maxk] of B fz tests,
    the Zs past each test's k padded with X."""
    karr = torch.arange(max_k, device=X.device)
    pad = torch.where(karr[None, :] < kvec[:, None], Zs, X[:, None])
    return torch.cat([X[:, None], Y[:, None], pad], dim=1)


def _fz_cond_kernel(C, X, Y, Zs, kvec, max_k):
    """The (B, m, m) correlation submatrices of B fz tests (m = max_k + 2)
    gathered from the (p, p) matrix C on the device; padded Zs repeat X."""
    idx = _fz_index(X, Y, Zs, kvec, max_k)
    return C[idx[:, :, None], idx[:, None, :]]


def _fz_cond_onfly_kernel(xc, ssd, X, Y, Zs, kvec, max_k, chunk=None):
    """:func:`_fz_cond_kernel`'s submatrices built from the centered table
    (``ops.univariate._fz_center``) without the (p, p) matrix: a Gram of
    each test's m columns over row chunks that keep the gathered
    (rows, B, m) tensor within ``MCOR_ROW_BUDGET`` elements, divided by the
    columns' ssd products, NaN where one is 0, clamped to [-1, 1]: per entry
    ``ops.univariate.fz_block``'s arithmetic up to summation order.
    ``chunk``: the row chunk (a mesh shard takes its whole batch's)."""
    n = xc.shape[0]
    idx = _fz_index(X, Y, Zs, kvec, max_k)
    B, m = idx.shape
    if chunk is None:
        chunk = _row_chunk(n, B, m)
    flat = idx.reshape(-1)
    G = torch.zeros((B, m, m), dtype=xc.dtype, device=xc.device)
    for r0 in range(0, n, chunk):
        V = xc[r0:r0 + chunk][:, flat].reshape(-1, B, m)
        G += torch.einsum("nbi,nbj->bij", V, V)
    d = ssd[idx]
    G /= d[:, :, None] * d[:, None, :]      # a zero ssd: 0/0 = NaN
    return G.clamp_(-1.0, 1.0)


def _bucket_m(m: int) -> int:
    """Variable-subset width rounded up to a few sizes (the JAX package's
    bucket), so a round's matrices pad to few distinct widths."""
    for s in (8, 16, 32, 64, 128):
        if m <= s:
            return s
    return ((m + 127) // 128) * 128


def _segments(counts, B):
    """(cand, offs, loc) of B tests in NC contiguous segments of ``counts``
    tests: each test's segment, each segment's first test and each test's
    index within its segment.  B is given by the caller, so nothing here
    waits for the device."""
    dev = counts.device
    NC = counts.shape[0]
    cand = torch.repeat_interleave(torch.arange(NC, device=dev), counts,
                                   output_size=B)
    offs = torch.cumsum(counts, 0) - counts
    loc = torch.arange(B, device=dev) - offs[cand]
    return cand, offs, loc


def _digest_reduce(logp, stat, sig, cand, loc, offs, NC, B):
    """The per-candidate reduction of the three window digests (continuous,
    mi, turbo) over B tests in NC segments: exit_e, the first
    non-significant local index or -1; w, the LAST local index attaining
    M = the largest log p over the significant tests (the host digest's tie
    break); wstat, stat at w; wpval = exp(M), 0 without a significant test.
    ``cand`` / ``loc`` / ``offs`` as :func:`_segments` gives them.  Returns
    (3, NC) in stat's dtype, without a host synchronisation."""
    dev = stat.device
    # B exceeds every local index: "no test" in the exit reduction
    exit_loc = torch.full((NC,), B, dtype=torch.int64, device=dev)
    exit_loc.scatter_reduce_(0, cand, torch.where(sig, B, loc), "amin")
    exit_e = torch.where(exit_loc == B, -1, exit_loc)
    M = torch.full((NC,), -torch.inf, dtype=stat.dtype, device=dev)
    M.scatter_reduce_(0, cand, torch.where(sig, logp, -torch.inf), "amax")
    w = torch.full((NC,), -1, dtype=torch.int64, device=dev)
    w.scatter_reduce_(0, cand, torch.where(sig & (logp == M[cand]), loc, -1),
                      "amax")
    wstat = stat[torch.clamp(offs + torch.clamp(w, min=0), max=B - 1)]
    return torch.stack([exit_e.to(stat.dtype), wstat, torch.exp(M)])


def _cont_digest(C, nobs, counts, POS, KV, B, max_k, log_alpha, n_obs_min):
    """Per-candidate (exit_e, wstat, wpval) of NC continuous windows, on the
    device (the JAX package's ``_cont_digest_fn``).

    C: (NC, mv, mv) float64 correlations over each candidate's variable list
    [T, cand, Zs...], nobs: (NC,) their row counts, counts: (NC,) int64 tests
    a candidate; POS: (B, max_k) positions of each test's Zs in the list,
    KV: (B,) their sizes, B = counts.sum() given by the caller, so nothing
    here waits for the device.  C is clipped to [-1, 1] as the JAX digest
    does (the host digest, ``scheduler._finish_mcw``, does not clip: an
    entry one ulp past 1 gives it a NaN p where this gives 0).  Each test's
    (max_k + 2)^2 submatrix (rows [0, 1, POS + 2 for t < KV], 0 past KV) goes
    through the float64 pcor DP and the Fisher-z log p (NaN -> 0).  A test
    is significant at log p < log alpha with nobs >= n_obs_min.  exit_e is
    a candidate's first non-significant local index or -1; wstat the stat
    of the last significant test with the largest log p M; wpval exp(M), 0
    without a significant test.  Returns (3, NC) float64."""
    NC, dev = C.shape[0], C.device
    C = C.clamp(-1.0, 1.0)
    cand, offs, loc = _segments(counts, B)
    pos = torch.where(torch.arange(max_k, device=dev) < KV[:, None], POS + 2,
                      0)
    idx = torch.cat([torch.zeros_like(KV)[:, None],
                     torch.ones_like(KV)[:, None], pos], dim=1)  # (B, m)
    sub = C[cand[:, None, None], idx[:, :, None], idx[:, None, :]]
    stat = sf.pcor_dp_tensor(sub, KV, max_k)
    n_t = nobs[cand]
    logp = sf.fz_logpval(stat, n_t, 0)
    logp = torch.where(torch.isnan(logp), 0.0, logp)
    sig = (logp < log_alpha) & (n_t >= n_obs_min)
    return _digest_reduce(logp, stat, sig, cand, loc, offs, NC, B)


def _mi_digest(stat, df, n_obs, suff, counts, B, log_alpha, max_df):
    """Per-candidate (exit_e, wstat, wpval) of B conditional MI tests in
    NC = len(counts) contiguous candidate segments, on the device (the JAX
    package's ``_mi_cond_digest_scan_fn`` after its scan): the float64
    closed-form log p (``statfuns.mi_logpval_smalldf`` over df <= max_df),
    0 where the power check fails, significant below log alpha, then
    :func:`_digest_reduce`.  Returns (3, NC) float64."""
    cand, offs, loc = _segments(counts, B)
    logp = sf.mi_logpval_smalldf(stat, df, n_obs, max_df)
    logp = torch.where(suff, logp, 0.0)
    return _digest_reduce(logp, stat, logp < log_alpha, cand, loc, offs,
                          counts.shape[0], B)


def _turbo_tables(data, maxv, Tw, Cw, memb, klen, L, S, nz, nzu):
    """The joint tables of every (candidate, subset) pair of Wc full-target
    windows (target Tw (Wc,), m candidates Cw (Wc, m)), on the device (the
    JAX package's ``_turbo_digest_fn`` before its G-tests): (P, ox, oy), P
    (Wc, m, Lr, Lr, U, S) in the product's float type, cell [w, j, a, b,
    u, s] the rows of window w whose target sits at level a + o, candidate
    j at b + o (o = 1 under nz-uniform) and subset u in stratum s; ox (Wc,)
    and oy (Wc, m) the generic nz offsets (None otherwise).

    A (n, Wc, m * Lr^2): the (x, y) level-indicator planes of each
    (target, candidate) pair, the nz row mask folded in (nz-uniform: levels
    1..L-1 only, so the indicators are the mask); Bz (n, Wc, U * S): the
    stratum indicators of the window's U subsets (``memb`` / ``klen``, radix
    z-codes in base L).  One batched product A^T Bz gives every
    (candidate, subset) joint table; 0/1 products summed in float32 are
    exact below 2^24 rows (float64 past that)."""
    n = data.shape[0]
    Wc, m = Cw.shape
    U, max_k = memb.shape
    dev, f64 = data.device, torch.float64
    mm = torch.float32 if n < (1 << 24) else f64
    lv = torch.arange(1 if nzu else 0, L, device=dev)
    Lr = lv.shape[0]
    x = data[:, Tw].long()                                      # (n, Wc)
    ys = data[:, Cw.reshape(-1)].long().reshape(n, Wc, m)
    xo = x[..., None] == lv                                     # (n, Wc, Lr)
    yo = ys[..., None] == lv                                    # (n, Wc, m, Lr)
    A = xo[:, :, None, :, None] & yo[:, :, :, None, :]
    ox = oy = None
    if nz and not nzu:
        # generic nz: binary variables keep their zeros (offset 0)
        ox = maxv[Tw] > 1                                       # (Wc,)
        oy = maxv[Cw] > 1                                       # (Wc, m)
        mask = ((x != 0) | ~ox)[:, :, None] & ((ys != 0) | ~oy)
        A = A & mask[..., None, None]
    A = A.reshape(n, Wc, m * Lr * Lr).to(mm)
    pw = L ** torch.arange(max_k, device=dev)
    wz = torch.where(torch.arange(max_k, device=dev) < klen[:, None], pw, 0)
    zc = (ys[:, :, memb.reshape(-1)].reshape(n, Wc, U, max_k) * wz).sum(-1)
    Bz = (zc[..., None] == torch.arange(S, device=dev)).reshape(n, Wc, U * S)
    P = torch.bmm(A.permute(1, 2, 0), Bz.to(mm).permute(1, 0, 2))
    return P.reshape(Wc, m, Lr, Lr, U, S), ox, oy


def _turbo_pair_stats(data, levels, maxv, Tw, Cw, memb, klen, hps, L, S, nz,
                      nzu):
    """(stat, df, n_obs, suff) of every (candidate, subset) pair of Wc
    full-target windows (target Tw (Wc,), m candidates Cw (Wc, m)), each
    (Wc, m * U), on the device (the tables and G-tests of the JAX package's
    ``_turbo_digest_fn``): the tables of :func:`_turbo_tables`, then the
    G-tests in float64, in the pair layout (Wc, m, a, b, U, S), with the
    same reductions as ``_mi_cond_kernel``: signed MI, adjusted df and the
    power check."""
    Wc, m = Cw.shape
    U = memb.shape[0]
    dev, f64 = data.device, torch.float64
    P, ox, oy = _turbo_tables(data, maxv, Tw, Cw, memb, klen, L, S, nz, nzu)
    Lr = P.shape[2]
    P6 = P.to(f64)
    marg_i = P6.sum(dim=3)                                      # (Wc,m,a,U,S)
    marg_j = P6.sum(dim=2)                                      # (Wc,m,b,U,S)
    marg_k = marg_i.sum(dim=2)                                  # (Wc,m,U,S)
    n_obs = marg_k.sum(dim=-1)                                  # (Wc,m,U)
    mi_, mj = marg_i[:, :, :, None], marg_j[:, :, None]
    valid = (P6 != 0) & (mi_ != 0) & (mj != 0)
    denom = torch.where(valid, mi_ * mj, 1.0)
    term = torch.where(
        valid, torch.log((marg_k[:, :, None, None] * P6) / denom) * P6, 0.0)
    av = torch.arange(Lr, device=dev)
    if nz and not nzu:
        oxb = ox.long()[:, None, None, None, None, None]
        oyb = oy.long()[:, :, None, None, None, None]
        diag = ((av[None, None, :, None, None, None] - oxb)
                == (av[None, None, None, :, None, None] - oyb))
    else:
        diag = (av[:, None] == av[None, :])[None, None, :, :, None, None]
    mi_pos = torch.where(diag, term, 0.0).sum(dim=(2, 3, 5))
    mi_neg = torch.where(diag, 0.0, term).sum(dim=(2, 3, 5))
    n_pos = torch.where(diag, P6, 0.0).sum(dim=(2, 3, 5))
    n_neg = n_obs - n_pos                                       # (Wc,m,U)
    safe_n = torch.where(n_obs > 0, n_obs, 1.0)
    stat = (mi_pos + mi_neg) / safe_n
    flip = mi_neg * (n_neg / safe_n) > mi_pos * (n_pos / safe_n)
    stat = torch.where(flip, -stat, stat)
    alx = torch.clamp((marg_i != 0).sum(dim=2), min=1)         # (Wc,m,U,S)
    aly = torch.clamp((marg_j != 0).sum(dim=2), min=1)
    df = ((alx - 1) * (aly - 1)).sum(dim=-1)
    levels_z = (marg_k > 0).sum(dim=-1).to(f64)                 # (Wc,m,U)
    if nzu:
        lx = ly = float(L - 1)
    elif nz:
        lx = (L - ox.long())[:, None, None].to(f64)
        ly = (L - oy.long())[:, :, None].to(f64)
    else:
        lx = levels[Tw][:, None, None].to(f64)
        ly = levels[Cw][:, :, None].to(f64)
    cells = lx * ly * levels_z
    suff = torch.where(cells > 0,
                       n_obs / torch.where(cells > 0, cells, 1.0) > hps, True)
    stat = torch.where(suff, stat, 0.0)
    df = torch.where(suff, df, 0)
    return tuple(t.reshape(Wc, m * U) for t in (stat, df, n_obs, suff))


def _turbo_pairs(jb, ub, U):
    """The distinct (candidate, subset) pairs of a turbo template's tests
    (``hiton._turbo_mxu_template``'s ``jb`` and ``ub``), ordered by
    candidate, then subset: (pj, pu, tpair), each test's pair
    pj[tpair] * U + pu[tpair] == jb * U + ub."""
    pid = np.asarray(jb, np.int64) * U + np.asarray(ub, np.int64)
    uniq, tpair = np.unique(pid, return_inverse=True)
    return uniq // U, uniq % U, tpair.reshape(-1)


class CondTestEngine:
    """Holds the device-resident table and evaluates flat batches of
    conditional tests, returning reference-semantics results (host float64
    p-values).

    ``state`` is the table already on the device (one upload serves the
    univariate pass and this engine): a
    :class:`flashweave_tpu_torch.state.DiscreteState` for mi / mi_nz, the
    float64 tensor of :func:`..state.from_numpy_continuous` for fz and
    fz_nz.  Without it ``data`` is uploaded to ``device``.

    fz with ``recursive_pcor``, max_k > 0 and no host ``cor_mat``
    (``cor_device``): the (p, p) correlation matrix on the device
    (``cor_j``), or past ``FZ_COR_BYTES`` (``cor_onfly``) the centered table
    and its column norms (``xc``, ``ssd``).  :meth:`release` frees them.

    ``cont_dev`` (fz_nz, and fz on the fly, at max_k > 0): the scheduler
    digests the continuous windows on the device through
    :meth:`cont_tests_begin` / :meth:`cont_tests_finish`; on by default
    where the device is CUDA, off on the CPU, ``FORCE_CONT_DEV`` forces
    it.

    mi / mi_nz at max_k > 0 where (L-1)^2 * S_hist <= ``DIGEST_CELLS``
    (3-level nz tables, 2-level tables at max_k 3): ``dev_digest``, the
    scheduler's windows digested on the device through
    :meth:`mi_tests_begin_digest` / :meth:`mi_tests_finish_digest`, on by
    default on CUDA, off on the CPU (``FORCE_DEV_DIGEST``); ``turbo_mxu``
    where besides no strata are compacted (S_hist == S), the full-target
    windows through :meth:`turbo_tests_begin` / :meth:`turbo_tests_finish`,
    on by default on every device (``FORCE_TURBO_MXU``), as the JAX package
    runs it under float64.  A failure in any device digest raises: nothing falls back to
    the host digest.  The window digest's log p and reduction run K6
    (``kernels.mi_window_digest``) on the card, the turbo windows K7
    (``kernels.mi_turbo_digest``; ``turbo_mxu`` implies ``k5``, whose
    gate K7 shares); on the CPU both wrappers run their plain versions.

    ``k5``, decided from shapes here: the per-test results of mi / mi_nz
    (``mi_tests_begin``, the window digest's tests, a mesh's shards) come
    from K5 (``kernels.mi_cond_stats``: one launch a call, the descriptors
    uploaded as one int32 array) where no strata are compacted
    (S_hist == S), the table is int8 and a test's table fits K5's shared
    memory (``kernels.k5_fits``); otherwise from :func:`_mi_cond_kernel` in
    chunks of ``CHUNK_ELEMS`` (compacted strata, int16 tables).  On the CPU
    K5's wrapper runs its plain version, the same chunks.

    ``mesh`` (a :class:`..parallel.mesh.Mesh`): ``device`` is the mesh's
    primary device, the table (and fz's correlation state) goes once onto
    each distinct device of the mesh (``tables``: one a local shard), and
    every ``*_begin`` shards its work over the mesh (module docstring)."""

    def __init__(self, data: np.ndarray, test_name: str, max_k: int,
                 levels=None, max_vals=None, cor_mat=None, hps: int = 5,
                 n_obs_min: int = 0, recursive_pcor: bool = True,
                 state=None, device="cuda", mesh=None):
        self.mesh = mesh
        if mesh is not None:
            device = mesh.primary
        self.test_name = test_name
        self.max_k = max_k
        self.hps = hps
        self.n_obs_min = n_obs_min
        self.nz = test_name.endswith("_nz")
        self.discrete = test_name.startswith("mi")
        self.recursive_pcor = recursive_pcor
        self.cor_mat = cor_mat
        self.data_np = np.asarray(data)
        self.n, self.p = self.data_np.shape
        self.dev_digest = False
        self.turbo_mxu = False
        self.k5 = False
        self.cor_device = False
        self.cor_onfly = False
        self.cont_dev = False
        if not self.discrete:
            if state is None:
                from ..state import from_numpy_continuous

                state = from_numpy_continuous(data, device)
            self.data = state
            self.device = state.device
            self.tables = self._replicate(state)
            self.levels = None
            if not self.nz and recursive_pcor and max_k > 0 and cor_mat is None:
                self.cor_onfly = (8 * self.p ** 2 > FZ_COR_BYTES
                                  or FORCE_COR_ONFLY)
                if self.cor_onfly:
                    self.xc, self.ssd = _fz_center(state)
                    self.cor_state = list(zip(self._replicate(self.xc),
                                              self._replicate(self.ssd)))
                else:
                    self.cor_j = cor_matrix(state)
                    self.cor_state = self._replicate(self.cor_j)
                self.cor_device = True
            # the continuous window digest on the device (fz_nz, fz past
            # the wall): on CUDA unless FORCE_CONT_DEV says otherwise
            if max_k > 0 and (self.nz or self.cor_onfly):
                self.cont_dev = (self.device.type == "cuda"
                                 if FORCE_CONT_DEV is None
                                 else bool(FORCE_CONT_DEV))
            return
        if state is None:
            from ..state import from_numpy_state

            state = from_numpy_state(data, levels, max_vals, device)
        self.state = state
        self.device = state.device
        self.tables = self._replicate(state)
        self.levels = state.levels_np
        self.max_vals = state.max_vals_np
        self.L = state.L
        self.S = self.L ** max_k if max_k > 0 else 1
        # occupied-strata cap (ZMapper-equivalent compaction): beyond n/hps
        # occupied strata the power check fails regardless
        cap = self.n if hps <= 0 else min(self.n, int(self.n // hps) + 1)
        self.S_hist = min(self.S, max(int(cap), 1))
        self.nzu = bool(self.nz and self.L == 3 and (self.max_vals > 1).all())
        self.nz_mode = 2 if self.nzu else int(self.nz)
        self.k5 = (self.S == self.S_hist and state.data.dtype == torch.int8
                   and kernels.k5_fits(self.L, max_k, self.nz_mode))
        # the mi / mi_nz device digests, where a test's histogram is small
        small = max_k > 0 and (self.L - 1) ** 2 * self.S_hist <= DIGEST_CELLS
        if small:
            self.dev_digest = (self.device.type == "cuda"
                               if FORCE_DEV_DIGEST is None
                               else bool(FORCE_DEV_DIGEST))
        if small and self.S == self.S_hist:
            self.turbo_mxu = (True if FORCE_TURBO_MXU is None
                              else bool(FORCE_TURBO_MXU))
        # K7 takes every turbo window: (L-1)^2 S <= 128 keeps L <= 12 (an
        # int8 table) and a test within K5_TEST_BYTES
        assert self.k5 or not self.turbo_mxu, "turbo windows outside K5's gate"
        self._turbo_dev_cache = {}

    def _replicate(self, x):
        """``x`` on each local shard of the mesh ([x] without one)."""
        return [x] if self.mesh is None else put_replicated(x, self.mesh)

    def _upload(self, a, shape=None, device=None):
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
        if shape is not None:
            t = t.reshape(shape)
        return t.to(self.device if device is None else device,
                    non_blocking=True)

    def _shards(self, arrays, B):
        """The local shards' pieces of B items: yields (shard, pieces of
        ``arrays``) with the items padded (zeros) to a multiple of the shard
        count and split into equal device-major pieces; one piece, shard 0,
        without a mesh.  Results gather with :meth:`_gather`."""
        if self.mesh is None:
            yield 0, arrays
            return
        arrays = [pad_to_multiple(np.asarray(a), self.mesh.size, 0)
                  for a in arrays]
        Bp = B + (-B) % self.mesh.size
        for i, a, b in self.mesh.shard_ranges(Bp):
            yield i, [x[a:b] for x in arrays]

    def _gather(self, parts, B, dim=0):
        """The local shards' results (one tensor a shard) concatenated
        device-major over the mesh along ``dim`` on the primary device, cut
        to the B unpadded items."""
        if self.mesh is None:
            return parts[0]
        return gather(self.mesh, parts, dim=dim).narrow(dim, 0, B)

    def _mi_parts(self, X, Y, Zs, kvec, shard=0):
        """(stat, df, n_obs, suff) of B conditional MI tests on the device
        of local ``shard``: one tuple from K5 where ``k5`` holds (one launch,
        the descriptors uploaded once), else one for each chunk of
        :meth:`_mi_chunks`."""
        if not self.k5 or not len(X):
            return self._mi_chunks(X, Y, Zs, kvec, shard)
        st = self.tables[shard]
        desc = self._descriptors(X, Y, Zs, kvec, st.device)
        return [kernels.mi_cond_stats(st, desc, float(self.hps), self.max_k,
                                      self.nz_mode)]

    def _descriptors(self, X, Y, Zs, kvec, device):
        """K5's (B, 3 + max_k) int32 rows [X, Y, k, Z...] on ``device``: one
        host-to-device copy, from pinned memory to a card (the caching host
        allocator keeps the buffer until the copy has run)."""
        B = len(X)
        host = torch.empty((B, 3 + self.max_k), dtype=torch.int32,
                           pin_memory=device.type == "cuda")
        a = host.numpy()
        a[:, 0], a[:, 1], a[:, 2] = X, Y, kvec
        a[:, 3:] = np.asarray(Zs).reshape(B, self.max_k)
        return host.to(device, non_blocking=True)

    def _mi_chunks(self, X, Y, Zs, kvec, shard=0):
        """(stat, df, n_obs, suff) of B conditional MI tests on the device
        of local ``shard`` through :func:`_mi_cond_kernel`, a tuple for each
        chunk of tests whose (n, B) gathers stay within ``CHUNK_ELEMS``."""
        B = len(X)
        chunk = max(1, CHUNK_ELEMS // max(self.n, 1))
        st = self.tables[shard]
        up = lambda a, shape=None: self._upload(a, shape, st.device)  # noqa: E731
        parts = []
        for s0 in range(0, B, chunk):
            s1 = min(B, s0 + chunk)
            parts.append(_mi_cond_kernel(
                st.data, st.levels, st.max_vals, up(X[s0:s1]), up(Y[s0:s1]),
                up(Zs[s0:s1], (s1 - s0, self.max_k)), up(kvec[s0:s1]),
                float(self.hps), self.max_k, self.L, self.S_hist, self.nz,
                self.nzu))
        return parts

    def _mi_sharded(self, X, Y, Zs, kvec):
        """(stat, df, n_obs, suff) of B tests on a mesh: each shard's piece
        through :meth:`_mi_parts` on its own device, stacked (4, B) float64
        and gathered onto the primary device."""
        B = len(X)
        parts = [torch.stack([torch.cat(t).to(torch.float64) for t in
                              zip(*self._mi_parts(*arrs, shard=i))])
                 for i, arrs in self._shards([X, Y, Zs, kvec], B)]
        return self._gather(parts, B, dim=1)

    def mi_tests_begin(self, X: np.ndarray, Y: np.ndarray, Zs: np.ndarray,
                       kvec: np.ndarray):
        """Enqueue B conditional MI tests on the device and return a handle
        for :meth:`mi_tests_finish` without waiting for them."""
        global N_TESTS_DISPATCHED
        N_TESTS_DISPATCHED += len(X)
        if self.mesh is not None and len(X):
            return [self._mi_sharded(X, Y, Zs, kvec)]
        return [torch.stack([stat, df.to(torch.float64), n_obs,
                             suff.to(torch.float64)])
                for stat, df, n_obs, suff in self._mi_parts(X, Y, Zs, kvec)]

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

    def mi_tests_begin_digest(self, X, Y, Zs, kvec, counts, alpha):
        """Enqueue B conditional MI tests and their per-candidate digest on
        the device (counts: the tests of each candidate, in contiguous
        segments of the batch) and return a handle for
        :meth:`mi_tests_finish_digest` without waiting.  The tests go as in
        :meth:`mi_tests_begin` (K5 or chunks); the round's log p and
        per-candidate reduction go through ``kernels.mi_window_digest``: K6,
        one launch, on the card, the plain :func:`_mi_digest` on the CPU.
        The work runs under the profiler range ``mi_digest``, which
        ``profile_slice.py`` reads."""
        global N_TESTS_DISPATCHED
        B = len(X)
        N_TESTS_DISPATCHED += B
        with span("mi_digest"):
            if self.mesh is None:
                parts = self._mi_parts(X, Y, Zs, kvec)
                stat, df, n_obs, suff = (t[0] if len(t) == 1 else torch.cat(t)
                                         for t in zip(*parts))
            else:
                stat, df, n_obs, suff = self._mi_sharded(X, Y, Zs, kvec)
                df, suff = df.to(torch.int64), suff != 0
            both = self._upload(np.stack([counts, np.cumsum(counts)]))
            return kernels.mi_window_digest(
                stat, df, n_obs, suff, both[0], B, math.log(alpha),
                (self.L - 1) ** 2 * self.S_hist, ends=both[1])

    def mi_tests_finish_digest(self, handle):
        """(exit_e int64, wstat float64, wpval float64) per candidate, flat
        over the round, from a :meth:`mi_tests_begin_digest` handle: one
        device-to-host copy.  Raises where K6 marked a segment whose
        running sums disagree with its count (NaN)."""
        out = handle.cpu().numpy()
        if np.isnan(out[0]).any():
            raise RuntimeError("K6: segments whose running sums are not "
                               "their counts")
        return out[0].astype(np.int64), out[1], out[2]

    def turbo_tests_begin(self, m: int, Ts: np.ndarray, cands: np.ndarray,
                          alpha: float, tpl: dict):
        """Enqueue W full-target windows (targets Ts (W,), candidates
        cands (W, m)) and their per-slot digests on the device, and return
        a handle for :meth:`turbo_tests_finish` without waiting.  ``tpl`` is
        ``hiton._turbo_mxu_template(m, max_k)``: the window's subset family
        and each test's (candidate, subset) pair, whose distinct pairs are
        held on the device once for each m (:meth:`_turbo_consts`).  The
        windows go through ``kernels.mi_turbo_digest``: K7, one launch, on
        the card; on the CPU its plain version (:func:`_turbo_pair_stats` in
        chunks of windows whose stratum planes stay within
        ``TURBO_PLANE_BYTES``, each template test taking its pair's results,
        then :func:`_mi_digest` over the (window, slot) segments of all W
        windows).  On a mesh each shard digests whole windows, and
        the (3, W, NC) digests gather along W.  The work runs under the
        profiler range ``turbo_digest``, which ``profile_slice.py`` reads."""
        global N_TESTS_DISPATCHED
        W = len(Ts)
        N_TESTS_DISPATCHED += W * tpl["B"]
        with span("turbo_digest"):
            parts = [self._turbo_windows(m, *arrs, alpha, tpl, i)
                     for i, arrs in self._shards(
                         [Ts, np.asarray(cands).reshape(W, m)], W)]
            return self._gather(parts, W, dim=1)

    def _turbo_consts(self, m, tpl, dev):
        """The template's :class:`kernels.TurboConsts` on ``dev``, uploaded
        at the first window of m there (``_turbo_dev_cache``)."""
        const = self._turbo_dev_cache.get((m, dev))
        if const is None:
            pj, pu, tpair = _turbo_pairs(tpl["jb"], tpl["ub"], tpl["U"])
            const = kernels.turbo_consts(m, pj, pu, tpair, tpl["memb"],
                                         tpl["klen"], tpl["counts"], dev)
            self._turbo_dev_cache[(m, dev)] = const
        return const

    def _turbo_windows(self, m, Ts, cands, alpha, tpl, shard=0):
        """:meth:`turbo_tests_begin`'s (3, W, NC) digests of the windows
        (Ts, cands) on the device of local ``shard``."""
        W = len(Ts)
        st = self.tables[shard]
        dev = st.device
        return kernels.mi_turbo_digest(
            st, self._upload(Ts, device=dev), self._upload(cands, (W, m), dev),
            self._turbo_consts(m, tpl, dev), float(self.hps), self.max_k,
            self.nz_mode, math.log(alpha), (self.L - 1) ** 2 * self.S_hist)

    def turbo_tests_finish(self, handle):
        """(exit_e (W, NC) int64, wstat (W, NC), wpval (W, NC)) from a
        :meth:`turbo_tests_begin` handle, the layout of a window's
        per-candidate digest: one device-to-host copy."""
        out = handle.cpu().numpy()
        return out[0].astype(np.int64), out[1], out[2]

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

    # -- continuous ---------------------------------------------------------

    def masked_cor_begin(self, pairs: Sequence[Tuple[int, int]],
                         var_lists: Sequence[Sequence[int]],
                         plain: bool = False):
        """Enqueue the masked correlations of ``pairs`` (T, candidate) over
        their variable lists [T, candidate, Z_total...] on the device, in
        segments of ``MCOR_SEG`` pairs, and return the handles without
        waiting.  ``plain``: over all rows (fz).  On a mesh each shard takes
        whole segments, each gathered onto the primary device: a segment's
        row sums then run as without a mesh (torch's CPU sums over the rows
        round a column by its place in the batch)."""
        segs = range(0, len(pairs), MCOR_SEG)
        if self.mesh is None:
            return [self._masked_cor_seg(pairs[s:s + MCOR_SEG],
                                         var_lists[s:s + MCOR_SEG], plain)
                    for s in segs]
        owner = {j: i for i, j0, j1 in self.mesh.shard_ranges(len(segs))
                 for j in range(j0, j1)}
        handles = []
        for j, s in enumerate(segs):
            vls = var_lists[s:s + MCOR_SEG]
            m = _bucket_m(max(len(v) for v in vls))
            parts = [self._masked_cor_seg(pairs[s:s + MCOR_SEG], vls, plain,
                                          i)[0] if owner.get(j) == i
                     else torch.empty((0, m * m + 1), dtype=t.dtype,
                                      device=t.device)
                     for i, t in enumerate(self.tables)]
            handles.append((gather(self.mesh, parts), len(vls), m))
        return handles

    def _masked_cor_seg(self, pairs, var_lists, plain=False, shard=0):
        """One segment's (B, m*m + 1) correlations and row counts on the
        device of local ``shard``."""
        B = len(pairs)
        m = _bucket_m(max(len(v) for v in var_lists))
        X = np.zeros(B, np.int64)
        Y = np.zeros(B, np.int64)
        VI = np.zeros((B, m), np.int64)
        for i, ((x, y), vl) in enumerate(zip(pairs, var_lists)):
            X[i], Y[i] = x, y
            VI[i, : len(vl)] = vl
            VI[i, len(vl):] = x  # pad with X; padded entries are never read
        data = self.tables[shard]
        up = lambda a: self._upload(a, device=data.device)  # noqa: E731
        out = _masked_cor_kernel(data, up(X), up(Y), up(VI), B, m, plain)
        return out, B, m

    def masked_cor_finish(self, handles):
        """Per pair (C_sub (m, m) float64, n_obs) from the handles of
        :meth:`masked_cor_begin`; one device-to-host copy per segment."""
        out = []
        for dev, B, m in handles:
            buf = dev.cpu().numpy()
            C = buf[:, : m * m].reshape(B, m, m)
            n_obs = buf[:, m * m]
            out.extend((C[i], float(n_obs[i])) for i in range(B))
        return out

    def masked_cor_finish_raw(self, handles):
        """Segment-level finish: (C (Wtot, mv, mv) float64, n_obs (Wtot,))
        with every segment's matrices padded to the round's largest width
        mv, so the scheduler digests a whole round's fz_nz windows in a few
        vectorized passes."""
        mv = max(m for _, _, m in handles)
        Cs, Ns = [], []
        for dev, B, m in handles:
            buf = dev.cpu().numpy()
            C = buf[:, : m * m].reshape(B, m, m)
            if m < mv:
                Cp = np.zeros((B, mv, mv))
                Cp[:, :m, :m] = C
                C = Cp
            Cs.append(C)
            Ns.append(buf[:, m * m])
        return (Cs[0] if len(Cs) == 1 else np.concatenate(Cs),
                Ns[0] if len(Ns) == 1 else np.concatenate(Ns))

    def masked_cor(self, pairs: Sequence[Tuple[int, int]],
                   var_lists: Sequence[Sequence[int]]):
        """Masked correlation matrices for (T, C) pairs over their variable
        subsets [T, C, Z_total...].  Returns list of (C_sub f64, n_obs)."""
        return self.masked_cor_finish(self.masked_cor_begin(pairs, var_lists))

    def cont_tests_begin(self, var_lists, POS, KV, counts, alpha):
        """Enqueue the device digest of NC continuous candidate windows and
        return the handles without waiting.

        var_lists: per candidate [T, cand, Zs...]; POS (B, max_k) and KV (B,)
        the tests' positions into the Zs part and sizes, counts (NC,) the
        tests a candidate.  The round's correlations go in the host route's
        ``MCOR_SEG`` segments (``_masked_cor_seg``: masked for fz_nz, over
        all rows for fz), so both digests see the same C bit for bit;
        segments group into chunks whose per-test submatrices stay within
        ``CONT_SUB_BYTES``, each digested by :func:`_cont_digest`.  The
        work runs under the profiler range ``cont_digest``, which
        ``profile_slice.py`` reads."""
        global N_TESTS_DISPATCHED
        N_TESTS_DISPATCHED += len(KV)
        with span("cont_digest"):
            return self._cont_chunks(var_lists, POS, KV, counts, alpha)

    def _cont_chunks(self, var_lists, POS, KV, counts, alpha):
        NC = len(var_lists)
        counts = np.asarray(counts, np.int64)
        cend = np.zeros(NC + 1, np.int64)
        np.cumsum(counts, out=cend[1:])
        mv = _bucket_m(max(len(v) for v in var_lists))
        if self.mesh is None:
            return self._cont_range(var_lists, POS, KV, counts, cend, mv,
                                    alpha, 0, NC)
        # whole MCOR_SEG segments a shard, gathered along the candidates
        nseg = -(-NC // MCOR_SEG)
        parts = []
        for i, s0, s1 in self.mesh.shard_ranges(nseg):
            c0, c1 = min(NC, s0 * MCOR_SEG), min(NC, s1 * MCOR_SEG)
            hs = self._cont_range(var_lists, POS, KV, counts, cend, mv, alpha,
                                  c0, c1, i)
            parts.append(torch.cat(hs, dim=1) if hs else torch.zeros(
                (3, 0), dtype=torch.float64, device=self.tables[i].device))
        return [self._gather(parts, NC, dim=1)]

    def _cont_range(self, var_lists, POS, KV, counts, cend, mv, alpha, lo, hi,
                    shard=0):
        """:func:`_cont_digest` handles of candidates [lo, hi) on the device
        of local ``shard``, in chunks of ``MCOR_SEG`` segments from ``lo``
        whose per-test submatrices stay within ``CONT_SUB_BYTES``."""
        data = self.tables[shard]
        dev = data.device
        b_lo, b_hi = int(cend[lo]), int(cend[hi])
        counts_d = self._upload(counts[lo:hi], device=dev)
        POS_d = self._upload(POS[b_lo:b_hi], device=dev)
        KV_d = self._upload(KV[b_lo:b_hi], device=dev)
        cap = CONT_SUB_BYTES // (8 * (self.max_k + 2) ** 2)
        log_alpha = math.log(alpha)
        handles = []
        c0 = lo
        while c0 < hi:
            c1 = min(hi, c0 + MCOR_SEG)
            while c1 < hi and cend[min(hi, c1 + MCOR_SEG)] - cend[c0] <= cap:
                c1 = min(hi, c1 + MCOR_SEG)
            b0, b1 = int(cend[c0]) - b_lo, int(cend[c1]) - b_lo
            C = torch.zeros((c1 - c0, mv, mv), dtype=data.dtype, device=dev)
            nobs = torch.empty(c1 - c0, dtype=data.dtype, device=dev)
            for s in range(c0, c1, MCOR_SEG):
                vls = var_lists[s:min(c1, s + MCOR_SEG)]
                out, B, m = self._masked_cor_seg(
                    [(v[0], v[1]) for v in vls], vls, not self.nz, shard)
                C[s - c0:s - c0 + B, :m, :m] = out[:, :m * m].reshape(B, m, m)
                nobs[s - c0:s - c0 + B] = out[:, m * m]
            handles.append(_cont_digest(
                C, nobs, counts_d[c0 - lo:c1 - lo], POS_d[b0:b1], KV_d[b0:b1],
                b1 - b0, self.max_k, log_alpha, float(self.n_obs_min)))
            c0 = c1
        return handles

    def cont_tests_finish(self, handles):
        """(exit_e int64, wstat float64, wpval float64) per candidate, flat
        over the round, from the handles of :meth:`cont_tests_begin`: one
        device-to-host copy."""
        out = torch.cat(handles, dim=1).cpu().numpy()
        return out[0].astype(np.int64), out[1], out[2]

    # -- fz against the device correlation matrix ----------------------------

    # fz tests a device call: bounds the on-the-fly route's gathered rows
    # and the gathered submatrices (B * m^2 float64)
    FZ_CHUNK = 1 << 16

    def fz_tests_begin(self, X: np.ndarray, Y: np.ndarray, Zs: np.ndarray,
                       kvec: np.ndarray):
        """Enqueue B fz tests (Zs (B, max_k), padded) on the device, in
        chunks of ``FZ_CHUNK``: each gathers (or, on the fly, builds) the
        tests' correlation submatrices and runs the float64 pcor DP on them
        there (``statfuns.pcor_dp_tensor``, the reference's 1e-5 rounding,
        src/statfuns.jl:39,51, bit for bit numpy's).  On a mesh each chunk
        is sharded and its (B,) statistics gathered.  Returns a handle for
        :meth:`fz_tests_finish` without waiting.  With fewer rows than
        n_obs_min nothing is launched: every test is unreliable."""
        global N_TESTS_DISPATCHED
        B = len(X)
        N_TESTS_DISPATCHED += B
        if self.n < self.n_obs_min:
            return B, None
        CH = self.FZ_CHUNK
        parts = []
        for s in range(0, B, CH):
            arrs = [X[s:s + CH], Y[s:s + CH], Zs[s:s + CH], kvec[s:s + CH]]
            Bc = len(arrs[0])
            chunk = _row_chunk(self.n, Bc, self.max_k + 2)
            parts.append(self._gather(
                [self._fz_chunk(*a, chunk, i)
                 for i, a in self._shards(arrs, Bc)], Bc))
        return B, parts

    def _fz_chunk(self, X, Y, Zs, kvec, chunk, shard=0):
        """The pcor DP statistics (B,) of B fz tests on the device of local
        ``shard``; ``chunk``: the on-the-fly Gram's row chunk."""
        dev = self.tables[shard].device
        kv = self._upload(kvec, device=dev)
        args = (self._upload(X, device=dev), self._upload(Y, device=dev),
                self._upload(Zs, (len(X), self.max_k), dev), kv, self.max_k)
        if self.cor_onfly:
            xc, ssd = self.cor_state[shard]
            out = _fz_cond_onfly_kernel(xc, ssd, *args, chunk)
        else:
            out = _fz_cond_kernel(self.cor_state[shard], *args)
        return sf.pcor_dp_tensor(out, kv, self.max_k)

    def fz_tests_finish(self, handle):
        """(stat, pval, df, suff) in host float64 for a
        :meth:`fz_tests_begin` handle (reference: src/tests.jl:250-265: df
        0, suff the run-level n_obs check): one device-to-host copy of the
        (B,) statistics, scipy's p-values on the host."""
        B, parts = handle
        if parts is None:
            return (np.zeros(B), np.ones(B), np.zeros(B, np.int64),
                    np.zeros(B, bool))
        stat = (torch.cat(parts).cpu().numpy() if parts else np.zeros(0))
        pval = np.asarray(sf.fz_pval(stat, self.n, 0))
        return stat, pval, np.zeros(B, np.int64), np.ones(B, bool)

    def fz_tests_raw(self, X, Y, Zs, kvec):
        """Evaluate B fz tests; returns numpy (stat, pval, df, suff)."""
        return self.fz_tests_finish(self.fz_tests_begin(X, Y, Zs, kvec))

    def release(self):
        """Drop the fz correlation state (the (p, p) matrix or the centered
        table, and their replicas) so that its device memory is freed with
        the run, not when the collector reaches the engine."""
        self.cor_j = self.xc = self.ssd = self.cor_state = None

    def fz_tests_from_cor_raw(self, C: np.ndarray, pos_X: np.ndarray,
                              pos_Y: np.ndarray, pos_Zs: np.ndarray,
                              kvec: np.ndarray, n_obs: float):
        """Partial-correlation tests from one correlation matrix C (per-pair
        masked for fz_nz); positions index into C.  Returns numpy arrays
        (stat, pval, df, suff).  suff_power is the n_obs >= n_obs_min check
        and pval uses len_z = 0 (reference src/tests.jl:250-265)."""
        global N_TESTS_DISPATCHED
        B = len(pos_X)
        N_TESTS_DISPATCHED += B
        if n_obs < self.n_obs_min:
            return (np.zeros(B), np.ones(B), np.zeros(B, np.int64),
                    np.zeros(B, bool))
        kvec = np.asarray(kvec, dtype=np.int64)
        pos_Zs = np.asarray(pos_Zs, dtype=np.int64)
        # gather (max_k+2)^2 submatrices: idx[b] = [X, Y, Z_1..Z_maxk(padded X)]
        pad = np.where(
            np.arange(self.max_k)[None, :] < kvec[:, None],
            pos_Zs[:, : self.max_k],
            np.asarray(pos_X, dtype=np.int64)[:, None],
        )
        idx = np.concatenate(
            [np.asarray(pos_X)[:, None], np.asarray(pos_Y)[:, None], pad],
            axis=1,
        )
        sub = C[idx[:, :, None], idx[:, None, :]]
        stat = sf.pcor_dp(sub, kvec, self.max_k, xp=np)
        pval = sf.fz_pval(stat, n_obs, 0)
        return (stat, np.asarray(pval), np.zeros(B, np.int64),
                np.ones(B, bool))

    def fz_tests_from_cor(self, C, pos_X, pos_Y, pos_Zs, kvec,
                          n_obs: float) -> List[TestResult]:
        stat, pval, df, suff = self.fz_tests_from_cor_raw(
            C, pos_X, pos_Y, pos_Zs, kvec, n_obs
        )
        return [
            TestResult(float(stat[i]), float(pval[i]), int(df[i]),
                       bool(suff[i]))
            for i in range(len(pos_X))
        ]

    def nz_pair_count(self, X: int, Y: int) -> int:
        """Rows where both variables are nonzero (the doubly-trimmed view size)."""
        d = self.data_np
        return int(((d[:, X] != 0) & (d[:, Y] != 0)).sum())

    def fz_tests_iterative(self, X: int, Y: int,
                           Zs_list: Sequence[Tuple[int, ...]]) -> List[TestResult]:
        """Regression-based partial correlation (recursive_pcor=False mode,
        reference: src/statfuns.jl:19-21 + src/tests.jl:250-265)."""
        d = self.data_np.astype(np.float64)
        if self.nz:
            mask = (d[:, X] != 0) & (d[:, Y] != 0)
            d = d[mask]
        n_obs = d.shape[0]
        if n_obs < self.n_obs_min:
            return [TestResult(0.0, 1.0, 0, False)] * len(Zs_list)
        out = []
        for Zs in Zs_list:
            stat = sf.pcor_iterative(X, Y, Zs, d)
            pval = float(sf.fz_pval(np.float64(stat), n_obs, 0))
            out.append(TestResult(stat, pval, 0, True))
        return out
