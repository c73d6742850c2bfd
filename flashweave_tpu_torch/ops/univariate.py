"""Batched all-pairs univariate association tests.

PyTorch counterpart of ``flashweave_tpu/ops/univariate.py`` (reference:
src/tests.jl:370-532 ``pw_univar_neighbors``).  The pass walks X-variable
blocks against triangle Y-slabs.  Each block's statistics come from a
hand-written CUDA kernel on the card and from its plain PyTorch version on
the CPU:

- mi / mi_nz: (stat, df, n_obs, suff) from the fused G-test, chosen from
  the table's level count L before any launch (:func:`mi_block_fn`): K1
  (:func:`..ops.kernels.mi_univar_stats`, one sweep of the int8 tile loop
  with the epilogue fused) for L = 2..4, K4
  (:func:`..ops.kernels.mi_univar_stats_planes`, the joint counts through a
  slab in device memory) for L = 5..127, and for L >= 128 the plain
  pair-table route (:func:`..ops.kernels.mi_univar_stats_ref`, the JAX
  package's XLA route there) on an int16 table, with the tile cut so that
  one block's float64 tables stay under ~1 GB (:func:`_pair_table_tile`);
- fz_nz: the masked Pearson r and the joint nonzero count N
  (:func:`..ops.kernels.fz_nz_stats`, K2; plain version :func:`fz_nz_block`);
- fz: the Pearson r of the block from the centered table
  (:func:`_fz_center`, :func:`fz_block`), one float64 ``torch.matmul`` a
  block, as the JAX package computes it outside any Pallas kernel.

By default the blocks never leave the device (:func:`_extract`): each
block's float64 log p-values (``statfuns.mi_logpval_smalldf`` /
``fz_logpval``) are computed beside its kernel outputs, only the candidate
pairs below a BH-safe edge are kept, Benjamini-Hochberg runs in log space
over them on the device, and only the significant pairs reach the host.
``return_result=True`` keeps the host path: every block condensed on the
host into p^2/2 float64 vectors, scipy p-values and BH there (the
reference keeps all statistics in Float64).  fz also takes the host path
over an explicit ``cor_mat`` (the JAX package's ``have_cor``).

On a device mesh (``parallel.mesh``, ``mesh=``) each block's Y-slab is
split into ``mesh.size`` contiguous device-major pieces, and each shard
launches the same block function on its own piece of its replica of the
table (:class:`_ShardedBlocks`; the JAX package's ``shard_map`` of
``_passA_fn`` / ``_passB_fn`` and ``_mesh_*_block_fn``).  The extraction
sums the per-edge and unreliable counts over the shards, checks
``EXTRACT_BUDGET`` against the global count, gathers the candidates and runs
BH on the primary device; the host path gathers each block along Y.  Every
pair is computed by the same kernel as without a mesh, so the neighbor
dicts are the same.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from . import statfuns as sf
from .kernels import (K1_LEVELS, PLANES_LEVELS, fz_nz_stats, mi_univar_stats,
                      mi_univar_stats_planes, mi_univar_stats_ref,
                      pair_ctab_planes)
from ..parallel.mesh import gather, psum, put_replicated
from ..types import PSortedNbrs
from ..utils.misc import is_zero_adjusted, isdiscrete


def mi_block_stats(ctab: torch.Tensor, levels_x, levels_y, maxv_x, maxv_y,
                   hps: float, n_obs_min: float, nz, L: int):
    """Univariate MI G-test statistics from a block of pair tables
    (reference: src/tests.jl:28-77): nz slicing, power pre/post checks,
    signed MI, df adjustment.

    Shapes: ctab (t, q, L, L) float; levels_x/maxv_x (t,); levels_y/maxv_y
    (q,) integer tensors on ctab's device.  ``nz`` is 0, 1 or 2 (2 = every
    variable has 3 levels; same arithmetic as 1).  Returns (stat, df, n_obs,
    suff) with df int64 and n_obs in ctab's dtype."""
    t, q = ctab.shape[:2]
    dev = ctab.device
    lx = levels_x[:, None].to(ctab.dtype)
    ly = levels_y[None, :].to(ctab.dtype)
    a = torch.arange(L, device=dev)
    if nz:
        ox = (maxv_x > 1).long()[:, None].expand(t, q)
        oy = (maxv_y > 1).long()[None, :].expand(t, q)
        keep = (a[:, None] >= ox[..., None, None]) & (a[None, :] >= oy[..., None, None])
        sub = ctab * keep.to(ctab.dtype)
        lx_eff = (L - ox).to(ctab.dtype)               # size of sliced table
        ly_eff = (L - oy).to(ctab.dtype)
        # rows of the X-trimmed view (pre-check n_obs): all rows with x >= ox
        rowkeep = (a[:, None] >= ox[..., None, None]).expand(t, q, L, L)
        n_view = (ctab * rowkeep.to(ctab.dtype)).sum(dim=(-2, -1))
    else:
        ox = torch.zeros((t, q), dtype=torch.long, device=dev)
        oy = ox
        sub = ctab
        lx_eff = lx.expand(t, q)
        ly_eff = ly.expand(t, q)
        n_view = ctab.sum(dim=(-2, -1))

    stat, df, n_obs = sf.mi_stats(sub[..., None], ox, oy)

    # pre-check (reference src/tests.jl:9-20): offsets from LEVELS (>1 -> 2),
    # zero denominators pass (Julia n/0 == Inf)
    plx = lx - torch.where(lx > 1, 2.0, 1.0)
    ply = ly - torch.where(ly > 1, 2.0, 1.0)
    cells_pre = plx * ply
    pre_ok = (n_view >= n_obs_min) & torch.where(
        cells_pre > 0, n_view / torch.where(cells_pre > 0, cells_pre, 1.0) > hps,
        True)
    # post-check (reference src/tests.jl:56-62)
    cells_post = lx_eff * ly_eff
    post_ok = (n_obs >= n_obs_min) & torch.where(
        cells_post > 0, n_obs / torch.where(cells_post > 0, cells_post, 1.0) > hps,
        True)
    # X variables with < 2 levels never test (reference src/tests.jl:86-92)
    suff = pre_ok & post_ok & (lx >= 2)
    stat = torch.where(suff, stat, 0.0)
    df = torch.where(suff, df, 0)
    return stat, df, n_obs, suff


def mi_planes_stats(planes: torch.Tensor, levels_x, levels_y, maxv_x, maxv_y,
                    hps: float, n_obs_min: float, nz, L: int):
    """:func:`mi_block_stats` on (L*L, t, q) int32 contingency planes (K3's
    layout, plane a*L + b), as float64 tables."""
    t, q = planes.shape[1:]
    ctab = planes.view(L, L, t, q).permute(2, 3, 0, 1).to(torch.float64)
    return mi_block_stats(ctab, levels_x, levels_y, maxv_x, maxv_y, hps,
                          n_obs_min, nz, L)


def mi_planes_block(dataT, marg, levels, max_vals, start, tile, L, y_start=0,
                    y_len=None, nz=1, hps=5.0, n_obs_min=0.0):
    """The "planes" block route of the mi / mi_nz pass, with K1's signature:
    all L*L contingency planes of the block from K3
    (:func:`..ops.kernels.pair_ctab_planes`), then :func:`mi_planes_stats`.
    ``marg`` is unused (the planes hold every cell).  Returns (stat float64,
    df int32, n_obs int32, suff bool), each (tile, y_len)."""
    if y_len is None:
        y_len = dataT.shape[0]
    planes = pair_ctab_planes(dataT, start, tile, L, y_start, y_len)
    stat, df, n_obs, suff = mi_planes_stats(
        planes, levels[start:start + tile], levels[y_start:y_start + y_len],
        max_vals[start:start + tile], max_vals[y_start:y_start + y_len],
        hps, n_obs_min, nz, L)
    return stat, df.to(torch.int32), n_obs.to(torch.int32), suff


def fz_nz_block(data: torch.Tensor, start: int, tile: int, y_start: int = 0,
                y_len: Optional[int] = None):
    """Masked pairwise correlation of an X-block against a Y-slab (default:
    all variables) over rows where both are nonzero (reference:
    src/statfuns.jl:91-123 with nz=true), as six moment products in the
    table's dtype.  Returns (r, N), each (tile, y_len); N in the table's
    dtype.  0/0 gives NaN, which propagates; +-inf clamps to +-1; N == 0
    gives 0 (the JAX package's ``fz_nz_block``)."""
    n, p = data.shape
    if y_len is None:
        y_len = p
    yslab = data[:, y_start:y_start + y_len]
    nzmask = (yslab != 0).to(data.dtype)
    xslab = data[:, start:start + tile]
    mb = (xslab != 0).to(data.dtype)
    db = xslab * mb
    dm = yslab * nzmask
    N = mb.T @ nzmask                                 # joint nonzero counts
    Sx = db.T @ nzmask                                # sum x over joint rows
    Sy = mb.T @ dm
    Sxx = (db * db).T @ nzmask
    Syy = mb.T @ (dm * dm)
    Sxy = db.T @ dm
    safe_n = torch.where(N > 0, N, 1.0)
    cov = Sxy - Sx * Sy / safe_n
    varx = Sxx - Sx * Sx / safe_n
    vary = Syy - Sy * Sy / safe_n
    r = cov / torch.sqrt(varx * vary)                 # 0/0 -> NaN, x/0 -> inf
    r = torch.where(r > 1.0, 1.0, r)
    r = torch.where(r < -1.0, -1.0, r)
    r = torch.where(N > 0, r, 0.0)                    # n_obs == 0 -> stat 0
    return r, N


def put_continuous(data, device="cuda") -> torch.Tensor:
    """Device placement of a continuous (fz_nz) table: one contiguous
    float64 (n, p) upload (:func:`..state.from_numpy_continuous`)."""
    from ..state import from_numpy_continuous

    return from_numpy_continuous(data, device)


def _fz_center(data, device="cuda"):
    """(xc, ssd) of the blocked fz sweep: the column-centered float64 table
    and each column's sqrt(sum(xc^2)), on the table's device (a numpy table
    is uploaded to ``device``)."""
    x = (data.to(torch.float64) if isinstance(data, torch.Tensor)
         else put_continuous(data, device))
    xc = x - x.mean(dim=0, keepdim=True)
    return xc, torch.sqrt((xc * xc).sum(dim=0))


def fz_block(xc, ssd, start: int, tile: int, y_start: int = 0,
             y_len: Optional[int] = None) -> torch.Tensor:
    """Pearson r of an X-block against a Y-slab (default: all variables)
    from :func:`_fz_center`'s output: one float64 ``torch.matmul``, divided
    by ssd_X ssd_Y, NaN where that product is 0, clamped to [-1, 1].  A
    zero ssd is an all-zero centered column, whose products are 0, so the
    division itself gives 0/0 = NaN there; in place, the block and the
    product of the ssd are the only (tile, y_len) tensors."""
    if y_len is None:
        y_len = xc.shape[1]
    cov = torch.matmul(xc[:, start:start + tile].T,
                       xc[:, y_start:y_start + y_len])
    cov /= ssd[start:start + tile, None] * ssd[None, y_start:y_start + y_len]
    return cov.clamp_(-1.0, 1.0)


def cor_matrix(data, device="cuda") -> torch.Tensor:
    """The (p, p) Pearson correlation matrix in float64 on the table's
    device (a numpy table is uploaded to ``device``): :func:`fz_block` over
    every pair, one ``torch.matmul`` of the centered table (reference:
    Statistics.cor, src/learning.jl:44).  NaN where a column has zero
    variance; clamped to [-1, 1] as Julia's ``clampcor`` does, so that a
    copied column gives r = 1 and not 1 + eps (whose Fisher-z p-value would
    be NaN)."""
    xc, ssd = _fz_center(data, device)
    return fz_block(xc, ssd, 0, xc.shape[1])


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------

def _choose_tile(p: int, requested: Optional[int]) -> int:
    if requested is not None:
        return min(requested, p)
    return min(p, 512)


def condensed_pos(X, Y, p):
    """Row-major condensed position of pair (X < Y) in the n_pairs vector
    (reference layout: src/tests.jl:377-388)."""
    X = np.asarray(X, dtype=np.int64)
    Y = np.asarray(Y, dtype=np.int64)
    return X * (2 * p - X - 1) // 2 + (Y - X - 1)


def condensed_to_pair(idx, p):
    """Inverse of condensed_pos (vectorized), avoiding O(p^2) index tables."""
    idx = np.asarray(idx, dtype=np.int64)
    # solve X(2p - X - 1)/2 <= idx: X = floor((2p-1 - sqrt((2p-1)^2-8idx))/2)
    disc = (2 * p - 1) ** 2 - 8 * idx.astype(np.float64)
    X = ((2 * p - 1 - np.sqrt(disc)) / 2).astype(np.int64)
    # fp-correct the boundary
    for _ in range(2):
        base = X * (2 * p - X - 1) // 2
        X = np.where(base > idx, X - 1, X)
        base = X * (2 * p - X - 1) // 2
        too_low = idx - base >= (p - 1 - X)
        X = np.where(too_low, X + 1, X)
    base = X * (2 * p - X - 1) // 2
    Y = idx - base + X + 1
    return X, Y


def _condense_block(s, t, p, blocks, outs, y_start=0):
    """Scatter a (tile, y_len) block slab's X<Y entries (Y < p) into the
    condensed output vectors.  Column q of the slab is variable y_start+q."""
    y_len = blocks[0].shape[1]
    ys = np.arange(y_start, min(y_start + y_len, p))
    rows, cols = np.nonzero(np.arange(s, s + t)[:, None] < ys[None, :])
    pos = condensed_pos(rows + s, ys[cols], p)
    for blk, out in zip(blocks, outs):
        out[pos] = blk[rows, cols]


def _y_slabs(p_int: int, tile_sz: int, triangle: bool):
    """Per-X-block Y-slab choices [y_start, p_int) for the pair sweep.

    With triangle=True each slab covers only Y >= x_start (every X<Y pair is
    still produced exactly once), bucketed to at most ~8 distinct slab
    lengths.  Cuts device work ~1.8x versus the full rectangle."""
    if not triangle:
        return lambda s: (0, p_int)
    step = max(tile_sz, -(-p_int // (8 * tile_sz)) * tile_sz)

    def slab(s):
        y_len = min(p_int, -(-(p_int - s) // step) * step)
        return p_int - y_len, y_len

    return slab


class UnivarResult:
    """All-pairs statistics in condensed (X < Y) layout."""

    def __init__(self, p, stats, pvals, suff_power):
        self.p = p
        self.stats = stats          # (n_pairs,) float64, raw stats
        self.pvals = pvals          # (n_pairs,) float64 (NaN = unreliable)
        self.suff_power = suff_power

    def neighbor_dicts(self, alpha: float) -> Dict[int, dict]:
        """Per-variable neighbor dicts of significant pairs (reference:
        src/tests.jl:372-388)."""
        p = self.p
        nbr = {X: {} for X in range(p)}
        with np.errstate(invalid="ignore"):
            sig = self.pvals < alpha        # NaN -> False
        sig_idx = np.nonzero(sig)[0]
        Xs, Ys = condensed_to_pair(sig_idx, p)
        for idx, X, Y in zip(sig_idx, Xs, Ys):
            entry = (float(self.stats[idx]), float(self.pvals[idx]))
            nbr[int(X)][int(Y)] = entry
            nbr[int(Y)][int(X)] = entry
        return nbr


def mi_block_fn(L: int):
    """The default block function of the mi / mi_nz pass for a table of L
    levels: K1 for L = 2..4 and K4 for L = 5..127 (as the JAX package runs
    its Pallas kernel for every L < 128; the split is the faster kernel at
    each L on an H100, PERF.md), the plain pair-table route past that (as
    the JAX package takes its XLA route)."""
    if L in K1_LEVELS:
        return mi_univar_stats
    if L < PLANES_LEVELS.stop:
        return mi_univar_stats_planes
    return mi_univar_stats_ref


# one block's float64 pair tables on the plain pair-table route (L >= 128)
PAIR_TABLE_BYTES = 1 << 30


def _pair_table_tile(tile_sz: int, L: int, p: int) -> int:
    """X-block size of the plain pair-table route: at most ``tile_sz``, and
    small enough that a (tile, p, L, L) float64 table fits PAIR_TABLE_BYTES."""
    return max(1, min(tile_sz, PAIR_TABLE_BYTES // (8 * L * L * p)))


def _sweep_blocks(p: int, tile_sz: int):
    """(start, tile, y_start, y_len) of every block of the triangle sweep."""
    slab = _y_slabs(p, tile_sz, triangle=True)
    for s in range(0, p, tile_sz):
        y_start, y_len = slab(s)
        yield s, min(tile_sz, p - s), y_start, y_len


class _ShardedBlocks:
    """One block function a local shard of ``mesh``, each bound to the
    shard's replica of the table.  :meth:`units` splits a block's Y-slab
    into the shards' pieces; calling the object runs every local piece and
    gathers the block along Y (the host path)."""

    def __init__(self, mesh, blocks):
        self.mesh = mesh
        self.blocks = blocks

    def units(self, y_start, y_len):
        """(local shard, y0, ylen) of this process's nonempty pieces."""
        for i, a, b in self.mesh.shard_ranges(y_len):
            if b > a:
                yield i, y_start + a, b - a

    def __call__(self, s, t, y_start, y_len):
        outs = []
        for i, a, b in self.mesh.shard_ranges(y_len):
            if b > a:
                outs.append(self.blocks[i](s, t, y_start + a, b - a))
            else:       # an empty piece: a zero-width slice of the outputs
                outs.append(tuple(o[:, :0] if o.dim() > 1 else o for o in
                                  self.blocks[i](s, t, y_start, 1)))
        return tuple(gather(self.mesh, col, dim=1) if col[0].dim() > 1
                     else col[0].to(self.mesh.primary) for col in zip(*outs))


def _bind(bind, tables, mesh):
    """``bind(*tables)`` without a mesh; with one, :class:`_ShardedBlocks`
    of ``bind`` over each shard's replicas of ``tables``."""
    if mesh is None:
        return bind(*tables)
    reps = zip(*(put_replicated(t, mesh) for t in tables))
    return _ShardedBlocks(mesh, [bind(*r) for r in reps])


def _mi_blocks(data, test_name, hps, n_obs_min, levels, max_vals, tile_sz,
               state, device, block_fn, mesh=None):
    """The mi / mi_nz pass's block function, bound to the table on the
    device (on each shard of ``mesh``): returns (block, tile, max_df), where
    block(s, t, y_start, y_len) gives (stat, df, n_obs, suff) and max_df
    bounds every df of the table.
    """
    p = data.shape[1]
    nz = int(is_zero_adjusted(test_name))
    if state is None:
        from ..state import from_numpy_state

        state = from_numpy_state(data, levels, max_vals, device)
    L = state.L
    if block_fn is None:
        block_fn = mi_block_fn(L)
    if L >= PLANES_LEVELS.stop:
        tile_sz = _pair_table_tile(tile_sz, L, p)
    if nz and L == 3 and (state.max_vals_np > 1).all():
        # 3-state nz flag: 2 = nz-UNIFORM (every variable 3-level)
        nz = 2
    # df counts a pair table's nonzero rows and columns, so it is at most
    # (lv - 1)^2 for lv the smaller of L and the most levels of a variable
    max_lv = min(L, int(state.levels_np.max(initial=1)))
    max_df = (max_lv - 1) ** 2

    def bind(st):
        return lambda s, t, y_start, y_len: block_fn(
            st.dataT, st.marg, st.levels, st.max_vals, s, t, L, y_start,
            y_len, nz, float(hps), float(n_obs_min))

    return _bind(bind, (state,), mesh), tile_sz, max_df


def _fz_nz_blocks(data, table, device, block_fn, mesh=None):
    """The fz_nz pass's block function (default K2) bound to the float64
    table on the device (on each shard of ``mesh``):
    block(s, t, y_start, y_len) gives (r, N)."""
    if block_fn is None:
        block_fn = fz_nz_stats
    if table is None:
        table = put_continuous(data, device)

    def bind(tb):
        return lambda s, t, y_start, y_len: block_fn(tb, s, t, y_start,
                                                     y_len)

    return _bind(bind, (table,), mesh)


def _fz_blocks(data, table, device, mesh=None):
    """The fz pass's block function bound to the centered table on the
    device (centered once, then on each shard of ``mesh``):
    block(s, t, y_start, y_len) gives (r, n), n the row count as a 0-dim
    tensor (every pair is tested over all rows)."""
    xc, ssd = _fz_center(data if table is None else table, device)
    n = torch.tensor(float(xc.shape[0]), dtype=torch.float64,
                     device=xc.device)

    def bind(xc, ssd, n):
        return lambda s, t, y_start, y_len: (fz_block(xc, ssd, s, t, y_start,
                                                      y_len), n)

    return _bind(bind, (xc, ssd, n), mesh)


def _mi_pass(block, p, tile_sz):
    """(stats, pvals, suff) of the mi / mi_nz host path (reference:
    src/tests.jl:28-103): kernel blocks, condensed, float64 G-test
    p-values."""
    n_pairs = p * (p - 1) // 2
    stats = np.empty(n_pairs)
    df_c = np.empty(n_pairs, dtype=np.int64)
    nobs_c = np.empty(n_pairs, dtype=np.int64)
    suff = np.empty(n_pairs, dtype=bool)
    for s, t, y_start, y_len in _sweep_blocks(p, tile_sz):
        stat, df, n_obs, sp = block(s, t, y_start, y_len)
        _condense_block(
            s, t, p,
            [stat.cpu().numpy(), df.cpu().numpy(), n_obs.cpu().numpy(),
             sp.cpu().numpy()],
            [stats, df_c, nobs_c, suff],
            y_start=y_start,
        )
    pvals = sf.mi_pval(stats, df_c, nobs_c)
    pvals = np.where(df_c > 0, pvals, 1.0)
    pvals = np.where(suff, pvals, 1.0)
    stats = np.where(suff, stats, 0.0)
    return stats, pvals, suff


def _fz_nz_pass(block, p, tile_sz, n_obs_min):
    """(stats, pvals, suff) of the fz_nz host path: K2 blocks, condensed,
    n_obs_min forcing (reference src/tests.jl:121-125), float64 Fisher-z
    p-values."""
    n_pairs = p * (p - 1) // 2
    stats = np.empty(n_pairs)
    n_obs = np.empty(n_pairs, dtype=np.int64)
    for s, t, y_start, y_len in _sweep_blocks(p, tile_sz):
        r, N = block(s, t, y_start, y_len)
        _condense_block(s, t, p, [r.cpu().numpy(), N.cpu().numpy()],
                        [stats, n_obs], y_start=y_start)
    # n_obs < n_obs_min -> stat forced to 0 (reference src/tests.jl:121-125)
    stats = np.where(n_obs >= n_obs_min, stats, 0.0)
    suff = n_obs >= n_obs_min
    pvals = sf.fz_pval(stats, n_obs, 0)
    return stats, pvals, suff


# ---------------------------------------------------------------------------
# device extraction of the significant pairs (the default route)
#
# The host path above holds all p^2/2 pairs in float64 on the host (17 GB an
# array at p = 65,536) and evaluates scipy p-values over them.  The
# extraction keeps every block on the device: its float64 log p-values come
# from the block's kernel outputs, and only the candidate pairs, those below
# an edge that every BH-significant p-value lies under, are kept.  BH then
# runs in log space over the candidates, sorted on the device, and only the
# significant pairs cross to the host.
#
#   sweep 1: per block, the counts of log p below 48 geometric edges
#            (e_0 = log alpha down to log(alpha / 4m)), the unreliable count,
#            and the candidates below e_0 while their total stays within
#            EXTRACT_BUDGET.  Every pair left out has p >= alpha, so BH over
#            the candidates ranks them as over all pairs.
#   sweep 2: only when sweep 1 ran past the budget: the BH-safe edge
#            e_b (_select_bin: the smallest edge provably above every
#            BH-significant p) from the counts, then the blocks again,
#            keeping the candidates below e_b.  Past the budget at e_b the
#            extraction refuses; it never returns a truncated set.
#
# (The JAX package's _extract_scan always runs both sweeps, with per-block
# caps and chunk compaction that XLA's static shapes need; here a boolean
# mask and torch.nonzero give exact sizes.)
# ---------------------------------------------------------------------------

N_EXTRACT_BINS = 48
EXTRACT_BUDGET = 1 << 26  # candidates held on the device (24 B each)


def _extract_edges(alpha: float, n_pairs: int) -> np.ndarray:
    """Decreasing log p-value edges e_0 = log(alpha) .. log(alpha/(4m)).

    Everything below the last edge is automatically BH-significant
    (p < alpha/m implies p <= alpha*rank/m for any rank >= 1), so the edge
    grid only needs to resolve the region where the BH cutoff can fall; the
    geometric spacing bounds extraction overshoot to ~45% of the pair count
    in the cutoff's own bin."""
    la = math.log(alpha)
    return np.linspace(la, la - math.log(4.0 * max(float(n_pairs), 2.0)),
                       N_EXTRACT_BINS)


def _select_bin(counts: np.ndarray, m: float, alpha: float,
                edges: np.ndarray) -> int:
    """Smallest bin index b such that the extraction edge e_b provably
    exceeds every BH-significant p-value.

    A significant p in bin b (edges[b+1] <= log p < edges[b]) satisfies
    p <= alpha * rank(p) / m with rank(p) <= counts[b], so a bin with
    edges[b+1] > log(alpha * counts[b] / m) cannot contain one; the first
    bin violating that bound is the safe (and tight, to one bin) choice.
    Falls through to the auto-significant last bin."""
    la = math.log(alpha)
    lm = math.log(max(m, 1.0))
    for b in range(len(edges) - 1):
        if counts[b] > 0 and edges[b + 1] <= la + math.log(counts[b]) - lm:
            return b
    return len(edges) - 1


def _block_scores(kind, outs, s, y_start, reliable, n_obs_min=0.0,
                  max_df=0):
    """One block's kernel outputs reduced to extraction scores.

    ``outs`` is (stat, df, n_obs, suff) for kind "mi" and (r, N) for
    "fz_nz" and "fz" (stat forced to 0 and the pair unreliable where
    N < n_obs_min; for fz, N is the 0-dim row count, so that either every
    pair is reliable or none is).
    Returns (logp, stat, n_unreliable): logp is the float64 log p-value,
    +inf where the slot is no pair (X >= Y) and, for an unreliable pair,
    +inf with ``reliable`` (correct_reliable_only) and 0 (p = 1) without.
    A NaN log p-value (a zero-variance correlation) counts as unreliable, as
    the host path drops NaN p-values from BH's m (the JAX package's
    extraction does not: ROADMAP queue 3)."""
    if kind == "mi":
        stat, df, n_obs, suff = outs
        logp = sf.mi_logpval_smalldf(stat, df, n_obs, max_df)
    else:                                 # "fz_nz" and "fz"
        r, N = outs
        suff = N >= n_obs_min
        stat = torch.where(suff, r, 0.0)
        logp = sf.fz_logpval(stat, N, 0)
    t, q = logp.shape
    dev = logp.device
    valid = (torch.arange(s, s + t, device=dev)[:, None]
             < torch.arange(y_start, y_start + q, device=dev)[None, :])
    unrel = valid & (~suff | torch.isnan(logp))
    logp = torch.where(unrel, math.inf if reliable else 0.0, logp)
    logp = torch.where(valid, logp, math.inf)
    return logp, stat, unrel.sum()


def _units(block, blocks):
    """(block function, local shard, s, t, y0, ylen) of every kernel call
    of a sweep over ``blocks``: each block whole, or under a mesh
    (:class:`_ShardedBlocks`) this process's pieces of its Y-slab."""
    for s, t, y_start, y_len in blocks:
        if isinstance(block, _ShardedBlocks):
            for i, y0, ylen in block.units(y_start, y_len):
                yield block.blocks[i], i, s, t, y0, ylen
        else:
            yield block, 0, s, t, y_start, y_len


def _add(total, x):
    return x if total is None else total + x.to(total.device)


def _sweep(kind, block, blocks, thresh, reliable, n_obs_min, max_df,
           edges=None, calls=None):
    """One pass over the blocks, keeping the candidates (logp < thresh)
    while their total stays within EXTRACT_BUDGET.  With ``edges`` (numpy) it
    also counts, in int64 on the device, the log p-values below each edge
    and the unreliable pairs.  ``calls`` (a list a local shard) receives
    the block calls of each shard.

    Returns (n_candidates, candidates, counts, n_unreliable); candidates
    are (X int32, Y int32, logp, stat) on the device, or None past the
    budget or when there are none.  Each block syncs with the host once, in
    torch.nonzero.  Under a mesh the counts and n_candidates are summed
    over every shard, and the candidates gathered onto the primary device,
    on every process."""
    mesh = block.mesh if isinstance(block, _ShardedBlocks) else None
    kept, parts = 0, []
    counts = unrel = None
    for fn, i, s, t, y0, ylen in _units(block, blocks):
        logp, stat, n_unrel = _block_scores(kind, fn(s, t, y0, ylen), s, y0,
                                            reliable, n_obs_min, max_df)
        if calls is not None:
            calls[i] += 1
        idx = torch.nonzero(logp.view(-1) < thresh).squeeze(1)
        lp = logp.view(-1)[idx]
        if edges is not None:
            e = torch.as_tensor(edges, dtype=torch.float64, device=lp.device)
            counts = _add(counts, (lp[:, None] < e[None, :]).sum(dim=0))
            unrel = _add(unrel, n_unrel)
        kept += idx.numel()
        if parts is not None and kept > EXTRACT_BUDGET:
            parts = None                  # past the budget: count only
        if parts is not None:
            parts.append((((idx // ylen) + s).to(torch.int32),
                          ((idx % ylen) + y0).to(torch.int32), lp,
                          stat.reshape(-1)[idx]))
        del logp, stat, lp, idx
    if mesh is not None:
        return _mesh_totals(mesh, kept, parts, counts, unrel, edges)
    if parts is not None:
        parts = [torch.cat(c) for c in zip(*parts)] if parts else None
    return kept, parts, counts, unrel


def _mesh_totals(mesh, kept, parts, counts, unrel, edges):
    """:func:`_sweep`'s results summed over every shard of ``mesh`` (the
    JAX package's psum of pass A's counts): the global candidate count
    decides the budget on every process alike, and within it the
    candidates are gathered device-major onto the primary device."""
    dev = mesh.primary
    kept = int(psum(mesh, torch.tensor([kept], dtype=torch.int64,
                                       device=dev)))
    if edges is not None:
        zero = torch.zeros(len(edges), dtype=torch.int64, device=dev)
        counts = psum(mesh, zero if counts is None else counts)
        unrel = psum(mesh, zero[0] if unrel is None else unrel)
    if kept == 0 or kept > EXTRACT_BUDGET:
        return kept, None, counts, unrel
    dtypes = (torch.int32, torch.int32, torch.float64, torch.float64)
    cols = zip(*parts) if parts else ([] for _ in dtypes)
    cand = [gather(mesh, list(c) or [torch.empty(0, dtype=d, device=dev)])
            for c, d in zip(cols, dtypes)]
    return kept, cand, counts, unrel


def _extract(kind, block, p, tile_sz, alpha, FDR, reliable, n_obs_min=0.0,
             max_df=0, info=None):
    """Neighbor dicts of the BH-significant pairs, swept on the device.

    Decisions are float64 on the device: log p-values, the candidate sort
    and BH.  The n_sig significant rows cross to the host in one transfer.
    ``info``, when given, receives the route ("one sweep" or "two sweeps"),
    K (the candidates BH ran over) and n_sig, and under a mesh
    ``shard_calls``, the block calls of each local shard."""
    n_pairs = p * (p - 1) // 2
    blocks = list(_sweep_blocks(p, tile_sz))
    edges = _extract_edges(alpha, n_pairs)
    la = math.log(alpha)
    calls = ([0] * len(block.blocks) if isinstance(block, _ShardedBlocks)
             else None)
    kept, cand, counts, unrel = _sweep(kind, block, blocks, la, reliable,
                                       n_obs_min, max_df, edges=edges,
                                       calls=calls)
    m = n_pairs - (int(unrel) if reliable else 0)
    route = "one sweep"
    if kept > EXTRACT_BUDGET:
        counts = counts.cpu().numpy()
        b_hat = _select_bin(counts, m, alpha, edges) if FDR else 0
        K = int(counts[b_hat])
        if K > EXTRACT_BUDGET:
            raise RuntimeError(
                f"{K} sub-threshold univariate pairs exceed the device "
                f"extraction budget ({EXTRACT_BUDGET}); the network is "
                "pathologically dense at this scale -- raise alpha and/or "
                "keep FDR enabled to shrink the significant set (the host "
                "path, return_result=True, holds O(p^2) float64)")
        kept, cand, _, _ = _sweep(kind, block, blocks, float(edges[b_hat]),
                                  reliable, n_obs_min, max_df, calls=calls)
        if kept != K:
            raise RuntimeError(
                f"the second univariate sweep found {kept} candidates where "
                f"the first counted {K}; refusing to return a different set")
        route = "two sweeps"
    n_sig = 0
    nbr = {i: PSortedNbrs() for i in range(p)}
    if kept:
        X, Y, lp, stat = cand
        slog, order = torch.sort(lp, stable=True)
        if FDR:
            ranks = torch.arange(1, kept + 1, dtype=torch.float64,
                                 device=lp.device)
            terms = torch.where(slog < la, slog + math.log(m) - torch.log(ranks),
                                math.inf)
            ladj = torch.flip(torch.cummin(torch.flip(terms, (0,)), 0).values,
                              (0,))
            ladj = torch.clamp(ladj, max=0.0)
        else:
            ladj = slog
        # ladj is nondecreasing: the significant pairs are a prefix
        n_sig = int((ladj < la).sum())
        order = order[:n_sig]
        rows = torch.stack([X[order].to(torch.float64),
                            Y[order].to(torch.float64), ladj[:n_sig],
                            stat[order]]).cpu().numpy()
        Xs, Ys = rows[0].astype(np.int64), rows[1].astype(np.int64)
        pvals, stats = np.exp(rows[2]), rows[3]
        # BH plateaus give exact ties in the adjusted p; the host path's
        # candidate order breaks them by condensed pair index (its dicts
        # insert in condensed order, then stable-sort by p), so these dicts
        # insert in that order too: HITON's candidate order depends on it
        tie = np.lexsort((condensed_pos(Xs, Ys, p), pvals))
        for x, y, st, pv in zip(Xs[tie], Ys[tie], stats[tie], pvals[tie]):
            entry = (float(st), float(pv))
            nbr[int(x)][int(y)] = entry
            nbr[int(y)][int(x)] = entry
    if info is not None:
        info.update(route=route, K=kept, n_sig=n_sig)
        if calls is not None:
            info["shard_calls"] = calls
    return nbr


def pw_univar_neighbors(
    data: np.ndarray,
    test_name: str = "mi",
    alpha: float = 0.01,
    hps: int = 5,
    n_obs_min: int = 0,
    FDR: bool = True,
    levels: Optional[np.ndarray] = None,
    max_vals: Optional[np.ndarray] = None,
    cor_mat=None,
    correct_reliable_only: bool = True,
    tile: Optional[int] = None,
    return_result: bool = False,
    state=None,
    device="cuda",
    block_fn=None,
    info: Optional[dict] = None,
    mesh=None,
):
    """All-pairs univariate pass (reference: src/tests.jl:436-532).

    Returns per-variable neighbor dicts {X: {Y: (stat, pval)}} (0-based) of
    FDR-significant pairs, each a :class:`..types.PSortedNbrs` whose
    insertion order is ascending p, from the device extraction
    (:func:`_extract`) on every device.  ``return_result=True`` takes the
    host path instead: the condensed all-pairs :class:`UnivarResult` and
    its dicts (in condensed order), with scipy float64 p-values.
    ``info`` (a dict) receives the extraction's route, K and n_sig.
    fz: a given ``cor_mat`` (the (p, p) correlation matrix as numpy) takes
    the host path over it, which returns its dicts alone unless
    ``return_result``; the host path without it builds
    :func:`cor_matrix` on the device.

    ``state`` is the table already on the device (``LGL`` uploads it
    once for this pass and the conditioning engine): a
    :class:`flashweave_tpu_torch.state.DiscreteState` for mi / mi_nz, the
    float64 tensor of :func:`..state.from_numpy_continuous` for fz and
    fz_nz.  Without it the table is uploaded here.  ``block_fn`` replaces
    the block function.  fz_nz: default :func:`..ops.kernels.fz_nz_stats` (K2), or its
    plain ``fz_nz_stats_ref``.  mi / mi_nz: default :func:`mi_block_fn`
    (K1 for L <= 4, K4 for L = 5..127, plain past that); the choices are
    :func:`..ops.kernels.mi_univar_stats` (K1, L = 2..4),
    :func:`..ops.kernels.mi_univar_stats_planes` (K4, L = 2..127),
    :func:`mi_planes_block` (K3's planes, then :func:`mi_planes_stats`) and
    the plain :func:`..ops.kernels.mi_univar_stats_ref`, used to check the
    kernels' decisions on the card.

    ``mesh`` (a :class:`..parallel.mesh.Mesh`) shards each block's Y-slab
    over its shards (:class:`_ShardedBlocks`); the table is uploaded to, or
    ``state`` read from, the mesh's primary device, and replicated once
    onto each other distinct device.  Every process of a multi-process
    mesh returns the same dicts.
    """
    p = data.shape[1]
    n_pairs = p * (p - 1) // 2
    tile_sz = _choose_tile(p, tile)
    if mesh is not None:
        device = mesh.primary
    if isdiscrete(test_name):
        block, tile_sz, max_df = _mi_blocks(data, test_name, hps, n_obs_min,
                                            levels, max_vals, tile_sz, state,
                                            device, block_fn, mesh)
        if not return_result:
            return _extract("mi", block, p, tile_sz, alpha, FDR,
                            correct_reliable_only, max_df=max_df, info=info)
        stats, pvals, suff = _mi_pass(block, p, tile_sz)
    elif test_name == "fz_nz":
        block = _fz_nz_blocks(data, state, device, block_fn, mesh)
        if not return_result:
            return _extract("fz_nz", block, p, tile_sz, alpha, FDR,
                            correct_reliable_only, n_obs_min=n_obs_min,
                            info=info)
        stats, pvals, suff = _fz_nz_pass(block, p, tile_sz, n_obs_min)
    elif test_name == "fz":
        have_cor = cor_mat is not None and np.size(cor_mat) > 0
        if not return_result and not have_cor:
            # blocked correlation sweep: the p x p matrix never exists
            return _extract("fz", _fz_blocks(data, state, device, mesh), p,
                            tile_sz, alpha, FDR, correct_reliable_only,
                            n_obs_min=n_obs_min, info=info)
        if have_cor:
            C = np.asarray(cor_mat, dtype=np.float64)[:p, :p]
        elif mesh is None:
            C = cor_matrix(data if state is None else state,
                           device).cpu().numpy()
        else:       # column slabs of the matrix (the JAX package's _mesh_fz_fn)
            C = _fz_blocks(data, state, device, mesh)(0, p, 0, p)[0]
            C = C.cpu().numpy()
        stats = C[np.triu_indices(p, 1)]
        del C
        n_obs = np.full(n_pairs, data.shape[0])
        suff = n_obs >= n_obs_min
        pvals = sf.fz_pval(stats, n_obs, 0)
        stats = np.where(suff, stats, 0.0)
        pvals = np.where(suff, pvals, 1.0)
    else:
        raise ValueError(f"{test_name} is not a valid test name")

    if correct_reliable_only:
        stats = np.where(suff, stats, np.nan)
        pvals = np.where(suff, pvals, np.nan)

    if FDR:
        m = n_pairs
        if correct_reliable_only:
            m -= int(np.isnan(pvals).sum())
        pvals = sf.benjamini_hochberg(pvals, alpha=alpha, m=m)

    result = UnivarResult(p, stats, pvals, suff)
    if return_result:
        return result.neighbor_dicts(alpha), result
    return result.neighbor_dicts(alpha)
