"""Contingency tables of discrete variables, in plain PyTorch.

PyTorch counterpart of ``flashweave_tpu/ops/contingency.py`` (reference:
src/contingency.jl).  Pairwise tables are one-hot products, so all pairs of
an X-block against a Y-slab are one matrix product.  Stratified 3-way tables
(X, Y | Z) are cell histograms: every row of every test folds (x, y, z-code)
into one cell index and the counts come from one ``scatter_add_`` over the
flattened (test, cell) codes.  The one-hot (n, B, L*S) intermediate of the
JAX package's CPU branch is never built (5.4 GB in float64 at B=4096,
n=2048, L*S=81).

The z-stratum hash (reference ZMapper, src/types.jl:26-51) is the radix code
z = sum_j Z_j * L^j; when L^max_k outgrows the power-check bound, codes are
remapped to dense occupied ranks per test (:func:`_remap_strata`).
"""

from __future__ import annotations

import torch


def onehot_encode(data: torch.Tensor, L: int) -> torch.Tensor:
    """(n, p) integer matrix -> (n, p, L) one-hot in float64."""
    lv = torch.arange(L, device=data.device)
    return (data[..., None].long() == lv).to(torch.float64)


def pair_ctab_block(data: torch.Tensor, start: int, tile: int, L: int,
                    y_start: int = 0, y_len=None) -> torch.Tensor:
    """Contingency tables of the X-block [start, start+tile) against the
    Y-slab [y_start, y_start+y_len) (default: all variables).

    Args:
      data: (n, p) discrete values in 0..L-1 (any integer or float dtype).
    Returns:
      (tile, y_len, L, L) float64; ctab[t, q, a, b] = #rows with
      X_{start+t} == a and Y_{y_start+q} == b.  Counts are exact: products
      of 0/1 values summed in float64.
    """
    n = data.shape[0]
    if y_len is None:
        y_len = data.shape[1]
    enc = onehot_encode(data[:, y_start:y_start + y_len], L)    # (n, y_len, L)
    enc_block = onehot_encode(data[:, start:start + tile], L)   # (n, tile, L)
    a = enc_block.permute(1, 2, 0).reshape(tile * L, n)
    b = enc.reshape(n, y_len * L)
    ctab = (a @ b).reshape(tile, L, y_len, L)
    return ctab.permute(0, 2, 1, 3)


def _remap_strata(zcode: torch.Tensor, row_mask: torch.Tensor, S_cap: int):
    """Dense occupied-stratum ranks per test, the batched equivalent of the
    reference's lazy ZMapper (reference: src/types.jl:26-51).  Only stratum
    distinctness matters to the G-test and the adjusted df, so z-codes are
    replaced by their per-test rank among occupied codes.

    Returns (ranks (n, B) int64 clipped to S_cap-1, occupied (B,) int64).
    Tests with more than S_cap occupied strata get merged trailing strata;
    their power check fails anyway (occupied > n/hps), and the caller receives
    the EXACT occupied count."""
    big = 1 << 30
    codesT = torch.where(row_mask, zcode, big).T                 # (B, n)
    sc, order = torch.sort(codesT, dim=1, stable=True)
    new = torch.ones_like(sc, dtype=torch.bool)
    new[:, 1:] = sc[:, 1:] != sc[:, :-1]
    new &= sc < big
    ranks_sorted = torch.cumsum(new.long(), dim=1) - 1
    occ = new.sum(dim=1)
    ranks = torch.empty_like(ranks_sorted).scatter_(1, order, ranks_sorted)
    return torch.clamp(ranks, 0, S_cap - 1).T, occ


def cond_ctab_batch(data: torch.Tensor, X: torch.Tensor, Y: torch.Tensor,
                    Zs: torch.Tensor, kvec: torch.Tensor,
                    row_mask: torch.Tensor, max_k: int, L: int, S: int,
                    reduced: bool = False):
    """Stratified contingency tables for a batch of (X, Y, Zs) descriptors
    (replaces the reference's sparse N-column merge-join backend,
    src/contingency.jl:300-480).

    Args:
      data: (n, p) integer table with values in 0..L-1.
      X, Y: (B,) int64 column indices.
      Zs:   (B, max_k) int64 conditioning columns (entries >= kvec ignored).
      kvec: (B,) conditioning-set sizes.
      row_mask: (n, B) bool -- rows included per test (the reference's
        dense-path view trimming, src/hiton.jl:41-50).
      S: stratum-table width.  When S < L^max_k the z-codes are remapped to
        dense occupied ranks; the second return value is then the EXACT
        per-test occupied-stratum count.
      reduced: every test is nz-adjusted with 3-level X and Y: the x=0 / y=0
        cells are empty by the row mask, so the histogram spans only the
        (L-1)^2 * S sliced cells and the table is (B, L-1, L-1, S).
    Returns:
      ((B, L, L, S) float64 tables over the masked rows ((L-1)^2 when
       reduced), (B,) occupied counts or None when S == L^max_k).

    Masked rows go to one spare bin past the end, so no step needs the
    count of selected rows on the host: the whole function enqueues on the
    device without a synchronisation.
    """
    n = data.shape[0]
    B = X.shape[0]
    x = data[:, X].long()                                   # (n, B)
    y = data[:, Y].long()
    zcode = torch.zeros((n, B), dtype=torch.long, device=data.device)
    for j in range(max_k):
        zj = data[:, Zs[:, j]].long()
        zcode += torch.where(j < kvec[None, :], zj * (L ** j), 0)

    occ = None
    if S < L ** max_k:
        zcode, occ = _remap_strata(zcode, row_mask, S)

    Lr = L - 1 if reduced else L
    C = Lr * Lr * S
    if reduced:
        cell = (x - 1) + Lr * (y - 1) + (Lr * Lr) * zcode
    else:
        cell = x + L * y + (L * L) * zcode
    test = torch.arange(B, device=data.device, dtype=torch.long)[None, :]
    flat = torch.where(row_mask, test * C + cell, B * C)
    cnt = torch.zeros(B * C + 1, dtype=torch.int32, device=data.device)
    cnt.scatter_add_(0, flat.reshape(-1),
                     torch.ones(flat.numel(), dtype=torch.int32,
                                device=data.device))
    # cell = x + Lr*y + Lr^2*z  ->  (B, S, y_level, x_level) -> (B, Lr, Lr, S)
    ctab = cnt[:B * C].reshape(B, S, Lr, Lr).permute(0, 3, 2, 1)
    return ctab.to(torch.float64), occ


def slice_mask(ctab: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor):
    """Zero the table cells removed by nz-adjustment (reference:
    src/statfuns.jl:313-323): level-rows a < ox and level-cols b < oy.

    ctab: (..., L, L, S); ox, oy: (...,) integer offsets in {0, 1}."""
    L = ctab.shape[-3]
    a = torch.arange(L, device=ctab.device)
    keep = (a[:, None, None] >= ox[..., None, None, None]) & (
        a[None, :, None] >= oy[..., None, None, None]
    )
    return ctab * keep.to(ctab.dtype)
