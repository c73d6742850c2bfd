"""Statistical functions: G-test mutual information, Fisher-z, partial
correlation, BH-FDR.

PyTorch counterpart of ``flashweave_tpu/ops/statfuns.py`` (reference:
src/statfuns.jl).  Two halves:

- host float64 functions on numpy/scipy (p-values, chi2 thresholds, the
  pcor DP, Benjamini-Hochberg), identical in formula and operation order to
  the JAX package's numpy branch, so p-values and FDR decisions agree bit
  for bit;
- tensor functions (:func:`mi_stats`, :func:`sufficient_power`,
  :func:`pcor_dp_tensor`) that run on whatever device their inputs live
  on, in the inputs' float dtype, and the float64 log-space p-values of the
  univariate extraction and the continuous window digest
  (:func:`log_erfc`, :func:`mi_logpval_smalldf`, :func:`fz_logpval`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import erfc as _erfc, gammaincc as _gammaincc


# ---------------------------------------------------------------------------
# Fisher-z (continuous tests), host float64
# ---------------------------------------------------------------------------

def fisher_z_transform(p, n, len_z):
    """z-statistic of a (partial) correlation (reference: src/statfuns.jl:3-11)."""
    sample_factor = np.asarray(n - len_z - 3, dtype=np.float64)
    p = np.asarray(p)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (np.sqrt(np.maximum(sample_factor, 0)) / 2.0) * np.log((1.0 + p) / (1.0 - p))
    return np.where(sample_factor > 0, z, 0.0)


def fz_pval(stat, n, len_z):
    """Two-sided normal p-value of the Fisher-z statistic (reference:
    src/statfuns.jl:13-17).  ccdf(Normal(), |z|)*2 == erfc(|z|/sqrt(2))."""
    return _erfc(np.abs(fisher_z_transform(stat, n, len_z)) / np.sqrt(2.0))


# ---------------------------------------------------------------------------
# Partial correlation (continuous tests), host float64
# ---------------------------------------------------------------------------

def pcor_dp(C, kvec, max_k, xp=np):
    """Batched recursive partial correlation (reference: src/statfuns.jl:23-75
    ``pcor_rec``) as a dense dynamic program: step t conditions every pair
    among {X, Y, Z_1..Z_k} on Z_t.  Includes the reference's 5-digit rounding
    of the numerator and the [-1, 1) clamp at every node.  The numpy code of
    the JAX package's ``pcor_dp(xp=np)``, so the two agree bit for bit.

    C: (..., m, m) correlation submatrices, index 0 = X, 1 = Y, 2.. = Zs;
    kvec: (...,) conditioning-set sizes.  Returns (...,) pcor(X, Y | Zs)."""
    C = xp.asarray(C)
    kvec = xp.asarray(kvec)
    for t in range(max_k):
        z = t + 2
        cz = C[..., :, z]                                  # (..., m)
        num = C - cz[..., :, None] * cz[..., None, :]
        num = xp.round(num * 1e5) / 1e5
        dvec = xp.sqrt(xp.maximum(1.0 - cz * cz, 0.0))
        den = dvec[..., :, None] * dvec[..., None, :]
        P = xp.where(den == 0.0, 0.0, num / xp.where(den == 0.0, 1.0, den))
        P = xp.where(P < -1.0, -1.0, P)
        P = xp.where(P >= 1.0, 1.0, P)
        C = xp.where((t < kvec)[..., None, None], P, C)
    return C[..., 0, 1]


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """sqrt rounded to nearest, as numpy's.  CUDA's float64 sqrt is; on the
    CPU ``torch.sqrt`` may go through a vector math library that is an ulp
    off, so CPU tensors take numpy's root."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def pcor_dp_tensor(C: torch.Tensor, kvec: torch.Tensor,
                   max_k: int) -> torch.Tensor:
    """:func:`pcor_dp` on float64 tensors, on their device.

    The same operations in the same order, each a separate eager kernel
    that rounds its result, so every value equals numpy's bit for bit:
    ``torch.round`` rounds half to even as ``np.round`` does, the clamps and
    selects keep NaN as numpy's do, the square root is :func:`_sqrt_rn`, and
    the 1e5 divisor is a tensor on the device, since CUDA divides by a host
    scalar as a product with its reciprocal.  A fused form must not let the
    compiler contract ``a - b * c`` into one rounding (an FMA)."""
    e5 = torch.full((), 1e5, dtype=C.dtype, device=C.device)
    for t in range(max_k):
        z = t + 2
        cz = C[..., :, z]                                  # (..., m)
        num = C - cz[..., :, None] * cz[..., None, :]
        num = torch.round(num * 1e5) / e5
        dvec = _sqrt_rn(torch.clamp(1.0 - cz * cz, min=0.0))
        den = dvec[..., :, None] * dvec[..., None, :]
        P = torch.where(den == 0.0, 0.0,
                        num / torch.where(den == 0.0, 1.0, den))
        P = torch.where(P < -1.0, -1.0, P)
        P = torch.where(P >= 1.0, 1.0, P)
        C = torch.where((t < kvec)[..., None, None], P, C)
    return C[..., 0, 1]


def pcor_iterative(X, Y, Zs, data):
    """Partial correlation by linear regression (reference:
    src/statfuns.jl:19-21, StatsBase.partialcor), for recursive_pcor=False."""
    data = np.asarray(data, dtype=np.float64)
    x = data[:, X]
    y = data[:, Y]
    Z = data[:, list(Zs)]
    Z1 = np.column_stack([np.ones(len(x)), Z])
    bx, *_ = np.linalg.lstsq(Z1, x, rcond=None)
    by, *_ = np.linalg.lstsq(Z1, y, rcond=None)
    rx = x - Z1 @ bx
    ry = y - Z1 @ by
    denom = np.sqrt((rx * rx).sum() * (ry * ry).sum())
    if denom == 0:
        return 0.0
    return float((rx * ry).sum() / denom)


# ---------------------------------------------------------------------------
# Mutual information / G-test (discrete tests), host float64
# ---------------------------------------------------------------------------

def mi_pval(mi, df, n_obs):
    """chi2 p-value of the G statistic 2*MI*n (reference: src/statfuns.jl:157-161).
    ccdf(Chisq(df), g) == gammaincc(df/2, g/2); df <= 0 -> 1.0."""
    g_stat = 2.0 * np.abs(mi) * n_obs
    df = np.asarray(df)
    safe_df = np.where(df > 0, df, 1)
    pval = _gammaincc(safe_df / 2.0, g_stat / 2.0)
    return np.where(df > 0, pval, 1.0)


_chi2_thr_cache: dict = {}


def chi2_g_threshold(alpha: float, max_df: int) -> np.ndarray:
    """Per-df significance thresholds on the scaled G statistic x = |mi|*n.

    thr[d] solves gammaincc(d/2, thr[d]) == alpha, so
    ``mi_pval(mi, df, n) < alpha  <=>  |mi|*n > thr[df]`` for integer df >= 1
    (df <= 0 maps to pval 1.0, thr[0] = inf).  The scheduler classifies a
    whole round's significance with it and evaluates exact p-values only on
    the early-exit prefix (reference: src/tests.jl:326-336)."""
    arr = _chi2_thr_cache.get(alpha)
    if arr is None or len(arr) <= max_df:
        from scipy.special import gammainccinv

        d = np.arange(1, max_df + 1, dtype=np.float64)
        arr = np.concatenate([[np.inf], gammainccinv(d / 2.0, alpha)])
        _chi2_thr_cache[alpha] = arr
    return arr


def benjamini_hochberg(pvals, alpha=0.01, m=None):
    """Accelerated BH correction on the significant tail (reference:
    src/statfuns.jl:326-350).

    Returns a NEW array: entries with raw p < alpha hold the adjusted p-value,
    all others (including NaN unreliable tests) are NaN.  ``m`` is the number
    of tests used for correction (may exclude unreliable tests, reference
    src/tests.jl:521-528)."""
    p = np.asarray(pvals, dtype=np.float64)
    out = np.full(p.shape, np.nan)
    if p.size == 0:
        return out
    if m is None:
        m = p.size
    with np.errstate(invalid="ignore"):
        mask = p < alpha                       # NaN compares False
    idx = np.nonzero(mask)[0]
    if idx.size == 0:
        return out
    order = np.argsort(p[idx], kind="stable")
    sidx = idx[order]
    sp = p[sidx]
    nf = sp.size
    # reversed running minimum of sp[i] * m / (i+1), capped at 1
    terms = sp * float(m) / np.arange(1.0, nf + 1.0)
    adj = np.minimum.accumulate(terms[::-1])[::-1]
    np.minimum(adj, 1.0, out=adj)
    out[sidx] = adj
    return out


# ---------------------------------------------------------------------------
# tensor functions
# ---------------------------------------------------------------------------

def mi_stats(ctab: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
             signed: bool = True):
    """Batched signed mutual information + adjusted df from stratified
    contingency tables (reference: src/statfuns.jl:163-254
    ``mutual_information`` and :281-305 ``adjust_df``).

    The nz sub-table slicing (src/statfuns.jl:313-323) is expressed by zeroing
    the sliced-away cells beforehand and passing the slice offsets ``ox, oy``
    in {0, 1}, so the sub-table's diagonal ``i == j`` becomes
    ``(a - ox) == (b - oy)`` on the full table.

    Args:
      ctab: (..., L, L, S) float contingency counts, invalid cells zeroed.
      ox, oy: (...,) integer offsets of the valid region.
    Returns:
      (mi_stat, df, n_obs) of shape (...,): mi float, df int64, n_obs float.
    """
    L = ctab.shape[-2]
    marg_i = ctab.sum(dim=-2)                     # (..., L, S)
    marg_j = ctab.sum(dim=-3)                     # (..., L, S)
    marg_k = marg_i.sum(dim=-2)                   # (..., S)
    n_obs = marg_k.sum(dim=-1)                    # (...,)

    mik = marg_i[..., :, None, :]
    mjk = marg_j[..., None, :, :]
    mk = marg_k[..., None, None, :]
    valid = (ctab != 0) & (mik != 0) & (mjk != 0)
    one = torch.ones((), dtype=ctab.dtype, device=ctab.device)
    denom = torch.where(valid, mik * mjk, one)
    ratio = torch.where(valid, (mk * ctab) / denom, one)
    term = torch.where(valid, torch.log(ratio) * ctab, 0.0)

    idx = torch.arange(L, device=ctab.device)
    a_idx = idx[:, None, None]
    b_idx = idx[None, :, None]
    diag = (a_idx - ox[..., None, None, None]) == (b_idx - oy[..., None, None, None])

    mi_pos = torch.where(diag, term, 0.0).sum(dim=(-3, -2, -1))
    mi_neg = torch.where(diag, 0.0, term).sum(dim=(-3, -2, -1))
    n_pos = torch.where(diag, ctab, 0.0).sum(dim=(-3, -2, -1))
    n_neg = n_obs - n_pos

    safe_n = torch.where(n_obs > 0, n_obs, one)
    mi_stat = (mi_pos + mi_neg) / safe_n
    if signed:
        flip = mi_neg * (n_neg / safe_n) > mi_pos * (n_pos / safe_n)
        mi_stat = torch.where(flip, -mi_stat, mi_stat)

    alx = torch.clamp((marg_i != 0).sum(dim=-2), min=1)   # (..., S)
    aly = torch.clamp((marg_j != 0).sum(dim=-2), min=1)
    df = ((alx - 1) * (aly - 1)).sum(dim=-1)
    return mi_stat, df, n_obs


def sufficient_power(levels_x, levels_y, n_obs, hps, levels_z=None):
    """Heuristic power criterion (reference: src/tests.jl:5-6) on tensors.
    Zero level products follow Julia's n/0 == Inf > hps semantics."""
    n_obs = torch.as_tensor(n_obs)
    cells = levels_x * levels_y * (levels_z if levels_z is not None else 1)
    cells = torch.as_tensor(cells, device=n_obs.device).to(torch.float64)
    n_obs = n_obs.to(torch.float64)
    ratio = torch.where(cells > 0,
                        n_obs / torch.where(cells > 0, cells, 1.0),
                        torch.inf)
    return ratio > hps


# ---------------------------------------------------------------------------
# log-space p-values, float64 tensors
# ---------------------------------------------------------------------------

# erfc(z) is a normal float64 number up to z ~ 26.5 (erfc(26) ~ 5.7e-296)
ERFC_DIRECT_MAX = 26.0


def log_erfc(z: torch.Tensor) -> torch.Tensor:
    """log(erfc(z)) for z >= 0, stable far into the tail.

    Directly evaluated while erfc(z) is a normal float64 number (z < 26);
    past that the asymptotic expansion erfc(z) ~ e^{-z^2}/(z sqrt(pi)) *
    (1 - 1/(2 z^2) + 3/(4 z^4) - 15/(8 z^6) + 105/(16 z^8)), whose first
    omitted term is below 3e-13 relative there.  The JAX package switches to
    a 3-term expansion at z = 8, the point where float32 erfc underflows,
    which costs float64 up to 7e-6 relative in p (ROADMAP queue 3)."""
    zs = torch.clamp(z, min=1e-30)
    small = torch.log(torch.special.erfc(torch.clamp(z, max=ERFC_DIRECT_MAX)))
    z2 = zs * zs
    w = 1.0 / z2
    series = w * (-0.5 + w * (0.75 + w * (-1.875 + w * 6.5625)))
    large = -z2 - torch.log(zs * math.sqrt(math.pi)) + torch.log1p(series)
    return torch.where(z < ERFC_DIRECT_MAX, small, large)


def _logsumexp2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    m = torch.nan_to_num(m, nan=0.0, posinf=0.0, neginf=0.0)  # both -inf
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def mi_logpval_smalldf(mi: torch.Tensor, df: torch.Tensor, n_obs: torch.Tensor,
                       max_df: int) -> torch.Tensor:
    """log of the chi2 G-test p-value for integer 0 <= df <= max_df
    (log(mi_pval(...)); df <= 0 gives log 1), in log space so that
    ultra-significant pairs keep a total order where p underflows.

    With x = g/2 = |mi| * n_obs:
      df = 2k   : Q = e^{-x} sum_{i<k} x^i / i!
      df = 2k+1 : Q = erfc(sqrt(x)) + e^{-x} sum_{1<=i<=k} x^{i-1/2} / G(i+1/2)
    Each branch's logsumexp chain is a prefix of the next one's, built in
    the JAX package's order of accumulation (its ``mi_logpval_smalldf``),
    so the value for each df does not depend on ``max_df``.  The even and
    odd chains advance together as one (2, ...) tensor, and each element
    keeps the chain value of its own df, finished once after the loop:
    about 15 launches a k, where a where over the whole batch for every df
    took 42, with the same operations on each element."""
    x = torch.abs(mi) * n_obs.to(mi.dtype)               # g/2
    logx = torch.log(torch.clamp(x, min=1e-300))
    ler = log_erfc(torch.sqrt(x))
    negx = -x
    K = max_df // 2
    # step k extends the even chain by its term i = k and the odd chain by
    # its term i = k - 1/2: coefficients of log x and lgamma offsets
    ks = np.arange(1, K + 1, dtype=np.float64)
    coef = torch.from_numpy(np.stack([ks, ks - 0.5], axis=1)).to(x.device)
    lg = torch.from_numpy(np.array(
        [[math.lgamma(k + 1), math.lgamma(k + 0.5)] for k in range(1, K + 1)],
        np.float64).reshape(K, 2)).to(x.device)
    shape = (2,) + (1,) * x.dim()
    sel_e = torch.zeros_like(x)        # even chain before step k, df = 2k
    sel_o = torch.zeros_like(x)        # odd chain after step k, df = 2k + 1
    acc = None
    for k in range(1, K + 1):
        if k > 1:
            sel_e = torch.where(df == 2 * k, acc[0], sel_e)
        t = logx * coef[k - 1].reshape(shape) - lg[k - 1].reshape(shape)
        if acc is None:
            # i = 0 term of the even chain; the odd chain starts at i = 1/2
            acc = torch.stack([_logsumexp2(torch.zeros_like(x), t[0]), t[1]])
        else:
            acc = _logsumexp2(acc, t)
        if 2 * k + 1 <= max_df:
            sel_o = torch.where(df == 2 * k + 1, acc[1], sel_o)
    even = torch.where(df == 2, negx, negx + sel_e)
    odd = _logsumexp2(ler, negx + sel_o)
    out = torch.where((df >= 2) & (df % 2 == 0), even, odd)
    out = torch.where(df == 1, ler, out)
    out = torch.where((df >= 1) & (df <= max_df), out, 0.0)  # df <= 0: log 1
    return torch.clamp(out, max=0.0)


def fisher_z_tensor(r: torch.Tensor, n: torch.Tensor, len_z: int) -> torch.Tensor:
    """:func:`fisher_z_transform` on tensors: the z-statistic of a (partial)
    correlation r over n observations (reference: src/statfuns.jl:3-11)."""
    sample_factor = (n - len_z - 3).to(torch.float64)
    z = (torch.sqrt(torch.clamp(sample_factor, min=0.0)) / 2.0) * torch.log(
        (1.0 + r) / (1.0 - r))
    return torch.where(sample_factor > 0, z, 0.0)


def fz_logpval(stat: torch.Tensor, n: torch.Tensor, len_z: int) -> torch.Tensor:
    """log of the two-sided Fisher-z normal p-value (log-space counterpart of
    :func:`fz_pval`): log(erfc(|z| / sqrt(2)))."""
    return log_erfc(torch.abs(fisher_z_tensor(stat, n, len_z)) / math.sqrt(2.0))
