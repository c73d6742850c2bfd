"""The index maps of K7, the turbo window digest
(``csrc/mi_turbo_digest.cu``), emulated in numpy on the CPU.

The CUDA kernel runs only on the card.  These tests replay, lane by lane,
its address arithmetic with the kernel's constants read from its source:
the passes of ``ops/kernels.py:k7_plan`` (candidate ranges by M-tiles,
subset ranges by N-tiles: the column groups), the cp.async ring of each
pass (aligned 144-byte windows, zero fill past the table's end, funnel
shifts), A's rows (candidate j's cell (x - o) + Lr (y - o), the nz mask
folded in, samples past n masked by position), the byte-packed stratum
codes (sum_i word(C[memb[u][i]]) L^i, stored permuted so that a lane's
words of one or two k-steps are one load), each lane's B column (a binary
search of the subsets' first columns), the ldmatrix and mma.sync fragment
layouts (as the PTX ISA gives them), the slab a pass's accumulators go to,
and the gather of each template pair's block, from its pass's pair list,
into the epilogue's layout (v + Lr b + Lr^2 s).  They check that:
- every A and code word the products read was written for that chunk, and
  every slab slot a gather reads was written in that pass;
- every template pair is finished in exactly one pass;
- the tables read through those maps equal ``condtests._turbo_tables``
  (the plain route's plane product) exactly, in nz modes 0, 1 and 2, at
  ragged n, and at L = 2, max_k = 7, where a stratum code reaches 127 and
  the bytes past n (the next variable's) would give code 127 too.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from flashweave_tpu_torch.learning.hiton import _turbo_mxu_template
from flashweave_tpu_torch.ops import condtests as tct
from flashweave_tpu_torch.ops import kernels as K

CSRC = Path(K.SRC_DIR)
U32 = np.uint32
LANE = np.arange(32)
G_, T_ = LANE >> 2, LANE & 3          # mma groupID, thread in group


def _constants(name):
    """The ``constexpr`` integers of a csrc file, evaluated in order."""
    ns = {}
    text = (CSRC / name).read_text()
    for key, expr in re.findall(
            r"constexpr (?:int|uint32_t) (\w+)\s*=\s*([^;]+);", text):
        try:
            ns[key] = int(eval(expr.strip().rstrip("u"), {}, dict(ns)))
        except (NameError, SyntaxError):
            pass
    return ns


K7C = _constants("mi_turbo_digest.cu")


def test_constants_match_the_wrapper():
    c = K7C
    assert (c["MAX_WARPS"], c["ACC_TILES"], c["MAX_MTW"], c["MAX_LR"]) == (
        K.K7_WARPS, K.K7_ACC_TILES, K.K7_MAX_MTW, K.K7_MAX_LR)
    assert (c["CHUNK"], c["WINDOW"], c["STAGES"]) == (
        K.K7_CHUNK, K.K7_WINDOW, K.K7_STAGES)
    assert c["SMEM_BLOCK_BYTES"] == K.SMEM_BLOCK_BYTES
    assert c["WINDOW"] % 16 == 0 and c["WINDOW"] >= c["CHUNK"] + 16
    # rows 36 words apart: eight rows of one ldmatrix phase, and the eight
    # B columns of a lane group, fall on distinct banks
    assert {(c["WINDOW"] // 4 * r) % 32 // 4 for r in range(8)} == set(range(8))
    assert c["ACC_TILES"] % c["MAX_MTW"] == 0
    assert (c["MAX_LR"] ** 2 + 15 + 15) // 16 <= c["MAX_MTW"]
    assert c["NO_CODE"] == 0x7F7F7F7F
    # a subset's descriptor: its size and up to 7 members (L = 2, max_k 7)
    assert c["ZDESC_INTS"] == K.K7_ZDESC_INTS == 8
    # a joint match adds 0x01 x 0x80 = 128: n < 2^24 keeps the sums in int32
    assert K.PIPE_MAX_SAMPLES * 128 <= 2 ** 31


def _match80(v7, code):
    return ~((v7 ^ code) + U32(0x7F7F7F7F)) & U32(0x80808080)


def _bytes(words):
    """(..., 4) uint8 of uint32 words (little-endian)."""
    return np.ascontiguousarray(words)[..., None].view(np.uint8)


def _mma(af, b0, b1):
    """m16n8k32 u8 of every (mi, ni) tile at once: af (MTW, 4, 32), b0 and
    b1 (NTW, 32) lane registers; returns (MTW, NTW, 4, 32) int64
    increments.  Lane (g, t): a0 = A[g][4t..], a1 = A[g+8][4t..], a2 =
    A[g][16+4t..], a3 = A[g+8][16+4t..]; b0 = B[4t..][g], b1 = B[16+4t..][g];
    c_e = C[g + 8 (e >> 1)][2t + (e & 1)]."""
    mt, nt = af.shape[0], b0.shape[0]
    A = np.full((mt, 16, 32), -1, np.int64)
    B = np.full((nt, 32, 8), -1, np.int64)
    kq = 4 * T_[:, None] + np.arange(4)[None, :]
    for i, (rows, koff) in enumerate(((G_, 0), (G_ + 8, 0), (G_, 16),
                                      (G_ + 8, 16))):
        A[:, rows[:, None], kq + koff] = _bytes(af[:, i])
    B[:, kq, G_[:, None]] = _bytes(b0)
    B[:, kq + 16, G_[:, None]] = _bytes(b1)
    assert (A >= 0).all() and (B >= 0).all()
    C = np.einsum("mik,nkj->mnij", A, B)
    return np.stack([C[:, :, G_ + 8 * (e >> 1), 2 * T_ + (e & 1)]
                     for e in range(4)], axis=2)


def replay_k7(dataT, maxv, T, C, memb, klen, pj, pu, L, nz):
    """K7's passes over one window replayed; returns ({pair: histogram in
    the epilogue's layout}, the stratum codes of valid samples seen)."""
    c = K7C
    CHUNK, WINDOW, STAGES = c["CHUNK"], c["WINDOW"], c["STAGES"]
    WW = WINDOW // 4
    p, n = dataT.shape
    m = len(C)
    raw = dataT.astype(np.int8).view(np.uint8).ravel()
    total = p * n
    plan = K.k7_plan(m, L, nz, klen, pj, pu)
    colo = plan.colo
    o = 1 if nz == 2 else 0
    Lr = L - o
    LL = Lr * Lr
    MTW = plan.mtw
    NTW = c["ACC_TILES"] // MTW
    warps = plan.warps
    cols = [T] + list(C)
    base = np.array([v * n for v in cols], np.int64)
    coff = [int(nz == 1 and maxv[v] > 1) for v in cols]
    ox = coff[0]
    chunks = -(-n // CHUNK)
    hists, finished, codes_seen, finished_passes = {}, {}, set(), []
    for j0, j1, u0, u1 in plan.passes.tolist():
        R0, R1 = plan.rows(j0, j1)
        C0, C1 = plan.cols(u0, u1)
        assert (R0, R1) == ((j0 * LL) & ~15, (j1 * LL + 15) & ~15)
        mcount, ntp = (R1 - R0) // 16, (C1 - C0) // 8
        assert 1 <= mcount <= MTW and u1 - u0 <= plan.zrows
        rs = K.k7_slab_stride(ntp)
        assert (R1 - R0) * rs <= plan.cg_ints
        q = -(-ntp // warps)
        assert q <= NTW
        jf0, jf1 = R0 // LL, min(m, -(-R1 // LL))
        # each lane's B columns: the subset's code row and the stratum
        zrow = np.full((warps, NTW, 32), -1, np.int64)       # -1: zero row
        code = np.full((warps, NTW, 32), 0x7F7F7F7F, np.uint64)
        for wp in range(warps):
            for ni in range(min(q, ntp - wp * q)):
                for ln in range(32):
                    col = C0 + 8 * (wp * q + ni) + (ln >> 2)
                    if colo[u0] <= col < colo[u1]:
                        lo, hi = u0, u1 - 1
                        while lo < hi:
                            mid = (lo + hi + 1) >> 1
                            if colo[mid] <= col:
                                lo = mid
                            else:
                                hi = mid - 1
                        assert colo[lo] <= col < colo[lo + 1]
                        zrow[wp, ni, ln] = lo - u0
                        code[wp, ni, ln] = 0x01010101 * (col - colo[lo])
        code = code.astype(U32)
        acc = np.zeros((warps, MTW, NTW, 4, 32), np.int64)
        abuf_pad = np.zeros((16 * MTW, WW), U32)
        for kc in range(chunks):
            k0 = kc * CHUNK
            # the stage: each column's aligned window, zero fill at the end
            st = np.zeros((m + 1) * WINDOW, np.uint8)
            for r in range(m + 1):
                for w16 in range(WINDOW // 16):
                    ad = ((int(base[r]) + k0) & ~15) + 16 * w16
                    nb = 0 if ad >= total else min(16, total - ad)
                    st[r * WINDOW + 16 * w16:r * WINDOW + 16 * w16 + nb] = \
                        raw[ad:ad + nb]
            st = st.view(U32)

            def ring_word(r, pos):
                off = int(base[r]) & 15
                wi = r * WW + (off >> 2) + (pos >> 2)
                assert wi + 1 < (r + 1) * WW
                both = (int(st[wi + 1]) << 32) | int(st[wi])
                return (both >> (8 * (off & 3))) & 0xFFFFFFFF

            rem = n - k0
            abuf = abuf_pad.copy()
            awrote = np.zeros((16 * MTW, WW), bool)
            awrote[np.arange(16 * MTW) + R0 >= m * LL] = True   # zeroed rows
            for j in range(jf0, jf1):
                for wd in range(32):
                    pos = 4 * wd
                    xw, yw = ring_word(0, pos), ring_word(1 + j, pos)
                    keep = 0xFFFFFFFF
                    if rem - pos < 4:
                        k = max(0, rem - pos)
                        keep = 0 if k == 0 else 0xFFFFFFFF >> (32 - 8 * k)
                    for b in range(Lr):
                        ym = 0 if (b + o == 0 and coff[1 + j]) else \
                            int(_match80(U32(yw), U32(0x01010101 * (b + o)))) & keep
                        for x in range(Lr):
                            row = j * LL + x + Lr * b - R0
                            if not 0 <= row < R1 - R0:
                                continue
                            xm = 0 if (x + o == 0 and ox) else \
                                int(_match80(U32(xw), U32(0x01010101 * (x + o))))
                            abuf[row, wd] = (xm & ym) >> 7
                            awrote[row, wd] = True
            zbuf = np.zeros((u1 - u0, WW), U32)
            zwrote = np.zeros((u1 - u0, WW), bool)
            for u in range(u0, u1):
                for wd in range(32):
                    z, wz = 0, 1
                    for i in range(klen[u]):
                        z += ring_word(1 + memb[u][i], 4 * wd) * wz
                        wz *= L
                    assert z < 1 << 32 and all(
                        (z >> (8 * i)) & 0xFF < L ** klen[u] for i in range(4))
                    # stored permuted: lane t's words of the chunk's four
                    # k-steps, w = t + 4 i, are the eight from t 8
                    at = (wd & 3) * 8 + (wd >> 2)
                    zbuf[u - u0, at] = z
                    zwrote[u - u0, at] = True
                    for i in range(4):
                        if 4 * wd + i < rem:
                            codes_seen.add((z >> (8 * i)) & 0xFF)
            ab = abuf.view(np.uint8).reshape(16 * MTW, WINDOW)
            for wp in range(warps):
                nq = min(q, ntp - wp * q)
                if nq <= 0:
                    continue
                KH = 2 if MTW <= 2 else 1      # k-steps a group
                for kg in range(0, CHUNK, 32 * KH):
                    # each N-tile: a lane's 2 KH code words of the KH
                    # k-steps from kg in one load from t 8
                    bw = np.zeros((nq, 2 * KH, 32), U32)
                    for ni in range(nq):
                        zr = zrow[wp, ni]
                        inz = zr >= 0
                        for qd in range(2 * KH):
                            wo = 8 * T_ + (kg >> 4) + qd
                            zz = np.zeros(32, U32)
                            zz[inz] = zbuf[zr[inz], wo[inz]]
                            assert zwrote[zr[inz], wo[inz]].all()
                            bw[ni, qd] = _match80(zz, code[wp, ni])
                    for h in range(KH):
                        kk = kg + 32 * h
                        # ldmatrix.x4: lane l gives row l & 15 at byte
                        # kk + 16 (l >> 4); thread T of matrix i gets bytes
                        # 4 (T % 4).. of the row lane 8 i + T / 4 gave
                        af = np.zeros((mcount, 4, 32), U32)
                        for mi in range(mcount):
                            arow = 16 * mi + (LANE & 15)
                            abyte = kk + 16 * (LANE >> 4)
                            for i in range(4):
                                src = 8 * i + (LANE >> 2)
                                r_, b_ = arow[src], abyte[src] + 4 * (LANE & 3)
                                assert awrote[r_, b_ // 4].all()
                                af[mi, i] = ab[r_[:, None], b_[:, None]
                                               + np.arange(4)].copy().view(U32)[:, 0]
                        acc[wp, :mcount, :nq] += _mma(af, bw[:, 2 * h],
                                                      bw[:, 2 * h + 1])
        # the slab: row R0 + i, column C0 + c at [i * rs + c]
        cg = np.full((R1 - R0) * rs, -1, np.int64)
        for wp in range(warps):
            for mi in range(mcount):
                for ni in range(min(q, ntp - wp * q)):
                    for e in range(4):
                        at = ((16 * mi + G_ + 8 * (e >> 1)) * rs
                              + 8 * (wp * q + ni) + 2 * T_ + (e & 1))
                        assert (cg[at] == -1).all()
                        cg[at] = acc[wp, mi, ni, e] >> 7
        ps = len(finished_passes)
        finished_passes.append((j0, j1, u0, u1))
        for pi in plan.ppairs[plan.poffs[ps]:plan.poffs[ps + 1]]:
            j, u = int(pj[pi]), int(pu[pi])
            assert j0 <= j < j1 and u0 <= u < u1
            S = int(colo[u + 1] - colo[u])
            i = np.arange(LL * S)
            s, cell = i // LL, i % LL
            at = (j * LL + cell - R0) * rs + (colo[u] - C0) + s
            h = cg[at]
            assert (h >= 0).all()              # written in this pass
            hists[(j, u)] = h
            finished[pi] = finished.get(pi, 0) + 1
    assert sorted(finished) == list(range(len(pj)))
    assert set(finished.values()) == {1}
    return hists, codes_seen


def _window_table(n, p, L, nz, seed, head_ones=0):
    """A (p, n) table of L levels (nz 1: every third variable binary, so
    its offset is not set), the first ``head_ones`` samples of each
    variable 1."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, L, (p, n))
    if nz == 1:
        d[::3] = np.minimum(d[::3], 1)
    d[:, :head_ones] = 1
    return d.astype(np.int8)


@pytest.mark.parametrize("L,nz,max_k,m,n", [
    (3, 2, 3, 7, 300),     # the headline's template: three passes
    (3, 1, 2, 5, 261),     # generic nz offsets, one pass, n % 4 == 1
    (3, 0, 3, 6, 160),     # plain mi: 54 rows, two candidate ranges
    (2, 0, 7, 8, 333),     # the widest template: codes up to 127
    (2, 1, 3, 4, 129),     # binary under nz (no offset), one sample past a chunk
])
def test_k7_tables_through_the_maps(L, nz, max_k, m, n):
    p = 3 * m + 4
    head = 16 if max_k == 7 else 0
    dataT = _window_table(n, p, L, nz, seed=L + m + n, head_ones=head)
    if max_k == 7:
        # rows whose seven stratum members are all 1: code 127
        dataT[:, 7:12] = 1
    maxv = dataT.max(axis=1).astype(np.int64)
    if nz == 2:
        assert (maxv == 2).all()
    rng = np.random.default_rng(m)
    # the table's last variable among the candidates: zero fill at its end
    C = np.concatenate([[p - 1], rng.choice(p - 2, m - 1, replace=False)])
    T = p - 2
    tpl = _turbo_mxu_template(m, max_k)
    pj, pu, _ = tct._turbo_pairs(tpl["jb"], tpl["ub"], tpl["U"])
    memb, klen = tpl["memb"], tpl["klen"]
    hists, codes = replay_k7(dataT, maxv, T, C, memb, klen, pj, pu, L, nz)
    if max_k == 7:
        assert 127 in codes

    S = L ** max_k
    data = torch.from_numpy(dataT.T.astype(np.int64))
    P, _, _ = tct._turbo_tables(
        data, torch.from_numpy(maxv), torch.tensor([T]),
        torch.from_numpy(C[None].astype(np.int64)),
        torch.from_numpy(memb.astype(np.int64)),
        torch.from_numpy(klen.astype(np.int64)), L, S, nz != 0, nz == 2)
    P = P[0].numpy()                           # (m, Lr, Lr, U, S): [j, a, b]
    Lr = P.shape[1]
    for (j, u), h in hists.items():
        Su = L ** int(klen[u])
        # the epilogue's layout: v + Lr b + Lr^2 s, v the target's level
        want = P[j, :, :, u, :Su].transpose(2, 1, 0).reshape(-1)
        np.testing.assert_array_equal(h, want.astype(np.int64))
        assert (P[j, :, :, u, Su:] == 0).all()
    assert len(hists) == len(pj)
