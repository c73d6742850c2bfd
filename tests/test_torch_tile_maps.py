"""The index maps of K2 (``csrc/fz_nz_stats.cu``), K3
(``csrc/mi_pair_ctabs.cu``), K4 (``csrc/mi_univar_stats_planes.cu``) and K1
(``csrc/mi_univar_stats.cu``), the last three over
``csrc/int8_indicator_pipe.cuh``, emulated in numpy on the CPU.

The CUDA kernels run only on the card.  These tests replay, lane by lane,
the address arithmetic of each kernel -- the copies of its staging, the
fragments each lane loads, the mma.sync fragment layouts (as the PTX ISA
gives them), and the epilogue's stores -- with the kernels' tile constants
read from their sources, and check that:
- every staged slot, mask byte and shared epilogue slot that is read was
  written, and no global read leaves the table;
- every output element is written exactly once;
- the emulated results equal the plain versions: K2's N exactly and r
  within rtol 1e-9 / atol 1e-12 (the emulation sums in another order), NaN
  positions equal; K3's planes and K4's results exactly; K1's integers
  exactly and its stat within rtol 1e-9 / atol 1e-15 (K1's plain version
  counts its tables by another route, and an independent pair's MI is 0
  on one side and ~1e-18 on the other).
K3 is replayed at every level-group layout the kernel takes (L = 2, 3, 12,
21, 127), with n not a multiple of 16 (unaligned rows) and ragged tiles;
K4 from level 1 at L = 2, 3, 9, 12, 21, 22, 48 and 127, by X level groups,
through its slab of counts walked in one or several sub-blocks, with
ragged tiles and n = 2,047; K1 from level 1 in one sweep of width L - 1 at
L = 2, 3, 4 through its count store in the ring, with ragged tiles and
n = 2,047; K2 with ragged tiles and samples, odd p and offsets, and an
unaligned base.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from flashweave_tpu_torch.ops import kernels as K
from flashweave_tpu_torch.state import from_numpy_state

CSRC = Path(K.SRC_DIR)
U32 = np.uint32


def _constants(*names):
    """The ``constexpr`` integers of the given csrc files, evaluated in
    order (later ones may use earlier ones)."""
    ns = {}
    for name in names:
        text = (CSRC / name).read_text()
        for key, expr in re.findall(r"constexpr (?:int|uint32_t) (\w+)\s*=\s*([^;]+);",
                                    text):
            try:
                ns[key] = int(eval(expr.replace("fw_pipe::", "").strip().rstrip("u"),
                                   {}, dict(ns)))
            except (NameError, SyntaxError):
                pass
    return ns


K2C = _constants("fz_nz_stats.cu")
K3C = _constants("int8_indicator_pipe.cuh", "mi_pair_ctabs.cu")
K4C = _constants("int8_indicator_pipe.cuh", "mi_univar_stats_planes.cu")
K1C = _constants("int8_indicator_pipe.cuh", "mi_univar_stats.cu")
LANE = np.arange(32)
G_, T_ = LANE >> 2, LANE & 3          # mma groupID, thread in group


def test_constants_parsed():
    assert (K2C["BX"], K2C["BY"], K2C["BK"]) == (64, 64, 32)
    assert K2C["SX"] % 16 == 4 and K2C["SY"] % 16 == 4    # conflict-free rows
    assert K2C["SMEM_BYTES"] <= 227 * 1024                 # one block an SM
    # the conversion: one task (8 samples of a variable) a thread
    assert (K2C["BX"] + K2C["BY"]) * K2C["BK"] // 8 == K2C["THREADS"]
    assert (K3C["BX"], K3C["BY"], K3C["G"], K3C["CHUNK"]) == (32, 64, 3, 128)
    assert K3C["WINDOW"] % 16 == 0 and K3C["WINDOW"] >= K3C["CHUNK"] + 16
    assert K3C["SMEM_BYTES"] <= 227 * 1024 // 2
    assert K.PIPE_MAX_SAMPLES * 128 <= 2 ** 31
    # K4: its block tile is the pipe's, and its epilogue kernel's blocks
    # cover a block tile's pairs exactly
    assert (K4C["BX"], K4C["BY"]) == K.K4_TILE
    assert K4C["PAIRS"] == K4C["BX"] * K4C["BY"] == 8 * K4C["SUB_PAIRS"]
    assert K4C["PAIRS"] % K4C["EPI_THREADS"] == 0
    # K1: one sweep of levels 1..L-1 for the L it serves; its count store
    # holds a block tile's counts in rows of RS ints (RS % 32 == 8: a
    # half-warp's int2 stores hit 32 distinct banks), and two blocks with
    # the larger of the ring and the store fit on an SM
    assert K1C["MAX_L"] == K.K1_LEVELS.stop - 1 and K.K1_LEVELS.start == 2
    assert K1C["PAIRS"] == K1C["BX"] * K1C["BY"]
    assert K1C["PAIRS"] % K1C["THREADS"] == 0
    assert K1C["RS"] >= K1C["BY"] and K1C["RS"] % 32 == 8
    assert K1C["CSTRIDE"] == K1C["BX"] * K1C["RS"]
    assert 2 * max(K1C["RING_BYTES"], K1C["MAX_STORE_BYTES"]) <= 227 * 1024


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def _dmma(a0, a1, b):
    """m16n8k4 f64 per warp: a0, a1, b are (warps, 32) lane registers;
    returns (warps, 4, 32) accumulator increments.  Lane (g, t): a0 =
    A[g][t], a1 = A[g+8][t], b = B[t][g]; c_e = C[g + 8 (e >> 1)][2t + (e & 1)]."""
    w = a0.shape[0]
    A = np.full((w, 16, 4), np.nan)
    B = np.full((w, 4, 8), np.nan)
    A[:, G_, T_] = a0
    A[:, G_ + 8, T_] = a1
    B[:, T_, G_] = b
    assert not np.isnan(A).any() and not np.isnan(B).any()   # all filled
    C = A @ B
    return np.stack([C[:, G_ + 8 * (e >> 1), 2 * T_ + (e & 1)]
                     for e in range(4)], axis=1)


def emulate_k2(data, start, tile, ys, ylen, base16=True):
    """K2 replayed block by block; returns (r, N, writes)."""
    c = K2C
    n, p = data.shape
    flat = data.ravel()
    BX, BY, BK, SX, SY, WX = (c[k] for k in ("BX", "BY", "BK", "SX", "SY", "WX"))
    THREADS, PLANES = c["THREADS"], c["PLANES"]
    r_out = np.zeros((tile, ylen))
    n_out = np.zeros((tile, ylen), np.int64)
    writes = np.zeros((tile, ylen), np.int64)
    ntx = -(-tile // BX)
    warps = np.arange(c["WARPS"])[:, None]
    wx, wy = warps % WX, warps // WX
    xr = wx * 16 + G_                    # (warps, 32)
    for blk in range(ntx * -(-ylen // BY)):
        bx0, by0 = blk % ntx * BX, blk // ntx * BY
        xlim, ylim = min(BX, tile - bx0), min(BY, ylen - by0)
        x0, y0 = start + bx0, ys + by0
        s = {k: np.zeros((c["WARPS"], 2, 4, 32)) for k in ("x", "xx", "y", "yy", "xy")}
        cnt = np.zeros((c["WARPS"], 2, 4, 32), np.int64)
        for kc in range(-(-n // BK)):
            k0 = kc * BK
            stage = np.full(2 * PLANES, np.nan)
            wrote = np.zeros(2 * PLANES, np.int64)

            def copy(dst, gi, ok):
                assert (gi[ok] >= 0).all() and (gi[ok] < n * p).all()
                stage[dst] = np.where(ok, flat[np.where(ok, gi, 0)], 0.0)
                np.add.at(wrote, dst, 1)

            for base, width, stride, col0, lim in ((0, BX, SX, x0, xlim),
                                                   (BK * SX, BY, SY, y0, ylim)):
                idx = np.arange(BK * width // 2)
                assert len(idx) % THREADS == 0        # whole passes
                r, j = idx // (width // 2), idx % (width // 2) * 2
                row = k0 + r < n
                v0, v1 = row & (j < lim), row & (j + 1 < lim)
                gi = (k0 + r) * p + col0 + j
                wide = v0 & v1 & base16 & (gi % 2 == 0)
                dst = base + r * stride + j
                # a 16-byte copy is two reads of neighbours, both valid
                copy(dst, gi, v0 | wide)
                copy(dst + 1, gi + 1, v1 | wide)
            # convert_stage: squares and masks, a task = 8 samples of one var
            masks = np.zeros(BX + BY, np.int64)
            mwrote = np.zeros((BX + BY, BK // 8), np.int64)
            for task in range((BX + BY) * (BK // 8)):
                v, kg = task % (BX + BY), task // (BX + BY)
                isx = v < BX
                stride = SX if isx else SY
                pos = (v if isx else BK * SX + v - BX) + (kg * 8 + np.arange(8)) * stride
                assert (wrote[pos] == 1).all()
                d = stage[pos]
                stage[pos + PLANES] = d * d
                wrote[pos + PLANES] += 1
                bits = d != 0                        # NaN counts, -0.0 does not
                masks[v] |= int(np.sum(bits.astype(np.int64) << np.arange(8))) << (8 * kg)
                mwrote[v, kg] += 1
            assert (mwrote == 1).all()

            def rd(pos):
                assert (wrote[pos] == 1).all()
                return stage[pos]

            yc = wy * 16 + 2 * T_
            for j in range(2):
                for e in range(2):
                    my = masks[BX + yc + 8 * j + e]
                    for h in range(2):
                        cnt[:, j, 2 * h + e] += [[bin(int(a) & int(b)).count("1")
                                                  for a, b in zip(ra, rb)]
                                                 for ra, rb in zip(masks[xr + 8 * h], my)]
            ma0, ma1 = masks[xr], masks[xr + 8]
            mb = [masks[BX + wy * 16 + 8 * j + G_] for j in range(2)]
            for kk in range(0, BK, 4):
                k = kk + T_
                a0, a1 = rd(k * SX + xr), rd(k * SX + xr + 8)
                q0, q1 = rd(PLANES + k * SX + xr), rd(PLANES + k * SX + xr + 8)
                m0, m1 = (ma0 >> k) & 1, (ma1 >> k) & 1
                for j in range(2):
                    yb = BK * SX + k * SY + wy * 16 + 8 * j + G_
                    b, bq = rd(yb), rd(PLANES + yb)
                    bm = (mb[j] >> k) & 1
                    s["x"][:, j] += _dmma(a0, a1, bm)
                    s["xx"][:, j] += _dmma(q0, q1, bm)
                    s["y"][:, j] += _dmma(m0, m1, b)
                    s["yy"][:, j] += _dmma(m0, m1, bq)
                    s["xy"][:, j] += _dmma(a0, a1, b)
        # epilogue
        for j in range(2):
            for e in range(4):
                xi = bx0 + wx * 16 + G_ + 8 * (e >> 1)
                yj = by0 + wy * 16 + 8 * j + 2 * T_ + (e & 1)
                ok = (xi < tile) & (yj < ylen)
                N = cnt[:, j, e]
                safe = np.where(N > 0, N, 1)
                Sx, Sy = s["x"][:, j, e], s["y"][:, j, e]
                with np.errstate(invalid="ignore", divide="ignore"):
                    cov = s["xy"][:, j, e] - Sx * Sy / safe
                    vx = s["xx"][:, j, e] - Sx * Sx / safe
                    vy = s["yy"][:, j, e] - Sy * Sy / safe
                    r = cov / np.sqrt(vx * vy)
                r = np.where(r > 1, 1.0, np.where(r < -1, -1.0, r))
                r = np.where(N == 0, 0.0, r)
                np.add.at(writes, (xi[ok], yj[ok]), 1)
                r_out[xi[ok], yj[ok]] = r[ok]
                n_out[xi[ok], yj[ok]] = N[ok]
    return r_out, n_out, writes


def _fz_table(n, p, seed):
    rng = np.random.default_rng(seed)
    data = np.log1p(rng.poisson(2.0, (n, p)) + rng.random((n, p)))
    data[rng.random((n, p)) < 0.5] = 0.0
    # multiples of 1/64, so every sum is exact in any order and the
    # degenerate columns give the same r (or NaN) on both sides
    data = np.round(data * 64.0) / 64.0
    data[:, 3] = 0.0                                   # N = 0
    data[:, 5] = np.where(data[:, 5] != 0, 1.5, 0.0)    # constant -> NaN
    data[:, 7] = data[:, 6]                             # copy
    return data


@pytest.mark.parametrize("n,p,block,base16", [
    (70, 41, (3, 37, 1, 39), True),        # ragged n, tiles; odd p and offsets
    (64, 100, (0, 64, 0, 32), True),        # one whole block
    (45, 131, (1, 70, 30, 65), False),      # unaligned base: 8-byte copies
    (33, 97, (60, 37, 2, 95), True),        # the table's last column staged
])
def test_k2_maps(n, p, block, base16):
    data = _fz_table(n, p, n + p)
    start, tile, ys, ylen = block
    r, N, writes = emulate_k2(data, start, tile, ys, ylen, base16)
    assert (writes == 1).all()
    wr, wN = K.fz_nz_stats_ref(torch.from_numpy(data), start, tile, ys, ylen)
    wr, wN = wr.numpy(), wN.numpy()
    np.testing.assert_array_equal(N, wN)
    nan = np.isnan(wr)
    np.testing.assert_array_equal(np.isnan(r), nan)
    np.testing.assert_allclose(r[~nan], wr[~nan], rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def _match80(v7, code):
    return ~((v7 ^ code) + U32(0x7F7F7F7F)) & U32(0x80808080)


def _bytes(words):
    """(..., 4) uint8 of contiguous uint32 words (little-endian)."""
    return np.ascontiguousarray(words)[..., None].view(np.uint8)


def _mma_u8(a, b0, b1):
    """m16n8k32 u8 per warp, for na x nb level pairs at once: a (na, 4,
    warps, 32) and b0, b1 (nb, warps, 32) lane registers; returns (na, nb,
    warps, 4, 32) int64 accumulator increments.  Lane (g, t): a0 =
    A[g][4t..], a1 = A[g+8][4t..], a2 = A[g][16+4t..], a3 = A[g+8][16+4t..];
    b0 = B[4t..][g], b1 = B[16+4t..][g]."""
    na, nb, w = a.shape[0], b0.shape[0], b0.shape[1]
    A = np.full((na, w, 16, 32), -1, np.int64)
    B = np.full((nb, w, 32, 8), -1, np.int64)
    kq = 4 * T_[:, None] + np.arange(4)[None, :]     # (32, 4)
    for i, (rows, koff) in enumerate(((G_, 0), (G_ + 8, 0), (G_, 16), (G_ + 8, 16))):
        A[:, :, rows[:, None], kq + koff] = _bytes(a[:, i])
    B[:, :, kq, G_[:, None]] = _bytes(b0)
    B[:, :, kq + 16, G_[:, None]] = _bytes(b1)
    assert (A >= 0).all() and (B >= 0).all()
    C = np.einsum("awik,bwkj->abwij", A, B)
    return np.stack([C[:, :, :, G_ + 8 * (e >> 1), 2 * T_ + (e & 1)]
                     for e in range(4)], axis=3)


def replay_level_products(dataT, start, tile, L, ys, ylen, first, gw=None):
    """``level_products<first, gw>`` of int8_indicator_pipe.cuh replayed
    block tile by block tile (block tiles in launch order, X tiles
    fastest); ``gw`` levels a side a sweep, the header's G by default.
    Yields (blk, xt, yt, sweeps): the block tile's origin inside the block
    and ``sweeps(a_lo, a_hi)``, the sweeps of X levels [a_lo, a_hi) against
    Y levels first..L-1, each (a0, na, b0, nb, acc) with acc (na, nb, 2,
    WARPS, 4, 32) the int64 accumulators of levels a0 + a, b0 + b (128 a
    match).  As in the kernel, every raw X word becomes gw indicators, of
    which the first na are counted."""
    c = K3C
    p, n = dataT.shape
    raw = dataT.astype(np.int8).view(np.uint8).ravel()
    total = p * n
    BX, BY, CHUNK, WINDOW = (c[k] for k in ("BX", "BY", "CHUNK", "WINDOW"))
    G = c["G"] if gw is None else gw
    WXN, PAD = c["WXN"], U32(0x7F7F7F7F)
    ntx = -(-tile // BX)
    warps = np.arange(c["WARPS"])[:, None]
    chunks = -(-n // CHUNK)
    for blk in range(ntx * -(-ylen // BY)):
        xt, yt = blk % ntx * BX, blk // ntx * BY
        nx, ny = min(BX, tile - xt), min(BY, ylen - yt)
        rows = np.array([start + xt + min(r, nx - 1) if r < BX
                         else ys + yt + min(r - BX, ny - 1)
                         for r in range(BX + BY)])
        # the staged chunks (load_stage): aligned windows, zero fill at the end
        stages = []
        for kc in range(chunks):
            st = np.zeros((BX + BY) * WINDOW, np.uint8)
            for r, row in enumerate(rows):
                for w in range(WINDOW // 16):
                    a = ((row * n + kc * CHUNK) & ~15) + 16 * w
                    nb = 0 if a >= total else min(16, total - a)
                    assert nb == 0 or a + nb <= total     # no byte read past the end
                    st[r * WINDOW + 16 * w:r * WINDOW + 16 * w + nb] = raw[a:a + nb]
            stages.append(st.view(U32))
        off = (rows * n) & 15
        rword = np.arange(BX + BY) * (WINDOW // 4) + (off >> 2)
        rshift = 8 * (off & 3)

        def load_word(st, r, pos, rem):
            wi = rword[r] + (pos >> 2)
            assert (wi + 1 < len(st)).all()
            both = (st[wi + 1].astype(np.uint64) << np.uint64(32)) | st[wi]
            wv = (both >> rshift[r].astype(np.uint64)).astype(U32) & PAD
            keep = np.clip(rem - pos, 0, 4)
            m = np.where(keep >= 4, U32(0xFFFFFFFF),
                         ((np.uint64(1) << (8 * keep).astype(np.uint64)) - np.uint64(1)).astype(U32))
            return (wv & m) | (PAD & ~m)

        xr = 16 * (warps % WXN) + G_
        yr = BX + 16 * (warps // WXN) + G_
        words = []                      # per chunk and k-step: A (4) and B (2 x 2)
        for kc in range(chunks):
            rem = n - kc * CHUNK
            for kk in range(0, CHUNK, 32):
                p0 = kk + 4 * T_
                p1 = p0 + 16
                a = np.stack([load_word(stages[kc], xr, p0, rem),
                              load_word(stages[kc], xr + 8, p0, rem),
                              load_word(stages[kc], xr, p1, rem),
                              load_word(stages[kc], xr + 8, p1, rem)])
                bw = [(load_word(stages[kc], yr + 8 * j, p0, rem),
                       load_word(stages[kc], yr + 8 * j, p1, rem)) for j in range(2)]
                words.append((a, bw))

        def sweeps(a_lo, a_hi):
            for a0 in range(a_lo, a_hi, G):
                na = min(G, a_hi - a0)
                for b0 in range(first, L, G):
                    nb = min(G, L - b0)
                    acodes = U32(0x01010101) * (a0 + np.arange(G, dtype=U32))
                    bcodes = U32(0x01010101) * (b0 + np.arange(nb, dtype=U32))
                    acc = np.zeros((na, nb, 2, c["WARPS"], 4, 32), np.int64)
                    for a, bw in words:
                        ai = _match80(a[None], acodes[:, None, None, None])
                        assert ai.shape[0] == G       # indicators a raw word
                        ai = ai[:na]
                        for j, (v0, v1) in enumerate(bw):
                            bi0 = _match80(v0[None], bcodes[:, None, None]) >> 7
                            bi1 = _match80(v1[None], bcodes[:, None, None]) >> 7
                            acc[:, :, j] += _mma_u8(ai, bi0, bi1)
                    yield a0, na, b0, nb, acc

        yield blk, xt, yt, sweeps


def emulate_k3(dataT, start, tile, L, ys, ylen):
    """K3 replayed block by block; returns (planes, writes)."""
    c = K3C
    WXN, ES = c["WXN"], c["ESTRIDE"]
    planes = np.full((L * L, tile, ylen), -1, np.int64)
    writes = np.zeros((L * L, tile, ylen), np.int64)
    warps = np.arange(c["WARPS"])[:, None]
    for _, xt, yt, sweeps in replay_level_products(dataT, start, tile, L, ys,
                                                   ylen, 0):
        for a0, na, b0, nb, acc in sweeps(0, L):
            # epilogue: a warp buffer, then four neighbouring counts a store
            buf = np.full((na, nb, c["WARPS"], 16 * ES), -1, np.int64)
            for j in range(2):
                for e in range(4):
                    slot = (G_ + 8 * (e >> 1)) * ES + 8 * j + 2 * T_ + (e & 1)
                    buf[:, :, warps, slot] = acc[:, :, j, :, e] >> 7
            plane = ((a0 + np.arange(na))[:, None] * L
                     + b0 + np.arange(nb)[None, :])[:, :, None, None]
            for h in range(2):
                r = (LANE >> 2) + 8 * h
                col = 4 * (LANE & 3)
                x = xt + 16 * (warps % WXN) + r
                y = yt + 16 * (warps // WXN) + col
                for q in range(4):
                    v = buf[:, :, warps, r * ES + col + q]
                    shape = v.shape
                    ok = np.broadcast_to((x < tile) & (y + q < ylen), shape)
                    pl = np.broadcast_to(plane, shape)[ok]
                    xs = np.broadcast_to(x, shape)[ok]
                    yq = np.broadcast_to(y + q, shape)[ok]
                    assert (v[ok] >= 0).all()
                    np.add.at(writes, (pl, xs, yq), 1)
                    planes[pl, xs, yq] = v[ok]
    return planes, writes


@pytest.mark.parametrize("L,n,p,block", [
    (2, 300, 120, (5, 40, 50, 70)),     # 3 chunks, n % 16 = 12, table's end
    (3, 129, 200, (0, 64, 0, 64)),      # 16-byte stores (y_len % 4 == 0)
    (12, 100, 60, (7, 20, 3, 36)),      # 16 level sweeps
    (21, 50, 70, (2, 33, 45, 17)),      # 49 sweeps, two X tiles
    (127, 40, 20, (3, 16, 1, 19)),      # 43 x 43 sweeps
])
def test_k3_maps(L, n, p, block):
    rng = np.random.default_rng(L)
    dataT = rng.integers(0, L, (p, n)).astype(np.int8)
    dataT[1] = 0
    start, tile, ys, ylen = block
    planes, writes = emulate_k3(dataT, start, tile, L, ys, ylen)
    assert (writes == 1).all()
    want = K.pair_ctab_planes_ref(torch.from_numpy(dataT), start, tile, L, ys,
                                  ylen).numpy()
    np.testing.assert_array_equal(planes, want)


def test_k3_indicator_matches_only_its_level():
    """The three-instruction byte test: 0x80 exactly where a sample equals
    the level, for every value the table and the pad can hold."""
    vals = np.arange(128, dtype=np.uint8)               # 0..126 and the pad
    words = np.frombuffer(np.repeat(vals, 4).tobytes(), U32)
    for level in range(127):
        got = _match80(words, U32(0x01010101 * level))
        want = np.where(vals == level, U32(0x80808080), U32(0))
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def emulate_k4(dataT, start, tile, L, ys, ylen):
    """K4 replayed: the wrapper's sub-block walk (``k4_sub_blocks``); per
    sub-block the count kernel's grid, block tiles x X level groups, each
    block writing the sweeps of its 3 X levels against Y levels 1..L-1 to
    the slab (``CountStore``); then the epilogue kernel's reads, one thread
    a slab pair.

    Every slab slot must be written once, and each pair's epilogue must
    read only slots written for that pair.  Returns the (L-1)^2 joint
    counts each pair's epilogue reads, (tile, ylen, K, K), and how many
    epilogues ran for each pair."""
    c = K4C
    nl = L - 1                          # levels >= 1 a side
    BX, BY, G, WXN, PAIRS, SUB = (c[k] for k in ("BX", "BY", "G", "WXN",
                                                  "PAIRS", "SUB_PAIRS"))
    joint = np.full((tile, ylen, nl, nl), -1, np.int64)
    runs = np.zeros((tile, ylen), np.int64)
    warps = np.arange(c["WARPS"])[:, None]
    for xo, xl, yo, yl in K.k4_sub_blocks(L, tile, ylen):
        ntx = -(-xl // BX)
        nblocks = ntx * -(-yl // BY)
        stride = nblocks * PAIRS
        assert nl * nl * stride * 4 <= K.K4_SCRATCH_BYTES
        # the count and, for the check, the pair (x * ylen + y of the block)
        # whose mma accumulator wrote it; -1: never written
        vals = np.zeros(nl * nl * stride, np.int64)
        owner = np.full(nl * nl * stride, -1, np.int64)
        for bt, xt, yt, sweeps in replay_level_products(
                dataT, start + xo, xl, L, ys + yo, yl, 1):
            base = bt * PAIRS
            for gy in range(-(-nl // G)):          # the grid's X level groups
                a_lo = 1 + G * gy
                for a0, na, b0, nb, acc in sweeps(a_lo, min(L, a_lo + G)):
                    v = acc >> 7
                    assert (v < 2 ** 31).all()
                    for a in range(na):
                        for b in range(nb):
                            lv = (a0 + a - 1) * nl + b0 + b - 1
                            for j in range(2):
                                for e in range(4):
                                    r = G_ + 8 * (e >> 1)
                                    col = 8 * j + 2 * T_ + (e & 1)
                                    slot = (lv * stride + base + warps * SUB
                                            + r * 16 + col)
                                    # the pair of accumulator e (mma layout)
                                    x = xo + xt + 16 * (warps % WXN) + r
                                    y = yo + yt + 16 * (warps // WXN) + col
                                    assert (owner[slot] == -1).all()
                                    owner[slot] = x * ylen + y
                                    vals[slot] = v[a, b, j, :, e]
        assert (owner >= 0).all()
        # the epilogue kernel: thread i takes slot i % 2048 of block tile
        # i / 2048 (warp sub-tile, then row-major inside it)
        i = np.arange(stride)
        bt, loc = i // PAIRS, i % PAIRS
        w = loc // SUB
        x = xo + bt % ntx * BX + 16 * (w % WXN) + loc % SUB // 16
        y = yo + bt // ntx * BY + 16 * (w // WXN) + loc % 16
        ok = (x < xo + xl) & (y < yo + yl)
        x, y, at = x[ok], y[ok], i[ok]
        np.add.at(runs, (x, y), 1)
        for lv in range(nl * nl):
            slots = lv * stride + at
            np.testing.assert_array_equal(owner[slots], x * ylen + y)
            joint[x, y, lv // nl, lv % nl] = vals[slots]
    return joint, runs


def _stats_from_joint(joint, dataT, marg, levels, max_vals, start, tile, L,
                      ys, ylen, nz):
    """The epilogue's function of the joint counts: the level-0 cells from
    the margins, then mi_block_stats (as the plain version builds them)."""
    from flashweave_tpu_torch.ops.univariate import mi_block_stats

    n = dataT.shape[1]
    f64 = torch.float64
    jt = torch.from_numpy(joint).to(f64)
    mx = marg[1:, start:start + tile].T.to(f64)
    my = marg[1:, ys:ys + ylen].T.to(f64)
    ctab = torch.empty((tile, ylen, L, L), dtype=f64)
    ctab[..., 1:, 1:] = jt
    ctab[..., 1:, 0] = mx[:, None, :] - jt.sum(dim=-1)
    ctab[..., 0, 1:] = my[None, :, :] - jt.sum(dim=-2)
    ctab[..., 0, 0] = (n - mx.sum(dim=1)[:, None] - my.sum(dim=1)[None, :]
                       + jt.sum(dim=(-2, -1)))
    stat, df, n_obs, suff = mi_block_stats(
        ctab, levels[start:start + tile], levels[ys:ys + ylen],
        max_vals[start:start + tile], max_vals[ys:ys + ylen], 5.0, 20.0, nz, L)
    return stat, df.to(torch.int32), n_obs.to(torch.int32), suff


@pytest.mark.parametrize("L,n,p,block,budget", [
    (2, 300, 120, (5, 40, 50, 70), None),      # one level group, one sweep
    (3, 2047, 130, (1, 33, 60, 70), None),     # n = 2,047
    (9, 100, 150, (7, 70, 3, 140), 2),         # 3 level groups, 2 x 3 parts
    (12, 2047, 100, (4, 40, 20, 80), None),    # n = 2,047
    (12, 129, 130, (0, 64, 0, 128), 3),        # 2 x 1 parts
    (21, 50, 70, (2, 33, 45, 17), None),       # last level group of 2
    (22, 60, 90, (5, 40, 7, 80), 1),           # 4 parts of one tile
    (48, 70, 60, (2, 40, 5, 50), 1),           # 16 level groups, 2 parts
    (127, 40, 20, (3, 16, 1, 19), None),       # 42 level groups of 42 sweeps
])
def test_k4_maps(monkeypatch, L, n, p, block, budget):
    """K4's slab writes and epilogue reads against its plain version.
    ``budget`` (in block tiles) shrinks K4_SCRATCH_BYTES so that the
    wrapper's walk cuts the block into several sub-blocks."""
    rng = np.random.default_rng(L + n)
    dataT = rng.integers(0, L, (p, n)).astype(np.int8)
    dataT[1] = 0
    dataT[3, : n // 2] = L - 1
    start, tile, ys, ylen = block
    if budget is not None:
        per_tile = (L - 1) ** 2 * K4C["PAIRS"] * 4
        monkeypatch.setattr(K, "K4_SCRATCH_BYTES", budget * per_tile)
        assert len(K.k4_sub_blocks(L, tile, ylen)) > 1
    joint, runs = emulate_k4(dataT, start, tile, L, ys, ylen)
    assert (runs == 1).all()                       # one epilogue a pair
    st = from_numpy_state(dataT.T.astype(np.float64), None, None, "cpu")
    assert st.L == L and torch.equal(st.dataT, torch.from_numpy(dataT))
    for nz in (0, 1):
        args = (st.dataT, st.marg, st.levels, st.max_vals, start, tile, L, ys,
                ylen, nz)
        got = _stats_from_joint(joint, *args)
        want = K.mi_univar_stats_planes_ref(*args, 5.0, 20.0)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def emulate_k1(dataT, start, tile, L, ys, ylen):
    """K1 replayed: per block tile, one sweep of X and Y levels 1..L-1 with a
    group width of L - 1; the counts stored into the ring by every warp
    (``TileGTest``, int2 stores of neighbouring columns); then every
    thread's G-tests, pair thread + THREADS * s of the tile in row-major
    order, each reading its (L-1)^2 counts from the store.

    Every store slot must be written once a block tile, inside the ring or
    the store's own bytes, with each half-warp's int2 stores on 32 distinct
    banks; each pair's epilogue must read only slots written with its own
    counts.  Returns the joint counts each pair's epilogue reads, (tile,
    ylen, K, K), and how many epilogues wrote each pair."""
    c = K1C
    nl = L - 1
    BX, BY, WXN, RS, CS, THREADS, PAIRS = (
        c[k] for k in ("BX", "BY", "WXN", "RS", "CSTRIDE", "THREADS", "PAIRS"))
    smem_ints = max(c["RING_BYTES"], nl * nl * CS * 4) // 4
    joint = np.full((tile, ylen, nl, nl), -1, np.int64)
    runs = np.zeros((tile, ylen), np.int64)
    warps = np.arange(c["WARPS"])[:, None]
    r0 = 16 * (warps % WXN) + G_                   # (warps, lanes)
    c0 = 16 * (warps // WXN) + 2 * T_
    for _, xt, yt, sweeps in replay_level_products(dataT, start, tile, L, ys,
                                                   ylen, 1, gw=nl):
        done = list(sweeps(1, L))
        assert len(done) == 1                      # one sweep a pair
        a0, na, b0, nb, acc = done[0]
        assert (a0, na, b0, nb) == (1, nl, 1, nl)  # no indicator unused
        store = np.full(smem_ints, -1, np.int64)
        # the block-tile pair whose count a slot holds; -1: never written
        owner = np.full(smem_ints, -1, np.int64)
        for a in range(nl):
            for b in range(nl):
                for j in range(2):
                    for h in range(2):
                        slot = (a * nl + b) * CS + (r0 + 8 * h) * RS + c0 + 8 * j
                        assert (slot % 2 == 0).all()          # int2 aligned
                        for half in (slice(0, 16), slice(16, 32)):
                            banks = np.concatenate([slot[:, half], slot[:, half] + 1],
                                                   axis=1) % 32
                            assert all(len(set(row)) == 32 for row in banks)
                        for e in range(2):
                            assert (owner[slot + e] == -1).all()
                            owner[slot + e] = (r0 + 8 * h) * BY + c0 + 8 * j + e
                            store[slot + e] = acc[a, b, j, :, 2 * h + e] >> 7
        i = np.arange(PAIRS)                       # thread i % THREADS, step i // THREADS
        r, col = i // BY, i % BY
        x, y = xt + r, yt + col
        ok = (x < tile) & (y < ylen)
        for a in range(nl):
            for b in range(nl):
                slots = (a * nl + b) * CS + r[ok] * RS + col[ok]
                np.testing.assert_array_equal(owner[slots], i[ok])
                joint[x[ok], y[ok], a, b] = store[slots]
        np.add.at(runs, (x[ok], y[ok]), 1)
    return joint, runs


@pytest.mark.parametrize("L,n,p,block,nzs", [
    (2, 300, 120, (5, 40, 50, 70), (0, 1)),         # one indicator a side
    (3, 2047, 130, (1, 33, 60, 70), (0, 1, 2)),     # n = 2,047, ragged tiles
    (3, 129, 200, (0, 64, 0, 128), (0, 1, 2)),      # whole block tiles
    (4, 2047, 90, (7, 40, 3, 80), (0, 1)),          # the store past the ring
])
def test_k1_maps(L, n, p, block, nzs):
    """K1's sweep, count store and epilogue map against its plain version."""
    rng = np.random.default_rng(L + n)
    dataT = rng.integers(0, L, (p, n)).astype(np.int8)
    if 2 not in nzs:                # nz 2 needs every variable at 3 levels
        dataT[1] = 0
        dataT[3, : n // 2] = L - 1
    start, tile, ys, ylen = block
    joint, runs = emulate_k1(dataT, start, tile, L, ys, ylen)
    assert (runs == 1).all()                       # every pair written once
    st = from_numpy_state(dataT.T.astype(np.float64), None, None, "cpu")
    assert st.L == L and torch.equal(st.dataT, torch.from_numpy(dataT))
    for nz in nzs:
        args = (st.dataT, st.marg, st.levels, st.max_vals, start, tile, L, ys,
                ylen, nz)
        got = _stats_from_joint(joint, *args)
        want = K.mi_univar_stats_ref(*args, 5.0, 20.0)
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g, w)
        assert want[3].any()
        torch.testing.assert_close(got[0], want[0], rtol=1e-9, atol=1e-15)


def test_load_library_builds_once_per_process(monkeypatch, tmp_path):
    """Later launches reuse the loaded library without hashing the sources."""
    calls = []

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    def fake_build():
        calls.append(1)
        return K.BuildInfo(tmp_path / "lib.so", 0.0, "")

    monkeypatch.setattr(K, "_library", None)
    monkeypatch.setattr(K, "build_library", fake_build)
    monkeypatch.setattr(K.ctypes, "CDLL", lambda path: FakeLib())
    first = K.load_library()
    assert K.load_library() is first
    assert len(calls) == 1
