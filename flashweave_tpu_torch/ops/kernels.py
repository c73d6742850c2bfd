"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

- K1, the fused univariate G-test (``csrc/mi_univar_stats.cu``), replaces
  the TPU kernel ``flashweave_tpu/ops/pallas_kernels.py:mi_univar_stats_pallas``.
  :func:`mi_univar_stats` is its wrapper (L = 2..4), :func:`mi_univar_stats_ref`
  its plain PyTorch version (pair tables, then ``mi_block_stats``).
- K2, the fz_nz masked correlation (``csrc/fz_nz_stats.cu``), replaces
  ``pallas_kernels.py:fz_nz_moments`` (through ``fz_nz_block_pallas``).
  :func:`fz_nz_stats` is its wrapper, :func:`fz_nz_stats_ref` its plain
  PyTorch version (``univariate.fz_nz_block``).
- K3, the contingency planes (``csrc/mi_pair_ctabs.cu``), replaces
  ``pallas_kernels.py:mi_pair_ctabs``.  :func:`pair_ctab_planes` is its
  wrapper, :func:`pair_ctab_planes_ref` its plain version
  (``contingency.pair_ctab_block`` in the plane layout).
- K4, K1's function with the joint counts on the int8 tensor cores
  (``csrc/mi_univar_stats_planes.cu``), replaces
  ``pallas_kernels.py:mi_univar_stats_planes``.
  :func:`mi_univar_stats_planes` is its wrapper (K1's signature, L = 2..127),
  :func:`mi_univar_stats_planes_ref` its plain version (indicator planes, one
  product, the level-0 cells rebuilt from the margins).  K1, K3 and K4 run
  the pipelined int8 tile loop ``csrc/int8_indicator_pipe.cuh``.
- K5, the conditional G-test (``csrc/mi_cond_stats.cu``), replaces the JAX
  package's conditional test function ``flashweave_tpu/ops/condtests.py:
  _mi_cond_kernel`` with its histogram ``ops/contingency.py:cond_ctab_batch``
  (TPU branch ``_packed_hist``): XLA functions there, not Pallas kernels.
  :func:`mi_cond_stats` is its wrapper (tables whose strata are not
  compacted and whose tests fit ``K5_TEST_BYTES``, :func:`k5_fits`),
  :func:`mi_cond_stats_ref` its plain version (the engine's chunks of
  ``condtests._mi_cond_kernel``).
- K6, the mi / mi_nz window digest (``csrc/mi_window_digest.cu``), replaces
  the log p and segment reductions of the JAX package's
  ``flashweave_tpu/ops/condtests.py:_mi_cond_digest_scan_fn`` (over
  ``ops/statfuns.py:mi_logpval_smalldf``), an XLA function.
  :func:`mi_window_digest` is its wrapper, :func:`mi_window_digest_ref` its
  plain version (``condtests._mi_digest``).
- K7, the turbo window digest (``csrc/mi_turbo_digest.cu``), replaces the
  JAX package's ``flashweave_tpu/ops/condtests.py:_turbo_digest_fn``, an
  XLA function.  :func:`mi_turbo_digest` is its wrapper (uncompacted
  strata, an int8 table; the pairs' tables as one int8 tensor-core product
  a window, in the passes of :func:`k7_plan`), :func:`mi_turbo_digest_ref`
  its plain version (``condtests._turbo_pair_stats`` in chunks of windows,
  then ``condtests._mi_digest``).  K6 and K7 share the log p and the reduction
  (``csrc/mi_digest.cuh``); K5 and K7 the G-test epilogue
  (``csrc/mi_cond_epilogue.cuh``).
- K8, the univariate extraction sweep (``csrc/mi_univar_extract.cu``),
  replaces the per-block bodies of the JAX package's extraction passes
  ``flashweave_tpu/ops/univariate.py:_passA_fn`` / ``_passB_fn``, XLA
  functions.  :func:`univar_extract` is its wrapper (one block into an
  :class:`ExtractBuffers` of the sweep), :func:`univar_extract_ref` its
  plain version (``univariate._pair_scores``, then ``torch.nonzero``).
  K8 computes the mi log p with K6's ``csrc/mi_digest.cuh``.
- On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
  tensor it runs the plain version.  Each counts its launches in
  ``<wrapper>.launches``; :func:`launch_counts` reports them all.
- The kernels build at first use with ``nvcc`` from ``csrc/*.cu`` (and the
  headers they include, ``csrc/*.cuh``) into
  ``flashweave_tpu_torch/_build/`` as one shared library with a plain C
  interface, named after a hash of the sources and flags, and load through
  ``ctypes``.  Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .contingency import pair_ctab_block

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# L supported by K1: levels 1..L-1 in one sweep of the tile loop (its
# template instantiations)
K1_LEVELS = range(2, 5)
# L supported by K3 and K4: int8 levels 0..126, leaving the pad value 127
# free
PLANES_LEVELS = range(2, 128)
# K1, K3 and K4 sum 128 per joint match in int32 (int8_indicator_pipe.cuh)
PIPE_MAX_SAMPLES = 1 << 24
# K4's block tile, X x Y pairs (int8_indicator_pipe.cuh's BX x BY)
K4_TILE = (32, 64)
# K4's slab of int32 joint counts in device memory holds at most this much
K4_SCRATCH_BYTES = 1 << 30
# K5's shared memory a test: its histogram, row and column margins and
# strata, (Lr + 1)^2 * L^max_k int32 (csrc/mi_cond_stats.cu's TEST_INTS):
# 108 cells at the nz-uniform headline, 3,125 at L = 5, max_k = 3
K5_TEST_BYTES = 32 << 10
# a block's shared memory on sm_90 (227 KB; csrc/mi_turbo_digest.cu)
SMEM_BLOCK_BYTES = 232_448
# K6's tests a block (csrc/mi_window_digest.cu's TILE_MIN .. TILE_MAX) and
# its scratch a tile: two partial digests of 16 bytes and an int32
K6_TILE_MAX = 2048
K6_TILE_MIN = 256
K6_SCRATCH_TILE_BYTES = 36
# K7's warps a window at most (csrc/mi_turbo_digest.cu's MAX_WARPS), the
# 16 x 8 accumulator tiles a warp holds (ACC_TILES), the M-tiles of a pass
# (MAX_MTW), the largest Lr (MAX_LR: a candidate's Lr^2 rows within
# MAX_MTW tiles at any alignment), the subsets a pass at most (their codes
# in shared memory), and its ring: CHUNK samples a stage, each column's
# chunk staged in WINDOW bytes, STAGES stages, and a subset's descriptor
# of ZDESC_INTS ints (its size and members' columns)
K7_WARPS = 8
K7_ACC_TILES = 16
K7_MAX_MTW = 4
K7_MAX_LR = 7
K7_ZROWS = 128
K7_CHUNK = 128
K7_WINDOW = K7_CHUNK + 16
K7_STAGES = 3
K7_ZDESC_INTS = 8
# K8's bin edges (csrc/mi_univar_extract.cu's N_EDGES; the extraction's
# N_EXTRACT_BINS) and its tally: the cursor, the unreliable pairs, a count
# an edge
K8_EDGES = 48
K8_TALLY = 2 + K8_EDGES
# K8's tile: the consecutive pairs of a row a block takes at once
# (csrc/mi_univar_extract.cu's TILE)
K8_TILE = 2048


@dataclass
class BuildInfo:
    path: Path
    seconds: float      # 0.0 when an existing library was reused
    log: str            # nvcc's output (ptxas register / spill report),
                        # kept beside the library for a later reuse


_library = None     # process-wide (CDLL, BuildInfo), set by the first load


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_library() -> BuildInfo:
    """Compile ``csrc/*.cu`` into ``_build/libfw_kernels_<hash>.so``.

    One ``nvcc -c`` per source, all started together, then one link.  The
    hash covers the sources and the flags, so an edited source builds a new
    library.  Concurrent builds each write private temporary files and
    rename the library into place.  nvcc's report is kept beside it as
    ``.log``, so a reuse returns it too."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libfw_kernels_{h.hexdigest()[:16]}.so"
    report = out.with_suffix(".log")
    if out.exists():
        return BuildInfo(out, 0.0,
                         report.read_text() if report.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(logs)
    try:
        for proc in procs:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    tmp_report = report.with_name(f"{report.name}.{os.getpid()}.tmp")
    tmp_report.write_text(log)
    os.replace(tmp_report, report)
    os.replace(tmp, out)
    return BuildInfo(out, time.perf_counter() - t0, log)


def load_library():
    """(CDLL, BuildInfo) of the kernel library, built (or found) at the
    first call of the process.  Later calls return it without hashing the
    sources again, so a launch costs no file reads; an edit to ``csrc/``
    takes effect in a new process."""
    global _library
    if _library is None:
        info = build_library()
        lib = ctypes.CDLL(str(info.path))
        ptr = ctypes.c_void_p
        i32 = ctypes.c_int
        f64 = ctypes.c_double
        lib.fw_mi_univar_stats.argtypes = [
            ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, i32, i32, f64,
            f64, ptr, ptr, ptr, ptr, ptr]
        lib.fw_mi_univar_stats.restype = i32
        lib.fw_fz_nz_stats.argtypes = [
            ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr]
        lib.fw_fz_nz_stats.restype = i32
        lib.fw_mi_univar_stats_planes.argtypes = [
            ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, i32, i32,
            f64, f64, ptr, ptr, ptr, ptr, ptr, ptr]
        lib.fw_mi_univar_stats_planes.restype = i32
        lib.fw_mi_pair_ctabs.argtypes = [
            ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr]
        lib.fw_mi_pair_ctabs.restype = i32
        lib.fw_mi_cond_stats.argtypes = [
            ptr, i32, i32, ptr, ptr, ptr, i32, i32, i32, i32, f64, ptr, ptr,
            ptr, ptr, ptr]
        lib.fw_mi_cond_stats.restype = i32
        i64 = ctypes.c_longlong
        lib.fw_mi_window_digest.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, f64, ptr, ptr,
            ptr, ptr]
        lib.fw_mi_window_digest.restype = i32
        lib.fw_digest_core_check.argtypes = [i64, ctypes.c_ulonglong, ptr,
                                             ptr]
        lib.fw_digest_core_check.restype = i32
        lib.fw_mi_turbo_smem_bytes.argtypes = [i32] * 7
        lib.fw_mi_turbo_smem_bytes.restype = i32
        lib.fw_mi_turbo_digest.argtypes = [
            ptr, i32, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr, ptr,
            ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
            i32, i32, i32, f64, f64, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        lib.fw_mi_turbo_digest.restype = i32
        lib.fw_univar_extract.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, f64, i32,
            i32, ptr, ptr, i64, ptr, ptr, ptr, ptr, ptr, ptr, i32, ptr]
        lib.fw_univar_extract.restype = i32
        lib.fw_univar_extract_blocks_per_sm.argtypes = [ptr]
        lib.fw_univar_extract_blocks_per_sm.restype = i32
        lib.fw_cuda_error_string.argtypes = [i32]
        lib.fw_cuda_error_string.restype = ctypes.c_char_p
        _library = (lib, info)
    return _library


def _check_cuda_error(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.fw_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# ---------------------------------------------------------------------------
# K1: fused univariate G-test
# ---------------------------------------------------------------------------

def level_marginals(data: torch.Tensor, L: int) -> torch.Tensor:
    """(L, p) int32 per-variable level counts of an (n, p) table: the fixed
    contingency-table margins from which K1 rebuilds the level-0 cells."""
    lv = torch.arange(L, device=data.device, dtype=data.dtype).view(-1, 1, 1)
    return (data.unsqueeze(0) == lv).sum(dim=1, dtype=torch.int32)


def mi_univar_stats_ref(dataT, marg, levels, max_vals, start, tile, L,
                        y_start=0, y_len=None, nz=1, hps=5.0, n_obs_min=0.0):
    """Plain PyTorch version of K1: pair tables by one-hot product
    (``contingency.pair_ctab_block``), then ``univariate.mi_block_stats``.

    ``marg`` is unused (the tables are recounted); it keeps the kernel's
    signature.  Returns (stat float64, df int32, n_obs int32, suff bool),
    each (tile, y_len)."""
    from .univariate import mi_block_stats

    if y_len is None:
        y_len = dataT.shape[0]
    ctab = pair_ctab_block(dataT.T, start, tile, L, y_start, y_len)
    stat, df, n_obs, suff = mi_block_stats(
        ctab, levels[start:start + tile], levels[y_start:y_start + y_len],
        max_vals[start:start + tile], max_vals[y_start:y_start + y_len],
        hps, n_obs_min, nz, L)
    return stat, df.to(torch.int32), n_obs.to(torch.int32), suff


def _check_block(who, dataT, L, supported, start, tile, y_start, y_len):
    """Checks shared by the wrappers of K1, K3 and K4 on a device table."""
    p, n = dataT.shape
    if dataT.device.type != "cuda":
        raise ValueError(f"unsupported device {dataT.device}")
    if dataT.dtype != torch.int8 or not dataT.is_contiguous():
        raise ValueError(
            f"{who} needs dataT as a contiguous int8 (p, n) tensor")
    if L not in supported:
        raise ValueError(f"{who} supports L in {supported.start}.."
                         f"{supported.stop - 1}, got L={L}")
    if not (0 <= start and start + tile <= p and 0 <= y_start
            and y_start + y_len <= p):
        raise ValueError("X-block or Y-slab out of range")
    if tile == 0 or y_len == 0 or n == 0:
        raise ValueError("empty X-block, Y-slab or table")


def _check_stats_args(dataT, marg, levels, max_vals, L, nz):
    """Checks of the G-test inputs that K1 and K4 take beside the table."""
    p = dataT.shape[0]
    if nz not in (0, 1, 2) or (nz == 2 and L != 3):
        raise ValueError(f"invalid nz={nz} for L={L}")
    for name, t, shape in (("marg", marg, (L, p)), ("levels", levels, (p,)),
                           ("max_vals", max_vals, (p,))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dataT.device):
            raise ValueError(
                f"{name} must be a contiguous int32 {shape} tensor on "
                f"{dataT.device}")


def _stats_outputs(tile, y_len, dev):
    """Empty (stat, df, n_obs, suff) of a (tile, y_len) block."""
    return tuple(torch.empty((tile, y_len), dtype=dt, device=dev)
                 for dt in (torch.float64, torch.int32, torch.int32,
                            torch.bool))


def mi_univar_stats(dataT, marg, levels, max_vals, start, tile, L, y_start=0,
                    y_len=None, nz=1, hps=5.0, n_obs_min=0.0):
    """Univariate mi / mi_nz G-test of the X-block [start, start+tile)
    against the Y-slab [y_start, y_start+y_len).

    Args:
      dataT: (p, n) int8 contiguous table (variables x samples).
      marg: (L, p) int32 from :func:`level_marginals`.
      levels, max_vals: (p,) int32.
      nz: 0 plain, 1 per-variable nz offsets, 2 nz-uniform (L == 3 and every
        max_val > 1).
    Returns (stat float64, df int32, n_obs int32, suff bool), each
    (tile, y_len).  CUDA tensors run K1 (L = 2..4, n < 2^24, the table
    16-byte aligned); CPU tensors run the plain version.
    """
    p, n = dataT.shape
    if y_len is None:
        y_len = p
    if dataT.device.type == "cpu":
        return mi_univar_stats_ref(dataT, marg, levels, max_vals, start, tile,
                                   L, y_start, y_len, nz, hps, n_obs_min)
    _check_block("K1", dataT, L, K1_LEVELS, start, tile, y_start, y_len)
    _check_pipe_table("K1", dataT)
    _check_stats_args(dataT, marg, levels, max_vals, L, nz)
    stat, df, nobs, suff = _stats_outputs(tile, y_len, dataT.device)
    lib, _ = load_library()
    with torch.cuda.device(dataT.device):
        stream = torch.cuda.current_stream(dataT.device).cuda_stream
        err = lib.fw_mi_univar_stats(
            dataT.data_ptr(), n, p, start, tile, y_start, y_len,
            marg.data_ptr(), levels.data_ptr(), max_vals.data_ptr(), L,
            int(nz), float(hps), float(n_obs_min), stat.data_ptr(),
            df.data_ptr(), nobs.data_ptr(), suff.data_ptr(), stream)
    _check_cuda_error(lib, err, "mi_univar_stats launch")
    mi_univar_stats.launches += 1
    return stat, df, nobs, suff


mi_univar_stats.launches = 0


# ---------------------------------------------------------------------------
# K3 and K4: level-indicator products on the int8 tensor cores
# ---------------------------------------------------------------------------

def _pad2(x, rows, cols, fill):
    """``x`` padded at the end of both axes to multiples of rows / cols."""
    r, c = x.shape
    out = torch.full((r + (-r) % rows, c + (-c) % cols), fill, dtype=x.dtype,
                     device=x.device)
    out[:r, :c] = x
    return out


def x_indicator_planes(dataT, L, tx, tn):
    """(p/tx, K*tx, n_pad) int8 packed X indicator planes of a (p, n) table,
    K = L - 1 (the layout of the JAX package's
    ``pallas_kernels.x_indicator_planes``).

    Tile i, row ia*tx + t, column r holds 1 iff dataT[i*tx + t, r] == ia + 1.
    Variables and samples are padded with -1, which matches no level."""
    K = L - 1
    d = _pad2(dataT.to(torch.int8), tx, tn, -1)
    p_pad, n_pad = d.shape
    lv = torch.arange(1, L, dtype=torch.int8, device=d.device)
    planes = d.view(p_pad // tx, 1, tx, n_pad) == lv.view(1, K, 1, 1)
    return planes.to(torch.int8).reshape(p_pad // tx, K * tx, n_pad)


def y_indicator_planes(data, L, ty, tn):
    """(n_pad, p/ty * K*ty) int8 packed Y indicator planes of an (n, p)
    table (``pallas_kernels.y_indicator_planes``).

    Column j*K*ty + ib*ty + c holds 1 iff data[r, j*ty + c] == ib + 1."""
    K = L - 1
    d = _pad2(data.to(torch.int8), tn, ty, -1)
    n_pad, p_pad = d.shape
    lv = torch.arange(1, L, dtype=torch.int8, device=d.device)
    planes = d.view(n_pad, p_pad // ty, 1, ty) == lv.view(1, 1, K, 1)
    return planes.to(torch.int8).reshape(n_pad, (p_pad // ty) * K * ty)


def _check_pipe_table(who, dataT):
    """What the int8 pipe (K1, K3, K4) needs of the table beyond
    _check_block."""
    if dataT.shape[1] >= PIPE_MAX_SAMPLES or dataT.data_ptr() % 16:
        raise ValueError(f"{who} needs n < {PIPE_MAX_SAMPLES} and a 16-byte "
                         "aligned table")


def k4_sub_blocks(L: int, tile: int, y_len: int):
    """K4's walk over a (tile, y_len) block: (x_off, x_len, y_off, y_len)
    sub-blocks of whole block tiles, covering the block once, each with a
    slab ((L-1)^2 int32 counts of every pair of its block tiles) of at most
    ``K4_SCRATCH_BYTES``.  Whole X-blocks are cut along Y, the parts as
    equal as the tiles allow."""
    bx, by = K4_TILE
    per_tile = (L - 1) ** 2 * bx * by * 4
    budget = max(1, K4_SCRATCH_BYTES // per_tile)      # block tiles a slab
    ntx, nty = -(-tile // bx), -(-y_len // by)
    sx = min(ntx, budget)
    sy = max(1, min(nty, budget // sx))
    parts_x, parts_y = -(-ntx // sx), -(-nty // sy)
    sx, sy = -(-ntx // parts_x), -(-nty // parts_y)
    return [(i * sx * bx, min(sx * bx, tile - i * sx * bx),
             j * sy * by, min(sy * by, y_len - j * sy * by))
            for i in range(parts_x) for j in range(parts_y)]


def pair_ctab_planes_ref(dataT, start, tile, L, y_start=0, y_len=None):
    """Plain PyTorch version of K3: ``contingency.pair_ctab_block`` of the
    X-block [start, start+tile) against the Y-slab [y_start, y_start+y_len),
    laid out as (L*L, tile, y_len) int32 planes (plane a*L + b counts the
    rows with X == a and Y == b)."""
    ct = pair_ctab_block(dataT.T, start, tile, L, y_start, y_len)
    return ct.permute(2, 3, 0, 1).reshape(L * L, tile, -1).to(torch.int32)


def pair_ctab_planes(dataT, start, tile, L, y_start=0, y_len=None):
    """All L*L contingency planes of the X-block [start, start+tile) against
    the Y-slab [y_start, y_start+y_len) of a (p, n) int8 table: (L*L, tile,
    y_len) int32.  CUDA tensors run K3 (L = 2..127, n < 2^24, the table
    16-byte aligned); CPU tensors run the plain version."""
    p, n = dataT.shape
    if y_len is None:
        y_len = p
    if dataT.device.type == "cpu":
        return pair_ctab_planes_ref(dataT, start, tile, L, y_start, y_len)
    _check_block("K3", dataT, L, PLANES_LEVELS, start, tile, y_start, y_len)
    _check_pipe_table("K3", dataT)
    planes = torch.empty((L * L, tile, y_len), dtype=torch.int32,
                         device=dataT.device)
    lib, _ = load_library()
    with torch.cuda.device(dataT.device):
        stream = torch.cuda.current_stream(dataT.device).cuda_stream
        err = lib.fw_mi_pair_ctabs(dataT.data_ptr(), n, p, start, tile,
                                   y_start, y_len, L, planes.data_ptr(),
                                   stream)
    _check_cuda_error(lib, err, "pair_ctab_planes launch")
    pair_ctab_planes.launches += 1
    return planes


pair_ctab_planes.launches = 0


def mi_univar_stats_planes_ref(dataT, marg, levels, max_vals, start, tile, L,
                               y_start=0, y_len=None, nz=1, hps=5.0,
                               n_obs_min=0.0):
    """Plain PyTorch version of K4: the X-block's and Y-slab's indicator
    planes, one integer-exact float64 product for the (L-1)^2 joint counts,
    the level-0 row, column and corner rebuilt from the margins ``marg`` and
    n (as the JAX package's ``_mi_epilogue`` does), then
    ``univariate.mi_block_stats``.  Returns (stat float64, df int32, n_obs
    int32, suff bool), each (tile, y_len)."""
    from .univariate import mi_block_stats

    p, n = dataT.shape
    if y_len is None:
        y_len = p
    K = L - 1
    f64 = torch.float64
    xp = x_indicator_planes(dataT[start:start + tile], L, tile, 1)[0]
    yp = y_indicator_planes(dataT[y_start:y_start + y_len].T, L, y_len, 1)
    joint = (xp.to(f64) @ yp.to(f64)).view(K, tile, K, y_len)
    joint = joint.permute(1, 3, 0, 2)                 # (tile, y_len, K, K)
    mx = marg[1:, start:start + tile].T.to(f64)       # (tile, K)
    my = marg[1:, y_start:y_start + y_len].T.to(f64)  # (y_len, K)
    ctab = torch.empty((tile, y_len, L, L), dtype=f64, device=dataT.device)
    ctab[..., 1:, 1:] = joint
    ctab[..., 1:, 0] = mx[:, None, :] - joint.sum(dim=-1)
    ctab[..., 0, 1:] = my[None, :, :] - joint.sum(dim=-2)
    ctab[..., 0, 0] = (n - mx.sum(dim=1)[:, None] - my.sum(dim=1)[None, :]
                       + joint.sum(dim=(-2, -1)))
    stat, df, n_obs, suff = mi_block_stats(
        ctab, levels[start:start + tile], levels[y_start:y_start + y_len],
        max_vals[start:start + tile], max_vals[y_start:y_start + y_len],
        hps, n_obs_min, nz, L)
    return stat, df.to(torch.int32), n_obs.to(torch.int32), suff


def mi_univar_stats_planes(dataT, marg, levels, max_vals, start, tile, L,
                           y_start=0, y_len=None, nz=1, hps=5.0,
                           n_obs_min=0.0):
    """K1's function (:func:`mi_univar_stats`, same arguments and results)
    with the joint counts on the int8 tensor cores, for L = 2..127.  CUDA
    tensors run K4 (n < 2^24, the table 16-byte aligned) over the
    sub-blocks of :func:`k4_sub_blocks`; CPU tensors run the plain
    version."""
    p, n = dataT.shape
    if y_len is None:
        y_len = p
    if dataT.device.type == "cpu":
        return mi_univar_stats_planes_ref(dataT, marg, levels, max_vals, start,
                                          tile, L, y_start, y_len, nz, hps,
                                          n_obs_min)
    _check_block("K4", dataT, L, PLANES_LEVELS, start, tile, y_start, y_len)
    _check_pipe_table("K4", dataT)
    _check_stats_args(dataT, marg, levels, max_vals, L, nz)
    dev = dataT.device
    outs = _stats_outputs(tile, y_len, dev)
    bx, by = K4_TILE
    subs = k4_sub_blocks(L, tile, y_len)
    tiles = max(-(-xl // bx) * -(-yl // by) for _, xl, _, yl in subs)
    slab = torch.empty(tiles * bx * by * (L - 1) ** 2, dtype=torch.int32,
                       device=dev)
    lib, _ = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for xo, xl, yo, yl in subs:
            # the sub-block's corner in each (tile, y_len) output
            corners = [t.data_ptr() + (xo * y_len + yo) * t.element_size()
                       for t in outs]
            err = lib.fw_mi_univar_stats_planes(
                dataT.data_ptr(), n, p, start + xo, xl, y_start + yo, yl,
                y_len, marg.data_ptr(), levels.data_ptr(), max_vals.data_ptr(),
                L, int(nz), float(hps), float(n_obs_min), *corners,
                slab.data_ptr(), stream)
            _check_cuda_error(lib, err, "mi_univar_stats_planes launch")
    mi_univar_stats_planes.launches += 1
    return outs


mi_univar_stats_planes.launches = 0


# ---------------------------------------------------------------------------
# K2: fz_nz masked correlation
# ---------------------------------------------------------------------------

def fz_nz_stats_ref(data, start, tile, y_start=0, y_len=None):
    """Plain PyTorch version of K2: ``univariate.fz_nz_block`` (six float64
    moment products, then r), with N as int32 like the kernel's."""
    from .univariate import fz_nz_block

    r, N = fz_nz_block(data, start, tile, y_start, y_len)
    return r, N.to(torch.int32)


def fz_nz_stats(data, start, tile, y_start=0, y_len=None):
    """Masked Pearson r and joint nonzero count N of the X-block
    [start, start+tile) against the Y-slab [y_start, y_start+y_len), over the
    rows where both variables are nonzero.

    Args:
      data: (n, p) float64 contiguous table (samples x variables).
    Returns (r float64, N int32), each (tile, y_len).  CUDA tensors run K2;
    CPU tensors run the plain version.
    """
    n, p = data.shape
    if y_len is None:
        y_len = p
    if data.device.type == "cpu":
        return fz_nz_stats_ref(data, start, tile, y_start, y_len)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if data.dtype != torch.float64 or not data.is_contiguous():
        raise ValueError("K2 needs data as a contiguous float64 (n, p) tensor")
    if not (0 <= start and start + tile <= p and 0 <= y_start
            and y_start + y_len <= p):
        raise ValueError("X-block or Y-slab out of range")
    if tile == 0 or y_len == 0 or n == 0:
        raise ValueError("empty X-block, Y-slab or table")
    dev = data.device
    r = torch.empty((tile, y_len), dtype=torch.float64, device=dev)
    nobs = torch.empty((tile, y_len), dtype=torch.int32, device=dev)
    lib, _ = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fw_fz_nz_stats(data.data_ptr(), n, p, start, tile, y_start,
                                 y_len, r.data_ptr(), nobs.data_ptr(), stream)
    _check_cuda_error(lib, err, "fz_nz_stats launch")
    fz_nz_stats.launches += 1
    return r, nobs


fz_nz_stats.launches = 0

# ---------------------------------------------------------------------------
# K5: the conditional G-test
# ---------------------------------------------------------------------------

def k5_fits(L: int, max_k: int, nz: int) -> bool:
    """Whether one test's table at L levels and max_k fits K5's shared
    memory: (Lr + 1)^2 * L^max_k int32 within ``K5_TEST_BYTES``, Lr = L - 1
    under nz-uniform (``nz == 2``), L otherwise."""
    Lr = L - 1 if nz == 2 else L
    return 4 * (Lr + 1) ** 2 * L ** max_k <= K5_TEST_BYTES


def mi_cond_stats_ref(st, desc, hps, max_k, nz):
    """Plain PyTorch version of K5: the engine's route before it, the B
    tests in chunks of ``condtests.CHUNK_ELEMS // n`` through
    ``condtests._mi_cond_kernel`` (row mask, ``cond_ctab_batch``,
    ``statfuns.mi_stats``, occupied strata, power check) with S = L^max_k.
    Arguments and results as :func:`mi_cond_stats`."""
    from . import condtests as ct

    n, B = st.data.shape[0], desc.shape[0]
    chunk = max(1, ct.CHUNK_ELEMS // max(n, 1))
    d = desc.long()
    parts = [ct._mi_cond_kernel(
        st.data, st.levels, st.max_vals, d[s:s + chunk, 0],
        d[s:s + chunk, 1], d[s:s + chunk, 3:], d[s:s + chunk, 2], float(hps),
        max_k, st.L, st.L ** max_k, nz != 0, nz == 2)
        for s in range(0, B, chunk)]
    if not parts:
        return _cond_outputs(0, st.data.device)
    return tuple(torch.cat(t) for t in zip(*parts))


def _cond_outputs(B, dev):
    """Empty (stat, df, n_obs, suff) of B conditional tests."""
    return tuple(torch.empty(B, dtype=dt, device=dev)
                 for dt in (torch.float64, torch.int64, torch.float64,
                            torch.bool))


def mi_cond_stats(st, desc, hps, max_k, nz):
    """The conditional mi / mi_nz G-test of B (X, Y | Z) tests.

    Args:
      st: the table as a ``state.DiscreteState`` (K5 reads its (p, n)
        ``dataT``, the plain version its (n, p) ``data``), with ``levels``,
        ``max_vals`` and L.
      desc: (B, 3 + max_k) int32 rows [X, Y, k, Z_0 .. Z_{max_k-1}]; Zs past
        k are not read.
      nz: 0 plain, 1 per-variable nz offsets, 2 nz-uniform (L == 3, every
        max_val > 1: the sliced (L-1)^2 table).
    Returns (stat float64, df int64, n_obs float64, suff bool), each (B,),
    stratified over all S = L^max_k z-codes (no compaction).  CUDA tensors
    run K5 (an int8 table whose tests fit :func:`k5_fits`), one launch for
    the batch; CPU tensors run the plain version."""
    dataT = st.dataT
    if dataT.device.type == "cpu":
        return mi_cond_stats_ref(st, desc, hps, max_k, nz)
    if dataT.device.type != "cuda":
        raise ValueError(f"unsupported device {dataT.device}")
    p, n = dataT.shape
    L = st.L
    if dataT.dtype != torch.int8 or not dataT.is_contiguous() or n == 0:
        raise ValueError("K5 needs dataT as a contiguous int8 (p, n) tensor")
    if nz not in (0, 1, 2) or (nz == 2 and L != 3):
        raise ValueError(f"invalid nz={nz} for L={L}")
    if not k5_fits(L, max_k, nz):
        raise ValueError(f"K5: a test at L={L}, max_k={max_k} exceeds "
                         f"{K5_TEST_BYTES} bytes of shared memory")
    for name, t, shape in (("levels", st.levels, (p,)),
                           ("max_vals", st.max_vals, (p,)),
                           ("desc", desc, (desc.shape[0], 3 + max_k))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dataT.device):
            raise ValueError(f"{name} must be a contiguous int32 {shape} "
                             f"tensor on {dataT.device}")
    B = desc.shape[0]
    outs = _cond_outputs(B, dataT.device)
    if B == 0:
        return outs
    lib, _ = load_library()
    with torch.cuda.device(dataT.device):
        stream = torch.cuda.current_stream(dataT.device).cuda_stream
        err = lib.fw_mi_cond_stats(
            dataT.data_ptr(), n, p, st.levels.data_ptr(),
            st.max_vals.data_ptr(), desc.data_ptr(), B, max_k, L, int(nz),
            float(hps), *(t.data_ptr() for t in outs), stream)
    _check_cuda_error(lib, err, "mi_cond_stats launch")
    mi_cond_stats.launches += 1
    return outs


mi_cond_stats.launches = 0

# ---------------------------------------------------------------------------
# K6 and K7: the window digests
# ---------------------------------------------------------------------------

_lgamma_tables: dict = {}


def _lgamma_table(max_df: int, device) -> torch.Tensor:
    """The (max(max_df // 2, 1), 2) float64 offsets [lgamma(k + 1),
    lgamma(k + 1/2)] of k = 1.. that ``statfuns.mi_logpval_smalldf`` uses,
    from ``math.lgamma`` as there, uploaded once for each max_df and
    device."""
    key = (max_df, torch.device(device))
    t = _lgamma_tables.get(key)
    if t is None:
        t = torch.tensor([[math.lgamma(k + 1), math.lgamma(k + 0.5)]
                          for k in range(1, max(max_df // 2, 1) + 1)],
                         dtype=torch.float64).to(device)
        _lgamma_tables[key] = t
    return t


def _check_tensor(name, t, dtype, shape, dev):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != dev):
        raise ValueError(f"{name} must be a contiguous {dtype} {tuple(shape)} "
                         f"tensor on {dev}")


def mi_window_digest_ref(stat, df, n_obs, suff, counts, B, log_alpha, max_df):
    """Plain PyTorch version of K6: ``condtests._mi_digest``.  Arguments and
    result as :func:`mi_window_digest`."""
    from . import condtests as ct

    return ct._mi_digest(stat, df, n_obs, suff, counts, B, log_alpha, max_df)


def k6_tile(B: int, sms: int) -> int:
    """K6's tests a block: K6_TILE_MAX, halved down to K6_TILE_MIN while
    B tests would fill fewer than two blocks an SM of ``sms``."""
    tile = K6_TILE_MAX
    while tile > K6_TILE_MIN and -(-B // tile) < 2 * sms:
        tile //= 2
    return tile


def mi_window_digest(stat, df, n_obs, suff, counts, B, log_alpha, max_df,
                     ends=None):
    """The per-candidate digest of B conditional MI tests in NC contiguous
    segments of ``counts`` (NC,) int64 tests: each test's float64 log p
    (``statfuns.mi_logpval_smalldf`` for df <= max_df, 0 where ``suff`` is
    False), significant below ``log_alpha``; per segment exit_e (the first
    non-significant local index, -1 without one), wstat (the stat at the
    last local index attaining the largest significant log p M) and exp(M).

    Args:
      stat, n_obs: (B,) float64; df: (B,) int64; suff: (B,) bool.
      ends: (NC,) int64, the running sums of ``counts`` on the same device,
        which K6 needs (the engine uploads both from the host in one copy)
        and the plain version does without.  K6 holds each segment's length
        by ``ends`` to its count and writes NaN in all three rows of a
        segment where they differ; on the CPU a mismatch raises.
    Returns (3, NC) float64 [exit_e, wstat, exp(M)].  CUDA tensors run K6
    (its tile kernel and, past one tile, its merge kernel: one launch
    counted); CPU tensors run the plain version."""
    dev = stat.device
    if dev.type == "cpu":
        if ends is not None and not torch.equal(ends, torch.cumsum(counts,
                                                                   0)):
            raise ValueError("ends are not the running sums of counts")
        return mi_window_digest_ref(stat, df, n_obs, suff, counts, B,
                                    log_alpha, max_df)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    NC = counts.shape[0]
    for name, t, dt in (("stat", stat, torch.float64),
                        ("df", df, torch.int64),
                        ("n_obs", n_obs, torch.float64),
                        ("suff", suff, torch.bool)):
        _check_tensor(name, t, dt, (B,), dev)
    _check_tensor("counts", counts, torch.int64, (NC,), dev)
    if ends is None:
        raise ValueError("K6 needs ends, the running sums of counts")
    _check_tensor("ends", ends, torch.int64, (NC,), dev)
    if max_df < 0:
        raise ValueError(f"K6: max_df={max_df}")
    out = torch.empty((3, NC), dtype=torch.float64, device=dev)
    if NC == 0:
        return out
    if B <= 0:
        raise ValueError("K6: candidates without tests")
    tile = k6_tile(B, torch.cuda.get_device_properties(dev)
                   .multi_processor_count)
    tiles = -(-B // tile)
    scratch = torch.empty(tiles * K6_SCRATCH_TILE_BYTES, dtype=torch.uint8,
                          device=dev)
    lg = _lgamma_table(max_df, dev)
    lib, _ = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fw_mi_window_digest(
            stat.data_ptr(), df.data_ptr(), n_obs.data_ptr(), suff.data_ptr(),
            counts.data_ptr(), ends.data_ptr(), int(B), NC, int(max_df), tile, float(log_alpha),
            lg.data_ptr(), scratch.data_ptr(), out.data_ptr(), stream)
    _check_cuda_error(lib, err, "mi_window_digest launch")
    mi_window_digest.launches += 1
    return out


mi_window_digest.launches = 0


def digest_core_check(n: int, seed: int, device) -> dict:
    """``csrc/mi_digest_core_check.cu`` on the card: the exp and log main
    paths that K6 and K7 run in each logsumexp step (``mi_digest.cuh``'s
    ``fw_digest::core``) against libdevice's exp() and log(), on n inputs
    each drawn from ``seed``.  Returns the inputs and mismatches of each."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the check runs on a CUDA device, not {dev}")
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    lib, _ = load_library()
    with torch.cuda.device(dev):
        err = lib.fw_digest_core_check(
            int(n), int(seed), counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _check_cuda_error(lib, err, "digest_core_check launch")
    ne, be, nl, bl = counts.tolist()
    return {"exp_inputs": ne, "exp_mismatches": be, "log_inputs": nl,
            "log_mismatches": bl}


@dataclass
class TurboConsts:
    """A turbo window template's constants on one device
    (``learning/hiton.py:_turbo_mxu_template(m, max_k)``), uploaded once
    for each m into the engine's ``_turbo_dev_cache``: the NP distinct
    (candidate, subset) pairs ``pj`` / ``pu`` of its B tests, each test's
    pair ``tpair``, the U subsets ``memb`` (U, max_k) / ``klen``, and the NC
    slots' ``counts`` and first tests ``offs``; int32 views of one
    tensor.  ``host`` keeps klen, pj and pu on the host (numpy), and
    ``plans`` K7's passes (:class:`K7Plan`) for each (L, nz) once made."""
    m: int
    U: int
    B: int
    NC: int
    NP: int
    max_klen: int
    pj: torch.Tensor
    pu: torch.Tensor
    tpair: torch.Tensor
    memb: torch.Tensor
    klen: torch.Tensor
    counts: torch.Tensor
    offs: torch.Tensor
    host: dict = field(default_factory=dict, repr=False)
    plans: dict = field(default_factory=dict, repr=False)

    def test_pairs(self) -> torch.Tensor:
        """(B,) int64: each test's pair in the plain version's (m * U)
        layout, candidate * U + subset (the template's ``jb * U + ub``)."""
        return (self.pj.long() * self.U + self.pu.long())[self.tpair.long()]


def turbo_consts(m, pj, pu, tpair, memb, klen, counts, device) -> TurboConsts:
    """A :class:`TurboConsts` from the template's numpy arrays, one
    host-to-device copy.  Every slot must hold a test, and the counts must
    cover the B tests."""
    import numpy as np

    memb = np.asarray(memb)
    counts = np.asarray(counts, np.int64)
    B = len(tpair)
    if (counts < 1).any() or counts.sum() != B:
        raise ValueError("turbo template: a slot without tests, or counts "
                         "that do not cover the tests")
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    parts = [pj, pu, tpair, memb.reshape(-1), klen, counts, offs]
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(a).reshape(-1).astype(np.int32) for a in parts]))
    flat = flat.to(device)
    views, at = [], 0
    for a in parts:
        views.append(flat[at:at + np.asarray(a).size])
        at += np.asarray(a).size
    views[3] = views[3].view(memb.shape)
    return TurboConsts(m, memb.shape[0], B, len(counts), len(pj),
                       int(np.max(klen)), *views,
                       host={k: np.asarray(v, np.int64)
                             for k, v in (("klen", klen), ("pj", pj),
                                          ("pu", pu))})


def k7_hist_ints(L: int, klen: int, nz: int) -> int:
    """Ints of one K7 warp's histogram slice: (Lr + 1)^2 L^klen, the
    histogram, its margins and strata (Lr = L - 1 under nz-uniform)."""
    Lr = L - 1 if nz == 2 else L
    return (Lr + 1) ** 2 * L ** klen


@dataclass
class K7Plan:
    """K7's passes over one template at L levels in nz mode
    (:func:`k7_plan`): ``colo`` (U + 1,) the first column of each subset's
    strata in B (the subsets' S_u = L^klen columns end to end), ``passes``
    (npass, 4) [j0, j1, u0, u1], the candidates and subsets a pass
    finishes, and its pairs ``ppairs[poffs[i]:poffs[i + 1]]`` (indices
    into pj / pu); ``mtw`` the M-tiles of A a pass at most (K7's template
    argument), ``warps`` a block, ``cg_ints`` the largest pass slab and
    ``zrows`` the most subsets a pass; ``tensor`` colo, passes, poffs and
    ppairs as one int32 tensor on the device, once uploaded."""
    Lr: int
    colo: object
    passes: object
    poffs: object
    ppairs: object
    mtw: int
    warps: int
    cg_ints: int
    zrows: int
    tensor: torch.Tensor = None

    def rows(self, j0, j1):
        """[R0, R1): the A rows (whole 16-row M-tiles) of candidates
        [j0, j1)."""
        LL = self.Lr * self.Lr
        return j0 * LL // 16 * 16, -(-j1 * LL // 16) * 16

    def cols(self, u0, u1):
        """[C0, C1): the B columns (whole 8-column N-tiles) of subsets
        [u0, u1)."""
        return int(self.colo[u0]) // 8 * 8, -(-int(self.colo[u1]) // 8) * 8


def k7_slab_stride(ntp: int) -> int:
    """Ints a row of a pass's slab of ntp N-tiles: 8 ntp rounded up to 32,
    plus 8 (a half-warp's two-int stores hit distinct banks)."""
    return -(-8 * ntp // 32) * 32 + 8


def k7_plan(m: int, L: int, nz: int, klen, pj, pu) -> K7Plan:
    """K7's passes (csrc/mi_turbo_digest.cu) over the product of a window's
    A (m Lr^2 cell rows) and B (sum_u L^klen[u] stratum columns): candidate
    ranges whose rows fill at most ``mtw`` = min(ceil(m Lr^2 / 16),
    K7_MAX_MTW) M-tiles, times subset ranges of at most ``K7_ZROWS``
    subsets whose columns fill at most K7_WARPS * (K7_ACC_TILES / mtw)
    N-tiles, each taken greedily in order; each distinct pair (pj, pu) is
    listed in the pass of its candidate and subset.  A block has K7_WARPS
    warps, or one a N-tile where no pass has that many.  Raises where K7
    does not take the shapes: Lr > K7_MAX_LR or a stratum code past
    127."""
    import numpy as np

    Lr = L - 1 if nz == 2 else L
    LL = Lr * Lr
    klen = np.asarray(klen, np.int64)
    S = L ** klen
    if Lr > K7_MAX_LR or S.max() > 128:
        raise ValueError(f"K7: L={L}, nz={nz}, klen up to {klen.max()} "
                         f"(Lr <= {K7_MAX_LR} and L^klen <= 128)")
    colo = np.concatenate([[0], np.cumsum(S)]).astype(np.int64)
    U = len(klen)
    mtw = min(-(-m * LL // 16), K7_MAX_MTW)
    cap = K7_WARPS * (K7_ACC_TILES // mtw)
    jr, j0 = [], 0
    while j0 < m:
        j1 = j0 + 1
        while j1 < m and -(-(j1 + 1) * LL // 16) - j0 * LL // 16 <= mtw:
            j1 += 1
        jr.append((j0, j1))
        j0 = j1
    ur, u0 = [], 0
    while u0 < U:
        u1 = u0 + 1
        while (u1 < U and u1 + 1 - u0 <= K7_ZROWS
               and -(-int(colo[u1 + 1]) // 8) - int(colo[u0]) // 8 <= cap):
            u1 += 1
        ur.append((u0, u1))
        u0 = u1
    passes = np.array([(a, b, c, d) for a, b in jr for c, d in ur], np.int64)
    pj, pu = np.asarray(pj, np.int64), np.asarray(pu, np.int64)
    jpass = np.searchsorted([b for _, b in jr], pj, side="right")
    upass = np.searchsorted([d for _, d in ur], pu, side="right")
    which = jpass * len(ur) + upass
    ppairs = np.argsort(which, kind="stable")
    poffs = np.searchsorted(which[ppairs], np.arange(len(passes) + 1))
    plan = K7Plan(Lr, colo, passes, poffs, ppairs, mtw, 0, 0, 0)
    ntps = [(plan.cols(c, d)[1] - plan.cols(c, d)[0]) // 8 for c, d in ur]
    plan.warps = min(K7_WARPS, max(ntps))
    plan.cg_ints = max((plan.rows(a, b)[1] - plan.rows(a, b)[0])
                       * k7_slab_stride(t) for a, b in jr for t in ntps)
    plan.zrows = max(d - c for c, d in ur)
    return plan


def k7_device_plan(consts: TurboConsts, L: int, nz: int, device) -> K7Plan:
    """:func:`k7_plan` of the template ``consts`` with its tensor on
    ``device``, made and uploaded once for each (L, nz)."""
    import numpy as np

    plan = consts.plans.get((L, nz))
    if plan is None:
        h = consts.host
        plan = k7_plan(consts.m, L, nz, h["klen"], h["pj"], h["pu"])
        plan.tensor = torch.from_numpy(np.concatenate(
            [plan.colo, plan.passes.reshape(-1), plan.poffs,
             plan.ppairs]).astype(np.int32)).to(device)
        consts.plans[(L, nz)] = plan
    return plan


def k7_smem_bytes(NP: int, warps: int, hist_ints: int, m: int, mtw: int,
                  cg_ints: int, zrows: int) -> int:
    """Shared memory of a K7 block (``csrc/mi_turbo_digest.cu``'s layout):
    the pairs' float64 stat and n_obs, int32 df and byte suff; ``warps``
    histogram slices of ``hist_ints`` ints; each warp's B columns (8 bytes
    for each of the 8 columns of its K7_ACC_TILES // mtw N-tiles); the
    pass's subsets' descriptors (K7_ZDESC_INTS ints each, ``zrows`` of
    them); the m + 1 columns' references and flags; then the larger of a
    pass's streams (the ring of K7_STAGES chunks of m + 1 columns, and two
    buffers each of 16 mtw rows of A and of ``zrows`` subsets' codes and a
    zero row, K7_WINDOW bytes a row) and the slab of ``cg_ints`` ints that
    aliases them."""
    def a16(x):
        return -(-x // 16) * 16

    hist = a16(21 * NP)
    lanes = a16(hist + 4 * warps * hist_ints)
    cols = (lanes + warps * (K7_ACC_TILES // mtw) * 64
            + 4 * K7_ZDESC_INTS * zrows)
    ring = a16(cols + 5 * (m + 1))
    streams = (K7_STAGES * (m + 1) + 2 * 16 * mtw + 2 * (zrows + 1)) \
        * K7_WINDOW
    return ring + max(4 * cg_ints, streams)


def mi_turbo_digest_ref(st, Ts, C, consts, hps, max_k, nz, log_alpha, max_df,
                        return_pairs=False):
    """Plain PyTorch version of K7: every (candidate, subset) pair's
    (stat, df, n_obs, suff) from ``condtests._turbo_pair_stats`` in chunks
    of windows whose stratum planes stay within
    ``condtests.TURBO_PLANE_BYTES``, each template test's pair gathered,
    then ``condtests._mi_digest`` over the (window, slot) segments of all W
    windows.  Arguments and results as :func:`mi_turbo_digest`."""
    from . import condtests as ct

    n, L = st.data.shape[0], st.L
    S = L ** max_k
    W = Ts.shape[0]
    Wc = max(1, ct.TURBO_PLANE_BYTES // (4 * n * consts.U * S))
    memb, klen = consts.memb.long(), consts.klen.long()
    parts = [ct._turbo_pair_stats(
        st.data, st.levels, st.max_vals, Ts[s:s + Wc], C[s:s + Wc], memb,
        klen, float(hps), L, S, nz != 0, nz == 2) for s in range(0, W, Wc)]
    P = tuple(torch.cat(t) for t in zip(*parts))
    tp = consts.test_pairs()
    out = ct._mi_digest(*(t[:, tp].reshape(-1) for t in P),
                        consts.counts.long().repeat(W), W * consts.B,
                        log_alpha, max_df).reshape(3, W, consts.NC)
    if not return_pairs:
        return out
    pid = consts.pj.long() * consts.U + consts.pu.long()
    return out, tuple(t[:, pid] for t in P)


def mi_turbo_digest(st, Ts, C, consts, hps, max_k, nz, log_alpha, max_df,
                    return_pairs=False):
    """The turbo window digest of W full-target windows: for each window
    (target Ts[w], candidates C[w]) every distinct (candidate, subset) pair
    of the template ``consts`` (:class:`TurboConsts`) through the
    conditional G-test (signed MI, adjusted df, n_obs, power check over
    L^max_k strata), its log p, and each of the NC slots' digest as
    :func:`mi_window_digest` computes it over the slot's tests.

    Args:
      st: the table as a ``state.DiscreteState`` (K7 reads ``dataT``, the
        plain version ``data``).
      Ts: (W,) int64; C: (W, m) int64 variable indices.
      nz: 0 plain, 1 per-variable nz offsets, 2 nz-uniform.
    Returns (3, W, NC) float64 [exit_e, wstat, exp(M)]; with
    ``return_pairs`` also the distinct pairs' (stat float64, df int64, n_obs
    float64, suff bool), each (W, NP).  CUDA tensors run K7 (an int8 table,
    16-byte aligned, strata not compacted, n < 2^24, the shapes
    :func:`k7_plan` takes), one launch; CPU tensors run the plain
    version."""
    dataT = st.dataT
    dev = dataT.device
    if dev.type == "cpu":
        return mi_turbo_digest_ref(st, Ts, C, consts, hps, max_k, nz,
                                   log_alpha, max_df, return_pairs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    p, n = dataT.shape
    L, W, m = st.L, Ts.shape[0], consts.m
    if dataT.dtype != torch.int8 or not dataT.is_contiguous() or n == 0:
        raise ValueError("K7 needs dataT as a contiguous int8 (p, n) tensor")
    _check_pipe_table("K7", dataT)     # counts exact below 2^24 samples
    if nz not in (0, 1, 2) or (nz == 2 and L != 3):
        raise ValueError(f"invalid nz={nz} for L={L}")
    if consts.memb.shape[1] != max_k or max_df < 0 or W == 0:
        raise ValueError("K7: the template, max_k, max_df or W")
    _check_tensor("Ts", Ts, torch.int64, (W,), dev)
    _check_tensor("C", C, torch.int64, (W, m), dev)
    for name in ("levels", "max_vals"):
        _check_tensor(name, getattr(st, name), torch.int32, (p,), dev)
    if consts.pj.device != dev:
        raise ValueError(f"K7: the template is not on {dev}")
    plan = k7_device_plan(consts, L, nz, dev)
    hist = k7_hist_ints(L, consts.max_klen, nz)
    if k7_smem_bytes(consts.NP, plan.warps, hist, m, plan.mtw, plan.cg_ints,
                     plan.zrows) > SMEM_BLOCK_BYTES:
        raise ValueError(f"K7: a window of m={m} exceeds a block's shared "
                         "memory")
    NC, NP = consts.NC, consts.NP
    out = torch.empty((3, W, NC), dtype=torch.float64, device=dev)
    pairs = (tuple(torch.empty((W, NP), dtype=dt, device=dev)
                   for dt in (torch.float64, torch.int64, torch.float64,
                              torch.bool))
             if return_pairs else (None,) * 4)
    lg = _lgamma_table(max_df, dev)
    lib, _ = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fw_mi_turbo_digest(
            dataT.data_ptr(), n, p, st.levels.data_ptr(),
            st.max_vals.data_ptr(), Ts.data_ptr(), C.data_ptr(), W, m, L,
            int(nz),
            *(t.data_ptr() for t in (consts.pj, consts.pu, consts.tpair,
                                     consts.memb, consts.klen, consts.counts,
                                     consts.offs, plan.tensor)),
            consts.U, len(plan.passes), plan.mtw, plan.warps, plan.cg_ints,
            plan.zrows, NP, NC, max_k, hist, float(hps), float(log_alpha),
            int(max_df), lg.data_ptr(), out.data_ptr(),
            *(None if t is None else t.data_ptr() for t in pairs), stream)
    _check_cuda_error(lib, err, "mi_turbo_digest launch")
    mi_turbo_digest.launches += 1
    return (out, pairs) if return_pairs else out


mi_turbo_digest.launches = 0

# ---------------------------------------------------------------------------
# K8: the univariate extraction sweep
# ---------------------------------------------------------------------------

class ExtractBuffers:
    """What one sweep of the univariate extraction accumulates on a device,
    block by block (:func:`univar_extract`): ``tally`` (K8_TALLY,) int64,
    [candidates so far, unreliable pairs, the candidates below each edge],
    K8's two tile counters ``sched``, and each candidate's (X int32, Y
    int32, log p float64, stat float64) in ``cap`` slots (the candidates
    past ``cap`` are counted, not kept).
    ``edges`` (numpy, K8_EDGES strictly decreasing log p-values, or None:
    no edge counts) and the lgamma offsets of ``max_df`` go up here, once a
    sweep, so no block of the sweep copies from the host."""

    def __init__(self, cap: int, device, edges=None, max_df: int = 0):
        dev = torch.device(device)
        self.cap = int(cap)
        self.X = torch.empty(self.cap, dtype=torch.int32, device=dev)
        self.Y = torch.empty(self.cap, dtype=torch.int32, device=dev)
        self.logp = torch.empty(self.cap, dtype=torch.float64, device=dev)
        self.stat = torch.empty(self.cap, dtype=torch.float64, device=dev)
        self.tally = torch.zeros(K8_TALLY, dtype=torch.int64, device=dev)
        # K8's tile counters (tiles asked for, blocks done): 0 between
        # launches
        self.sched = torch.zeros(2, dtype=torch.int32, device=dev)
        self.edges = None
        if edges is not None:
            e = np.asarray(edges, dtype=np.float64)
            if e.shape != (K8_EDGES,) or not (np.diff(e) < 0).all():
                raise ValueError(f"K8 needs {K8_EDGES} strictly decreasing "
                                 "edges")
            self.edges = torch.from_numpy(e).to(dev)
        self.max_df = int(max_df)
        self.lg = _lgamma_table(self.max_df, dev)
        self.kept = 0           # the plain version's cursor, on the host

    @property
    def device(self) -> torch.device:
        return self.tally.device

    def candidates(self, kept: int):
        """The first ``kept`` candidates: (X, Y, log p, stat)."""
        return [c[:kept] for c in (self.X, self.Y, self.logp, self.stat)]


def univar_extract_ref(buf, front, outs, s, y0, thresh, reliable,
                       max_df=0):
    """Plain PyTorch version of K8: ``univariate._pair_scores`` on the
    block, ``torch.nonzero`` of its candidates (in row-major order, at the
    cursor) and their counts below each edge.  Arguments as
    :func:`univar_extract`."""
    from .univariate import _pair_scores

    logp, stat, n_unrel = _pair_scores(front, outs, s, y0, reliable, max_df)
    idx = torch.nonzero(logp.view(-1) < thresh).squeeze(1)
    lp = logp.view(-1)[idx]
    q = logp.shape[1]
    at, n = buf.kept, idx.numel()
    keep = max(0, min(n, buf.cap - at))
    if keep:
        i = idx[:keep]
        buf.X[at:at + keep] = ((i // q) + s).to(torch.int32)
        buf.Y[at:at + keep] = ((i % q) + y0).to(torch.int32)
        buf.logp[at:at + keep] = lp[:keep]
        buf.stat[at:at + keep] = stat.reshape(-1)[i]
    buf.kept += n
    buf.tally[0] += n
    buf.tally[1] += n_unrel
    if buf.edges is not None:
        buf.tally[2:] += (lp[:, None] < buf.edges[None, :]).sum(dim=0)


def _check_extract_args(buf, front, outs, max_df):
    dev = outs[0].device
    if buf.device != dev:
        raise ValueError(f"the sweep's buffers are on {buf.device}, the "
                         f"block on {dev}")
    t, q = outs[0].shape
    if front == "mi":
        names = (("stat", torch.float64), ("df", torch.int32),
                 ("n_obs", torch.int32), ("suff", torch.bool))
        if max_df != buf.max_df:
            raise ValueError(f"K8: max_df={max_df}, the sweep's lgamma "
                             f"offsets are for {buf.max_df}")
    elif front == "given":
        names = (("logp", torch.float64), ("stat", torch.float64),
                 ("suff", torch.bool))
    else:
        raise ValueError(f"K8 has no front {front!r}")
    if len(outs) != len(names):
        raise ValueError(f"K8's {front} front takes {len(names)} tensors")
    for (name, dt), x in zip(names, outs):
        shape = (t, q)
        if name == "suff" and front == "given" and x.dim() == 0:
            shape = ()
        _check_tensor(name, x, dt, shape, dev)
    if t >= 1 << 31 or q >= 1 << 31:
        raise ValueError("K8 takes fewer than 2^31 rows and columns")


def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def k8_blocks_per_sm(index: int) -> int:
    """The blocks of K8 that one SM of CUDA device ``index`` holds at
    once (the occupancy of its registers and shared memory)."""
    lib, _ = load_library()
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.fw_univar_extract_blocks_per_sm(ctypes.byref(n))
    _check_cuda_error(lib, err, "K8's occupancy")
    if n.value < 1:
        raise RuntimeError("K8 fits no SM of this card")
    return n.value


_K8_GRID: dict = {}


def k8_grid(device) -> int:
    """K8's grid on a CUDA device: its SMs times the blocks of K8 an SM
    holds at once, asked once a device and kept."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _K8_GRID:
        _K8_GRID[index] = _sm_count(index) * k8_blocks_per_sm(index)
    return _K8_GRID[index]


def univar_extract(buf, front, outs, s, y0, thresh, reliable, max_df=0):
    """One (t, q) block of a sweep of the univariate extraction,
    accumulated into ``buf`` (:class:`ExtractBuffers`): X = s + row,
    Y = y0 + column; a pair where X < Y; unreliable where its power check
    failed or its log p is NaN, and then log p +inf (``reliable``) or 0; a
    candidate where log p < ``thresh``.  Adds the candidates, the
    unreliable pairs and (where ``buf`` has edges) the candidates below
    each edge to ``buf.tally`` and stores each candidate at its slot below
    ``buf.cap``.

    front "mi": ``outs`` = (stat float64, df int32, n_obs int32, suff bool)
    of K1 / K4, log p ``statfuns.mi_logpval_smalldf`` at ``max_df`` (the
    buffers' lgamma offsets); "given": (log p float64, stat float64, suff
    bool, (t, q) or 0-dim).  CUDA tensors run K8 (its candidates in no
    fixed order; nothing synchronises with the host); CPU tensors run the
    plain version (in row-major order)."""
    dev = outs[0].device
    if dev.type == "cpu":
        return univar_extract_ref(buf, front, outs, s, y0, thresh, reliable,
                                  max_df)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_extract_args(buf, front, outs, max_df)
    t, q = outs[0].shape
    if t == 0 or q == 0:
        return None
    if front == "mi":
        stat, df, nobs, suff = outs
        logp = None
    else:
        logp, stat, suff = outs
        df = nobs = None
    lib, _ = load_library()
    grid = k8_grid(dev)
    ptr = (lambda x: None if x is None else x.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fw_univar_extract(
            0 if front == "mi" else 1, stat.data_ptr(), ptr(logp), ptr(df),
            ptr(nobs), suff.data_ptr(), int(suff.dim() == 0), t, q, int(s),
            int(y0), float(thresh), int(bool(reliable)), int(max_df),
            buf.lg.data_ptr(), ptr(buf.edges), buf.cap, buf.tally.data_ptr(),
            buf.sched.data_ptr(), buf.X.data_ptr(), buf.Y.data_ptr(),
            buf.logp.data_ptr(), buf.stat.data_ptr(), grid, stream)
    _check_cuda_error(lib, err, "univar_extract launch")
    univar_extract.launches += 1
    return None


univar_extract.launches = 0

_WRAPPERS = (mi_univar_stats, fz_nz_stats, pair_ctab_planes,
             mi_univar_stats_planes, mi_cond_stats, mi_window_digest,
             mi_turbo_digest, univar_extract)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
