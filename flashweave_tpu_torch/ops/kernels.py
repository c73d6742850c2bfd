"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

- K1, the fused univariate G-test (``csrc/mi_univar_stats.cu``), replaces
  the TPU kernel ``flashweave_tpu/ops/pallas_kernels.py:mi_univar_stats_pallas``.
  :func:`mi_univar_stats` is its wrapper, :func:`mi_univar_stats_ref` its
  plain PyTorch version (pair tables, then ``mi_block_stats``).
- K2, the fz_nz masked correlation (``csrc/fz_nz_stats.cu``), replaces
  ``pallas_kernels.py:fz_nz_moments`` (through ``fz_nz_block_pallas``).
  :func:`fz_nz_stats` is its wrapper, :func:`fz_nz_stats_ref` its plain
  PyTorch version (``univariate.fz_nz_block``).
- On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
  tensor it runs the plain version.  Each counts its launches in
  ``<wrapper>.launches``; :func:`launch_counts` reports them all.
- The kernels build at first use with ``nvcc`` from ``csrc/*.cu`` into
  ``flashweave_tpu_torch/_build/`` as one shared library with a plain C
  interface, named after a hash of the sources and flags, and load through
  ``ctypes``.  Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from .contingency import pair_ctab_block

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# L supported by K1 (its template instantiations)
K1_LEVELS = range(2, 9)


@dataclass
class BuildInfo:
    path: Path
    seconds: float      # 0.0 when an existing library was reused
    log: str            # nvcc's output (ptxas register / spill report)


_loaded: dict = {}      # process-wide: library path -> (CDLL, BuildInfo)


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
    rename the library into place."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libfw_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
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
    os.replace(tmp, out)
    return BuildInfo(out, time.perf_counter() - t0, log)


def load_library():
    """(CDLL, BuildInfo) of the kernel library, building it if needed."""
    info = build_library()
    key = str(info.path)
    if key not in _loaded:
        lib = ctypes.CDLL(key)
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
        lib.fw_cuda_error_string.argtypes = [i32]
        lib.fw_cuda_error_string.restype = ctypes.c_char_p
        _loaded[key] = (lib, info)
    return _loaded[key]


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
    (tile, y_len).  CUDA tensors run K1; CPU tensors run the plain version.
    """
    p, n = dataT.shape
    if y_len is None:
        y_len = p
    if dataT.device.type == "cpu":
        return mi_univar_stats_ref(dataT, marg, levels, max_vals, start, tile,
                                   L, y_start, y_len, nz, hps, n_obs_min)
    if dataT.device.type != "cuda":
        raise ValueError(f"unsupported device {dataT.device}")
    if dataT.dtype != torch.int8 or not dataT.is_contiguous():
        raise ValueError("K1 needs dataT as a contiguous int8 (p, n) tensor")
    if L not in K1_LEVELS:
        raise ValueError(f"K1 supports L in 2..8, got L={L}")
    if nz not in (0, 1, 2) or (nz == 2 and L != 3):
        raise ValueError(f"invalid nz={nz} for L={L}")
    for name, t, shape in (("marg", marg, (L, p)), ("levels", levels, (p,)),
                           ("max_vals", max_vals, (p,))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dataT.device):
            raise ValueError(
                f"{name} must be a contiguous int32 {shape} tensor on "
                f"{dataT.device}")
    if not (0 <= start and start + tile <= p and 0 <= y_start
            and y_start + y_len <= p):
        raise ValueError("X-block or Y-slab out of range")
    if tile == 0 or y_len == 0 or n == 0:
        raise ValueError("empty X-block, Y-slab or table")
    dev = dataT.device
    stat = torch.empty((tile, y_len), dtype=torch.float64, device=dev)
    df = torch.empty((tile, y_len), dtype=torch.int32, device=dev)
    nobs = torch.empty((tile, y_len), dtype=torch.int32, device=dev)
    suff = torch.empty((tile, y_len), dtype=torch.bool, device=dev)
    lib, _ = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
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

_WRAPPERS = (mi_univar_stats, fz_nz_stats)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}
