"""Copy of ``flashweave_tpu/native/__init__.py`` for the PyTorch port.

The JAX package's native table parser, copied so that the port imports
nothing of ``flashweave_tpu``.  The one difference: the compiled library
goes into ``flashweave_tpu_torch/_build/`` (git-ignored), not beside its
source.
Nothing else differs; ``tests/test_torch_host_copies.py`` checks that.

Native (C++) ingestion runtime, loaded via ctypes.

Compiles ``fast_dlm.cpp`` on first use with g++ (cached next to the source,
keyed by a source hash) and exposes the fast delimited-table parser.  Every
entry point returns ``None`` on any failure -- missing compiler, compile
error, structural surprise in the file, non-numeric cell -- and the caller
(:mod:`flashweave_tpu.io`) falls back to the exact pure-Python path, so
results never diverge.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fast_dlm.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_lock = threading.Lock()
_lib_cache: dict = {}


def _build() -> Optional[ctypes.CDLL]:
    try:
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        so_path = os.path.join(_BUILD, f"_fast_dlm_{tag}.so")
        if not os.path.exists(so_path):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = so_path + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-std=c++17", "-O3", "-shared", "-fPIC", "-pthread",
                 _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        lib.fw_scan_table.restype = ctypes.c_long
        lib.fw_scan_table.argtypes = [
            ctypes.c_char_p, ctypes.c_char,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.fw_first_fields.restype = ctypes.c_long
        lib.fw_first_fields.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_char_p,
            ctypes.c_long, ctypes.c_long,
        ]
        lib.fw_parse_numeric.restype = ctypes.c_long
        lib.fw_parse_numeric.argtypes = [
            ctypes.c_char_p, ctypes.c_char,
            ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ]
        return lib
    except Exception:
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    with _lock:
        if "lib" not in _lib_cache:
            _lib_cache["lib"] = _build()
        return _lib_cache["lib"]


def scan_table(path: str, sep: str) -> Optional[Tuple[int, int, int]]:
    """(n non-blank lines, n fields of line 1, n fields of line 2)."""
    lib = get_lib()
    if lib is None:
        return None
    n_lines = ctypes.c_long()
    c1 = ctypes.c_long()
    c2 = ctypes.c_long()
    rc = lib.fw_scan_table(path.encode(), sep.encode(),
                           ctypes.byref(n_lines), ctypes.byref(c1),
                           ctypes.byref(c2))
    if rc != 0:
        return None
    return n_lines.value, c1.value, c2.value


def first_fields(path: str, sep: str, n_rows: int,
                 width: int = 256) -> Optional[np.ndarray]:
    """First field of each data line (candidate row-id column), as a
    fixed-width bytes array."""
    lib = get_lib()
    if lib is None or n_rows <= 0:
        return None
    buf = np.zeros(n_rows, dtype=f"S{width}")
    rc = lib.fw_first_fields(
        path.encode(), sep.encode(),
        buf.ctypes.data_as(ctypes.c_char_p), width, n_rows,
    )
    if rc != 0:
        return None
    return buf


def parse_numeric(path: str, sep: str, skip_rows: int, skip_cols: int,
                  n_rows: int, n_cols: int,
                  n_threads: int = 0) -> Optional[np.ndarray]:
    """Parse the numeric block into a float64 (n_rows, n_cols) array, or
    None if anything (including a single cell) fails to parse."""
    lib = get_lib()
    if lib is None or n_rows <= 0 or n_cols <= 0:
        return None
    out = np.empty((n_rows, n_cols), dtype=np.float64)
    rc = lib.fw_parse_numeric(
        path.encode(), sep.encode(), skip_rows, skip_cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_rows, n_cols, n_threads,
    )
    if rc != 0:
        return None
    return out
