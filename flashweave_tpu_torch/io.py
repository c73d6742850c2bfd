"""Copy of ``flashweave_tpu/io.py`` for the PyTorch port.

The JAX package's data and network I/O, copied so that the port imports
nothing of ``flashweave_tpu``.  The native table parser it uses is the
port's own copy (``flashweave_tpu_torch/native``).
Nothing else differs; ``tests/test_torch_host_copies.py`` checks that.

Data and network I/O.

Format-compatible re-implementation of the reference's I/O layer (reference:
src/io.jl): delimited OTU tables (TSV/CSV with header/row-id sniffing and
transposition), BIOM 1.0 JSON and BIOM 2.x HDF5, and network serialization as
edgelists (with `# header` / `# meta mask` comment lines) and GML, plus the
detailed `_rejections.tsv` / `_unchecked.tsv` outputs.  The reference's
binary format (JLD2, deprecated, src/io.jl:48) is Julia-specific; its role --
lossless round-trip of networks *including* inference parameters, rejections
and unfinished states (src/io.jl:97: "parameters ... are only available when
loading from JLD2"), and key-addressed binary data tables
(src/io.jl:119-148) -- is filled by NumPy `.npz` archives with the same
default keys ('otu_data', 'otu_header', 'meta_data', 'meta_header').
Existing JLD2 *data* files additionally load directly (read-only interop:
:func:`load_jld2_data` decodes the dense/string/SparseMatrixCSC layouts the
reference fixtures use via h5py -- JLD2 is valid HDF5).

All of this is host-side Python; indices written to disk are 1-based for
interoperability with reference outputs (internal node ids are 0-based).
"""

from __future__ import annotations

import json
import os
import warnings
from typing import List, Optional, Tuple

import numpy as np

from .types import FWResult, Graph, HitonState, LGLResult, TestResult

VALID_NET_FORMATS = (".edgelist", ".gml", ".npz")
VALID_DATA_FORMATS = (".tsv", ".csv", ".biom", ".npz", ".jld2")
VALID_DLM_FORMATS = (".tsv", ".csv")


def _ext(path: str) -> str:
    return os.path.splitext(path)[1]


# ---------------------------------------------------------------------------
# data loading (reference: src/io.jl:29-246)
# ---------------------------------------------------------------------------

def _parse_cell(c: str):
    try:
        return float(c)
    except ValueError:
        return c


def _is_number(x) -> bool:
    return isinstance(x, (int, float, np.integer, np.floating))


def _load_dlm_fast(data_path: str, sep: str):
    """Native fast path for untransposed numeric tables: mmap + threaded
    C++ cell parsing (native/fast_dlm.cpp).  Mirrors the slow path's header
    and row-id sniffing exactly; returns None on ANY surprise (ragged rows,
    non-numeric cell, missing compiler) so the caller falls back and results
    never diverge."""
    try:
        from . import native
    except Exception:
        return None
    dims = native.scan_table(data_path, sep)
    if dims is None:
        return None
    n_lines, c1, c2 = dims
    if n_lines < 2 or c1 != c2 or c1 < 2:
        return None
    n_rows = n_lines - 1

    with open(data_path) as f:
        for line in f:
            if line.strip():
                header_raw = line.rstrip("\n").rstrip("\r").split(sep)
                break
    header_cells = [_parse_cell(c) for c in header_raw]

    # row-id detection, mirroring the slow path (reference: src/io.jl:151-152)
    has_ids = header_cells[0] == ""
    if not has_ids:
        ids = native.first_fields(data_path, sep, n_rows)
        if ids is None:
            return None
        # short-circuit: a numeric first data cell can never be a row id
        # (isinstance(first_col[0], str) in the slow path)
        if isinstance(_parse_cell(ids[0].decode(errors="replace")), str):
            first_col = [_parse_cell(b.decode(errors="replace")) for b in ids]
            has_ids = len(set(map(str, first_col))) == len(first_col)

    skip_cols = 1 if has_ids else 0
    n_cols = c1 - skip_cols
    data = native.parse_numeric(data_path, sep, 1, skip_cols, n_rows, n_cols)
    if data is None:
        return None
    header = [str(h) for h in header_cells[skip_cols:]]
    if header and all(h.endswith(".0") for h in header):
        header = [h[:-2] for h in header]
    return data, header


def load_dlm(data_path: str, meta_path: Optional[str] = None,
             transposed: bool = False, type_data: bool = True):
    """Delimited loader with row-id sniffing (reference: src/io.jl:155-191).
    Numeric untransposed tables go through the native C++ parser
    (native/fast_dlm.cpp); everything else uses the pure-Python path."""
    sep = "\t" if _ext(data_path) == ".tsv" else ","
    if type_data and not transposed:
        fast = _load_dlm_fast(data_path, sep)
        if fast is not None:
            data, header = fast
            if meta_path is not None:
                meta_data, meta_header, _, _ = load_dlm(
                    meta_path, transposed=transposed, type_data=False)
            else:
                meta_data = meta_header = None
            return data, header, meta_data, meta_header
    with open(data_path) as f:
        rows = [line.rstrip("\n").rstrip("\r").split(sep) for line in f if line.strip()]
    cells = [[_parse_cell(c) for c in r] for r in rows]
    if transposed:
        cells = [list(r) for r in zip(*cells)]

    header_raw = cells[0]
    data_raw = cells[1:]

    # row-id detection (reference: src/io.jl:151-152)
    first_col = [r[0] for r in data_raw]
    has_ids = header_raw[0] == "" or (
        len(set(map(str, first_col))) == len(first_col)
        and isinstance(first_col[0], str)
    )
    if has_ids:
        data_raw = [r[1:] for r in data_raw]
        header_raw = header_raw[1:]

    header = [str(h) for h in header_raw]
    # numeric IDs loaded as floats read back as "123.0" (reference src/io.jl:177-180)
    if header and all(h.endswith(".0") for h in header):
        header = [h[:-2] for h in header]

    if type_data:
        data = np.array(data_raw, dtype=np.float64)
    else:
        data = np.empty((len(data_raw), len(data_raw[0]) if data_raw else 0),
                        dtype=object)
        for i, r in enumerate(data_raw):
            data[i, :] = r

    if meta_path is not None:
        meta_data, meta_header, _, _ = load_dlm(meta_path, transposed=transposed,
                                                type_data=False)
    else:
        meta_data = meta_header = None
    return data, header, meta_data, meta_header


def load_biom_json(data_path: str, make_sparse: bool = False):
    # reference: src/io.jl:194-205
    with open(data_path) as f:
        js = json.load(f)
    if js["matrix_type"] == "sparse":
        trip = np.array(js["data"])
        n_obs, n_samples = js["shape"]
        if make_sparse:
            from scipy.sparse import coo_matrix

            table = coo_matrix(
                (trip[:, 2], (trip[:, 1].astype(int), trip[:, 0].astype(int))),
                shape=(n_samples, n_obs), dtype=np.float64,
            ).tocsr()
        else:
            table = np.zeros((n_obs, n_samples))
            table[trip[:, 0].astype(int), trip[:, 1].astype(int)] = trip[:, 2]
            table = table.T
    else:
        table = np.array(js["data"], dtype=np.float64).T
        if make_sparse:
            from scipy.sparse import csr_matrix

            table = csr_matrix(table)
    header = [r["id"] for r in js["rows"]]
    return table, header


def load_biom_hdf5(data_path: str, make_sparse: bool = False):
    # reference: src/io.jl:208-225.  make_sparse keeps the on-disk CSC
    # structure as a scipy.sparse matrix (the reference is sparse-first); the
    # preprocessing layer streams it without a dense float64 copy.
    import h5py
    from scipy.sparse import csc_matrix

    with h5py.File(data_path, "r") as f:
        m, n = f.attrs["shape"]
        indptr = f["sample/matrix/indptr"][()]
        indices = f["sample/matrix/indices"][()]
        vals = f["sample/matrix/data"][()]
        header = [
            h.decode() if isinstance(h, bytes) else str(h)
            for h in f["observation/ids"][()]
        ]
    table = csc_matrix((vals, indices, indptr), shape=(m, n)).T
    if make_sparse:
        return table.tocsr().astype(np.float64), header
    return np.asarray(table.todense(), dtype=np.float64), header


def load_biom(data_path: str, meta_path: Optional[str] = None,
              make_sparse: bool = False):
    # reference: src/io.jl:228-246
    try:
        data, header = load_biom_hdf5(data_path, make_sparse=make_sparse)
    except Exception:
        try:
            data, header = load_biom_json(data_path, make_sparse=make_sparse)
        except Exception as e:
            raise ValueError(
                f"Error in 'load_biom'. File {data_path} seems not to be valid .biom"
            ) from e
    if meta_path is not None:
        meta_data, meta_header, _, _ = load_dlm(meta_path, type_data=False)
    else:
        meta_data = meta_header = None
    return data, header, meta_data, meta_header


def load_npz_data(data_path: str, otu_data_key: str = "otu_data",
                  otu_header_key: str = "otu_header",
                  meta_data_key: Optional[str] = "meta_data",
                  meta_header_key: Optional[str] = "meta_header",
                  transposed: bool = False):
    """Key-addressed binary table loader -- the npz equivalent of the
    reference's JLD2 data files (reference: src/io.jl:119-148; same default
    keys).  Keys set to None are skipped."""
    with np.load(data_path, allow_pickle=False) as f:
        for key, desc in ((otu_data_key, "otu data"), (otu_header_key, "otu ids")):
            if key is None:
                raise AssertionError(f"must provide a key for {desc}")
        data = np.asarray(f[otu_data_key], dtype=np.float64)
        header = [str(h) for h in f[otu_header_key]]
        meta_data = meta_header = None
        if meta_data_key is not None and meta_data_key in f.files:
            meta_data = f[meta_data_key]
            if meta_data.dtype.kind in "US":
                meta_data = meta_data.astype(object)
        if meta_header_key is not None and meta_header_key in f.files:
            meta_header = [str(h) for h in f[meta_header_key]]
    if transposed:
        data = data.T
        if meta_data is not None:
            meta_data = meta_data.T
    return data, header, meta_data, meta_header


def save_npz_data(data_path: str, data, header, meta_data=None,
                  meta_header=None) -> None:
    """Writer counterpart of :func:`load_npz_data` (same default keys)."""
    payload = dict(otu_data=np.asarray(data),
                   otu_header=np.asarray([str(h) for h in header]))
    if meta_data is not None:
        meta_data = np.asarray(meta_data)
        if meta_data.dtype == object:
            meta_data = meta_data.astype(str)
        payload["meta_data"] = meta_data
    if meta_header is not None:
        payload["meta_header"] = np.asarray([str(h) for h in meta_header])
    np.savez_compressed(data_path, **payload)


def _jld2_decode(f, obj, make_sparse: bool):
    """Decode one JLD2 dataset into a Python value.

    JLD2 files are valid HDF5; the subset the reference's data files use
    (reference: src/io.jl:119-148 reads them with FileIO/JLD2) maps cleanly:

    - dense numeric arrays: stored column-major by Julia, so the HDF5 dims
      are the REVERSE of the Julia logical shape -> transpose to recover it;
    - string vectors: variable-length strings (bytes under h5py) -> str;
    - SparseMatrixCSC: a scalar dataset of a compound type with fields
      (m, n, colptr, rowval, nzval) whose array fields are HDF5 object
      references; Julia indices are 1-based.
    """
    import h5py

    val = obj[()]
    dt = obj.dtype
    if dt.names and {"m", "n", "colptr", "rowval", "nzval"} <= set(dt.names):
        from scipy.sparse import csc_matrix

        rec = val if val.shape == () else val[()]
        deref = {
            k: (f[rec[k]][()] if isinstance(rec[k], h5py.h5r.Reference)
                else np.asarray(rec[k]))
            for k in ("colptr", "rowval", "nzval")
        }
        mat = csc_matrix(
            (deref["nzval"], deref["rowval"] - 1, deref["colptr"] - 1),
            shape=(int(rec["m"]), int(rec["n"])),
        )
        if make_sparse:
            return mat.tocsr().astype(np.float64)
        return mat.toarray().astype(np.float64)
    if dt.kind == "O":
        return [v.decode() if isinstance(v, bytes) else str(v)
                for v in np.asarray(val).ravel()]
    arr = np.asarray(val)
    return arr.T if arr.ndim == 2 else arr


def load_jld2_data(data_path: str, otu_data_key: str = "otu_data",
                   otu_header_key: str = "otu_header",
                   meta_data_key: Optional[str] = "meta_data",
                   meta_header_key: Optional[str] = "meta_header",
                   transposed: bool = False, make_sparse: bool = False):
    """Reader for the reference's (deprecated) JLD2 binary data tables
    (reference: src/io.jl:119-148; same default keys and missing-key
    errors).  Covers the dense, string-vector and SparseMatrixCSC layouts
    its fixtures use; network-result JLD2 files (serialized Julia structs,
    src/io.jl:107-111) are out of scope -- the npz format is this
    package's lossless network round-trip."""
    import h5py

    with h5py.File(data_path, "r") as f:
        for key, desc in ((otu_data_key, "otu_data_key"),
                          (otu_header_key, "otu_header_key")):
            if key is None or key not in f:
                raise KeyError(
                    f"key '{key}' not found in input file. Please provide "
                    f"the appropriate {desc}. Keys present: "
                    f"{', '.join(f.keys())}"
                )
        data = _jld2_decode(f, f[otu_data_key], make_sparse)
        header = [str(h) for h in _jld2_decode(f, f[otu_header_key], False)]
        meta_data = meta_header = None
        if meta_data_key is not None and meta_data_key in f:
            meta_data = _jld2_decode(f, f[meta_data_key], False)
        if meta_header_key is not None and meta_header_key in f:
            meta_header = [
                str(h) for h in _jld2_decode(f, f[meta_header_key], False)
            ]
    if transposed:
        data = data.T
        if meta_data is not None:
            meta_data = meta_data.T
    return data, header, meta_data, meta_header


def load_data(data_path: str, meta_data_path: Optional[str] = None,
              transposed: bool = False, otu_data_key: str = "otu_data",
              otu_header_key: str = "otu_header",
              meta_data_key: Optional[str] = "meta_data",
              meta_header_key: Optional[str] = "meta_header",
              make_sparse: bool = False, **kwargs):
    """Load an OTU table (+ optional meta table) from '.tsv', '.csv',
    '.biom' or key-addressed binary '.npz' (reference: src/io.jl:29-59).
    Returns (data, header, meta_data, meta_header).  ``make_sparse`` keeps
    '.biom' tables as scipy.sparse (the whole pipeline accepts them)."""
    ext = _ext(data_path)
    if transposed and ext == ".biom":
        warnings.warn("'transposed' cannot be used with .biom files")
    if meta_data_path is not None:
        if ext in (".npz", ".jld2"):
            raise ValueError(
                f"{ext[1:]} format not compatible with external meta data "
                "files, please add meta data directly to the file (default "
                "key: 'meta_data')"
            )
        mext = _ext(meta_data_path)
        if mext not in VALID_DLM_FORMATS:
            raise ValueError(
                f"{mext} is an invalid meta data format, please provide one "
                f"of {VALID_DLM_FORMATS}"
            )
    if ext in VALID_DLM_FORMATS:
        return load_dlm(data_path, meta_data_path, transposed=transposed)
    if ext == ".biom":
        return load_biom(data_path, meta_data_path, make_sparse=make_sparse)
    if ext == ".npz":
        return load_npz_data(
            data_path, otu_data_key=otu_data_key,
            otu_header_key=otu_header_key, meta_data_key=meta_data_key,
            meta_header_key=meta_header_key, transposed=transposed,
        )
    if ext == ".jld2":
        warnings.warn("jld2 support is deprecated (read-only interop with "
                      "reference data files); prefer npz")
        return load_jld2_data(
            data_path, otu_data_key=otu_data_key,
            otu_header_key=otu_header_key, meta_data_key=meta_data_key,
            meta_header_key=meta_header_key, transposed=transposed,
            make_sparse=make_sparse,
        )
    raise ValueError(
        f"{ext} not a valid input format. Choose one of {VALID_DATA_FORMATS}"
    )


# ---------------------------------------------------------------------------
# network serialization (reference: src/io.jl:338-482)
# ---------------------------------------------------------------------------

def write_edgelist(out_path: str, net_result: FWResult) -> None:
    # reference: src/io.jl:338-358
    G = net_result.graph
    header = net_result.variable_ids
    meta_mask = net_result.meta_variable_mask
    with open(out_path, "w") as f:
        f.write("# header\t" + ",".join(header) + "\n")
        f.write("# meta mask\t" + ",".join(
            "true" if m else "false" for m in meta_mask) + "\n")
        for u, v, w in G.edges():
            e1 = header[u] if header else str(u + 1)
            e2 = header[v] if header else str(v + 1)
            f.write(f"{e1}\t{e2}\t{w}\n")


def read_edgelist(in_path: str) -> FWResult:
    # reference: src/io.jl:361-389
    with open(in_path) as f:
        header_items = f.readline().rstrip("\n").split("\t")[-1]
        header = header_items.split(",")
        inv = {h: i for i, h in enumerate(header)}
        meta_items = f.readline().rstrip("\n").split("\t")[-1]
        meta_mask = np.array([x == "true" for x in meta_items.split(",")])
        G = Graph(len(header))
        for line in f:
            items = line.rstrip("\n").split("\t")
            if len(items) < 3:
                continue
            G.add_edge(inv[items[0]], inv[items[1]], float(items[-1]))
    return FWResult(LGLResult(G), variable_ids=header, meta_variable_mask=meta_mask)


def write_gml(out_path: str, net_result: FWResult) -> None:
    # reference: src/io.jl:392-421 (node ids are 1-based for interop)
    G = net_result.graph
    header = net_result.variable_ids
    meta_mask = net_result.meta_variable_mask
    with open(out_path, "w") as f:
        f.write("graph [\n")
        f.write("\tdirected 0\n")
        for node in range(G.n_nodes):
            f.write("\tnode [\n")
            f.write(f"\t\tid {node + 1}\n")
            f.write(f'\t\tlabel "{header[node]}"\n')
            f.write(f"\t\tmv {int(meta_mask[node])}\n")
            f.write("\t]\n")
        for u, v, w in G.edges():
            f.write("\tedge [\n")
            f.write(f"\t\tsource {u + 1}\n")
            f.write(f"\t\ttarget {v + 1}\n")
            f.write(f"\t\tweight {w}\n")
            f.write("\t]\n")
        f.write("]\n")


def read_gml(in_path: str) -> FWResult:
    # reference: src/io.jl:443-482
    node_dict = {}
    edges = []
    with open(in_path) as f:
        lines = [l.strip() for l in f]
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith("node") or line.startswith("edge"):
            fields = []
            while i < len(lines) and not lines[i].startswith("]"):
                fields.append(tuple(lines[i].split(None, 1)))
                i += 1
            kind = fields[0][0]
            if kind == "node":
                node_id = int(fields[1][1])
                node_dict[node_id] = fields
            else:
                src = int(fields[1][1])
                dst = int(fields[2][1])
                w = float(fields[3][1])
                edges.append((src, dst, w))
        i += 1
    n_nodes = max(node_dict.keys())
    header = [""] * n_nodes
    meta_mask = np.zeros(n_nodes, dtype=bool)
    for node_id, fields in node_dict.items():
        header[node_id - 1] = fields[2][1].strip('"')
        meta_mask[node_id - 1] = bool(int(fields[3][1]))
    G = Graph(n_nodes)
    for src, dst, w in edges:
        G.add_edge(src - 1, dst - 1, w)
    return FWResult(LGLResult(G), variable_ids=header, meta_variable_mask=meta_mask)


def save_rejections(rej_path: str, net_result: FWResult, digits: int = 5) -> None:
    # reference: src/io.jl:296-318 (8-column schema, 1-based indices)
    rej_dict = net_result.rejections
    with open(rej_path, "w") as f:
        if not rej_dict:
            f.write("# No rejections found, you may have forgotten to specify "
                    "'track_rejections' when running FlashWeave")
            return
        f.write("\t".join(["Edge", "Rejecting_set", "Stat", "P_value",
                           "Num_tests", "Perc_tested", "Df", "SuffPower"]) + "\n")
        for var_A, nbr_dict in rej_dict.items():
            for var_B, (rej_set, tres, (num_tests, frac)) in nbr_dict.items():
                items = [
                    f"{var_A + 1} <-> {var_B + 1}",
                    ",".join(str(z + 1) for z in rej_set),
                    str(round(tres.stat, digits)),
                    str(round(tres.pval, digits)),
                    str(num_tests),
                    str(round(frac, digits)),
                    str(tres.df),
                    "true" if tres.suff_power else "false",
                ]
                f.write("\t".join(items) + "\n")


def load_rejections(rej_path: str):
    # reference: src/io.jl:249-274
    rej_dict = {}
    with open(rej_path) as f:
        first = f.readline()
        if first.startswith("#"):
            return rej_dict
        for line in f:
            items = line.rstrip("\n").split("\t")
            var_A, var_B = (int(x) - 1 for x in items[0].split(" <-> "))
            Zs = tuple(int(z) - 1 for z in items[1].split(","))
            stat, pval = float(items[2]), float(items[3])
            n_tests = int(items[4])
            frac = float(items[5])
            df = int(items[6])
            suff = items[7] == "true"
            rej_dict.setdefault(var_A, {})[var_B] = (
                Zs, TestResult(stat, pval, df, suff), (n_tests, frac)
            )
    return rej_dict


def save_unfinished_variable_info(unf_path: str, net_result: FWResult) -> None:
    # reference: src/io.jl:321-335
    unf = net_result.unfinished_states
    with open(unf_path, "w") as f:
        if not unf:
            f.write("# No unchecked neighbors")
            return
        f.write("Variable\tPhase\tUnchecked_neighbors\n")
        for var_A, state in unf.items():
            f.write(
                f"{var_A + 1}\t{state.phase}\t"
                + ",".join(str(v + 1) for v in state.unchecked_vars) + "\n"
            )


def load_unfinished_variable_info(unf_path: str):
    # reference: src/io.jl:277-293
    unf = {}
    with open(unf_path) as f:
        first = f.readline()
        if first.startswith("#"):
            return unf
        for line in f:
            items = line.rstrip("\n").split("\t")
            var_A = int(items[0]) - 1
            phase = items[1][0]
            unf_vars = [int(v) - 1 for v in items[2].split(",")]
            unf[var_A] = dict(phase=phase, unchecked_vars=unf_vars)
    return unf


# --- binary network format (npz) -------------------------------------------
# Lossless counterpart of the reference's JLD2 network files: unlike the text
# formats, inference parameters, rejection records and unfinished/checkpointed
# search states survive the round-trip (reference src/io.jl:97).

def _tres_to_list(t: TestResult):
    return [float(t.stat), float(t.pval), int(t.df), bool(t.suff_power)]


def _tres_from_list(v) -> TestResult:
    return TestResult(float(v[0]), float(v[1]), int(v[2]), bool(v[3]))


def _rej1_to_json(nbrs):
    # single-level RejDict: nbr -> (Zs, TestResult, (num_tests, frac))
    return {
        str(B): [list(map(int, Zs)), _tres_to_list(t), [int(n), float(frac)]]
        for B, (Zs, t, (n, frac)) in nbrs.items()
    }


def _rej1_from_json(d):
    return {
        int(B): (tuple(v[0]), _tres_from_list(v[1]),
                 (int(v[2][0]), float(v[2][1])))
        for B, v in d.items()
    }


def _rej_to_json(rej_dict):
    return {str(A): _rej1_to_json(nbrs) for A, nbrs in rej_dict.items()}


def _rej_from_json(d):
    return {int(A): _rej1_from_json(nbrs) for A, nbrs in d.items()}


def _nbrstats_to_json(nbr_dict):
    return {str(k): [float(v[0]), float(v[1])] for k, v in nbr_dict.items()}


def _nbrstats_from_json(d):
    return {int(k): (float(v[0]), float(v[1])) for k, v in d.items()}


def _states_to_json(states):
    return {
        str(T): dict(
            phase=st.phase,
            state_results=_nbrstats_to_json(st.state_results),
            inter_results=_nbrstats_to_json(st.inter_results),
            unchecked_vars=[int(v) for v in st.unchecked_vars],
            state_rejections=_rej1_to_json(st.state_rejections),
        )
        for T, st in states.items()
    }


def _states_from_json(d):
    return {
        int(T): HitonState(
            phase=s["phase"],
            state_results=_nbrstats_from_json(s["state_results"]),
            inter_results=_nbrstats_from_json(s["inter_results"]),
            unchecked_vars=list(s["unchecked_vars"]),
            state_rejections=_rej1_from_json(s["state_rejections"]),
        )
        for T, s in d.items()
    }


def write_npz_network(out_path: str, net_result: FWResult) -> None:
    G = net_result.graph
    edges = list(G.edges())
    np.savez_compressed(
        out_path,
        n_nodes=np.int64(G.n_nodes),
        edges_u=np.array([u for u, _, _ in edges], dtype=np.int64),
        edges_v=np.array([v for _, v, _ in edges], dtype=np.int64),
        edges_w=np.array([w for _, _, w in edges], dtype=np.float64),
        header=np.asarray(net_result.variable_ids),
        meta_mask=np.asarray(net_result.meta_variable_mask, dtype=bool),
        parameters_json=json.dumps(net_result.parameters, default=str),
        rejections_json=json.dumps(_rej_to_json(net_result.rejections)),
        unfinished_json=json.dumps(_states_to_json(net_result.unfinished_states)),
    )


def read_npz_network(in_path: str) -> FWResult:
    with np.load(in_path, allow_pickle=False) as f:
        G = Graph(int(f["n_nodes"]))
        for u, v, w in zip(f["edges_u"], f["edges_v"], f["edges_w"]):
            G.add_edge(int(u), int(v), float(w))
        header = [str(h) for h in f["header"]]
        meta_mask = np.asarray(f["meta_mask"], dtype=bool)
        parameters = json.loads(str(f["parameters_json"]))
        rejections = _rej_from_json(json.loads(str(f["rejections_json"])))
        unfinished = _states_from_json(json.loads(str(f["unfinished_json"])))
    return FWResult(
        LGLResult(G, rejections, unfinished), variable_ids=header,
        meta_variable_mask=meta_mask, parameters=parameters,
    )


def save_network(net_path: str, net_result: FWResult, detailed: bool = False) -> None:
    """Save network results ('.edgelist', '.gml' or binary '.npz';
    reference: src/io.jl:73-91)."""
    ext = _ext(net_path)
    if ext == ".edgelist":
        write_edgelist(net_path, net_result)
    elif ext == ".gml":
        write_gml(net_path, net_result)
    elif ext == ".npz":
        write_npz_network(net_path, net_result)
    else:
        raise ValueError(
            f"{ext} not a valid output format. Choose one of {VALID_NET_FORMATS}"
        )
    if detailed:
        trunk = os.path.splitext(net_path)[0]
        save_rejections(trunk + "_rejections.tsv", net_result)
        save_unfinished_variable_info(trunk + "_unchecked.tsv", net_result)


def load_network(net_path: str) -> FWResult:
    """Load network results ('.edgelist', '.gml' or binary '.npz';
    reference: src/io.jl:101-112).  Inference parameters, rejections and
    unfinished states are only preserved by '.npz'."""
    ext = _ext(net_path)
    if ext == ".edgelist":
        return read_edgelist(net_path)
    if ext == ".gml":
        return read_gml(net_path)
    if ext == ".npz":
        return read_npz_network(net_path)
    raise ValueError(
        f"{ext} not a valid network format. Valid formats are {VALID_NET_FORMATS}"
    )
