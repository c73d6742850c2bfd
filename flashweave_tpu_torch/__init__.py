"""FlashWeave on PyTorch and CUDA: microbial association-network inference.

The PyTorch port of ``flashweave_tpu`` (reference layout: src/FlashWeave.jl
exports learn_network, normalize_data, save_network, load_network,
load_data, graph, meta_variable_mask), with the same seven-function API.
It imports neither jax nor the JAX package: loading, normalization and the
result types are the port's own copies of the JAX package's host modules.
The learning runs on a ``device`` (default ``"cuda"``) with hand-written
CUDA kernels for the hot loops and plain PyTorch elsewhere.

Ported so far, on one device: the discrete modes mi and mi_nz
(``sensitive=False``) and fz_nz (``sensitive=True, heterogeneous=True``).
See ROADMAP.md for what remains.
"""

from .types import (
    TestResult,
    HitonState,
    LGLResult,
    FWResult,
    Graph,
    graph,
    meta_variable_mask,
    parameters,
)

__version__ = "0.1.0"

_LAZY = {
    "normalize_data": ("flashweave_tpu_torch.preprocessing", "normalize_data"),
    "load_data": ("flashweave_tpu_torch.io", "load_data"),
    "save_network": ("flashweave_tpu_torch.io", "save_network"),
    "load_network": ("flashweave_tpu_torch.io", "load_network"),
    "learn_network": ("flashweave_tpu_torch.learning.network", "learn_network"),
}


def __getattr__(name):
    # defer submodule imports (torch kernels, scipy) until first use
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "learn_network",
    "normalize_data",
    "save_network",
    "load_network",
    "load_data",
    "graph",
    "meta_variable_mask",
    "parameters",
    "TestResult",
    "HitonState",
    "LGLResult",
    "FWResult",
    "Graph",
]
