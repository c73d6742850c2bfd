"""Copy of ``flashweave_tpu/types.py`` for the PyTorch port.

The JAX package's result and search-state types, copied so that the
port imports nothing of ``flashweave_tpu``.  A network learned by the port
is the port's own ``Graph`` / ``FWResult``; ``compare_graph_results`` of
the JAX package takes it all the same (it only calls ``n_nodes``,
``neighbors`` and ``weight``).
Nothing else differs; ``tests/test_torch_host_copies.py`` checks that.

Core result types.

TPU-native re-design of the reference's type layer (reference: src/types.jl).
The per-test dispatch objects (MiTest/FzTest/... reference src/types.jl:53-136)
are collapsed into plain parameters (`learning/hiton.HitonConfig` +
`ops/condtests.CondTestEngine`); the result containers below mirror the
reference's semantics 1:1 so that serialization and parity tests line up:

- TestResult            <- reference src/types.jl:140-145
- HitonState            <- reference src/types.jl:154-160
- LGLResult             <- reference src/types.jl:162-166
- FWResult              <- reference src/types.jl:172-198 (+ show, accessors)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# (stat, pval) pair keyed by neighbor variable, insertion-ordered like the
# reference's OrderedDict (plain dicts in py3.7+ preserve insertion order).
NbrStatDict = Dict[int, Tuple[float, float]]


class PSortedNbrs(dict):
    """Neighbor dict whose INSERTION ORDER is ascending p-value.

    The device univariate extraction inserts significant pairs in global
    p-sorted order, so each per-target dict it builds is already the
    stable-sorted candidate order HITON preparation needs -- tagged with
    this subclass so the per-target re-sort can be skipped."""

    __slots__ = ()

# rejection record: nbr -> (Zs, TestResult, (num_tests, frac_tests))
RejDict = Dict[int, Tuple[Tuple[int, ...], "TestResult", Tuple[int, float]]]


@dataclass(frozen=True)
class TestResult:
    """Statistical test outcome (reference: src/types.jl:140-145)."""

    __test__ = False  # not a pytest class

    stat: float
    pval: float
    df: int
    suff_power: bool

    def issig(self, alpha: float) -> bool:
        # reference: src/tests.jl:1-3
        return self.pval < alpha and self.suff_power


@dataclass
class HitonState:
    """Checkpointable per-variable search state (reference: src/types.jl:154-160).

    phase: 'S' start, 'I' interleaving, 'E' elimination, 'F' finished,
    'C' converged (frozen by global convergence check).
    """

    phase: str
    state_results: NbrStatDict = field(default_factory=dict)
    inter_results: NbrStatDict = field(default_factory=dict)
    unchecked_vars: List[int] = field(default_factory=list)
    state_rejections: RejDict = field(default_factory=dict)


class Graph:
    """Minimal undirected weighted graph with a fixed node count.

    Replaces the reference's SimpleWeightedGraph (adjacency dict-of-dicts +
    edge list); nodes are 0-based ints.
    """

    def __init__(self, n_nodes: int):
        self.n_nodes = int(n_nodes)
        self.adj: Dict[int, Dict[int, float]] = {}

    def add_edge(self, u: int, v: int, w: float = 1.0) -> None:
        self.adj.setdefault(u, {})[v] = w
        self.adj.setdefault(v, {})[u] = w

    def has_edge(self, u: int, v: int) -> bool:
        return u in self.adj and v in self.adj[u]

    def weight(self, u: int, v: int) -> float:
        return self.adj[u][v]

    def neighbors(self, u: int):
        return self.adj.get(u, {}).keys()

    def degree(self, u: int) -> int:
        return len(self.adj.get(u, {}))

    def n_edges(self) -> int:
        return sum(len(d) for d in self.adj.values()) // 2

    def edges(self):
        """Yield (u, v, w) with u < v, sorted (deterministic output order)."""
        for u in sorted(self.adj):
            for v in sorted(self.adj[u]):
                if u < v:
                    yield u, v, self.adj[u][v]

    def adjacency_matrix(self) -> np.ndarray:
        """Dense symmetric weight matrix (the reference exposes
        SimpleWeightedGraph.weights; reference src/io.jl:355)."""
        W = np.zeros((self.n_nodes, self.n_nodes))
        for u, v, w in self.edges():
            W[u, v] = W[v, u] = w
        return W

    def sparse_adjacency(self):
        """scipy.sparse CSR weight matrix for large networks."""
        from scipy.sparse import coo_matrix

        if not self.adj:
            return coo_matrix((self.n_nodes, self.n_nodes)).tocsr()
        rows, cols, ws = [], [], []
        for u, v, w in self.edges():
            rows += [u, v]
            cols += [v, u]
            ws += [w, w]
        return coo_matrix(
            (ws, (rows, cols)), shape=(self.n_nodes, self.n_nodes)
        ).tocsr()

    def __eq__(self, other):
        if not isinstance(other, Graph) or self.n_nodes != other.n_nodes:
            return False
        return sorted(self.edges()) == sorted(other.edges())


@dataclass
class LGLResult:
    """Local-to-global learning output (reference: src/types.jl:162-166)."""

    graph: Graph
    rejections: Dict[int, RejDict] = field(default_factory=dict)
    unfinished_states: Dict[int, HitonState] = field(default_factory=dict)


class FWResult:
    """Network result container (reference: src/types.jl:172-198)."""

    def __init__(
        self,
        inference_results: LGLResult,
        variable_ids: Optional[List[str]] = None,
        meta_variable_mask: Optional[np.ndarray] = None,
        parameters: Optional[Dict[str, Any]] = None,
    ):
        n_vars = inference_results.graph.n_nodes
        if parameters is None:
            parameters = {}
        if variable_ids is None:
            # reference uses 1-based "X1..Xn" names (src/types.jl:187)
            variable_ids = ["X" + str(i + 1) for i in range(n_vars)]
        if meta_variable_mask is None:
            meta_variable_mask = np.zeros(n_vars, dtype=bool)
        meta_variable_mask = np.asarray(meta_variable_mask, dtype=bool)
        assert n_vars == len(variable_ids), "variable_ids do not fit number of variables"
        assert n_vars == len(meta_variable_mask), "meta_variable_mask does not fit number of variables"
        self.inference_results = inference_results
        self.variable_ids = list(variable_ids)
        self.meta_variable_mask = meta_variable_mask
        self.parameters = parameters

    # accessors (reference: src/types.jl:203-241)
    @property
    def graph(self) -> Graph:
        return self.inference_results.graph

    @property
    def rejections(self) -> Dict[int, RejDict]:
        return self.inference_results.rejections

    @property
    def unfinished_states(self) -> Dict[int, HitonState]:
        return self.inference_results.unfinished_states

    def names(self) -> List[str]:
        return self.variable_ids

    def converged(self) -> bool:
        # reference quirk (src/types.jl:226): true iff unfinished states exist
        return len(self.inference_results.unfinished_states) > 0

    def unchecked_statistics(self):
        unf = self.unfinished_states
        if not unf:
            return 0, 0, 0.0
        n_unf = len(unf)
        n_unchecked = [len(s.unchecked_vars) for s in unf.values()]
        n_checked = [len(s.state_results) for s in unf.values()]
        mean_n_unchecked = round(float(np.mean(n_unchecked)), 3)
        mean_frac = round(
            float(np.mean([u / (u + c) if (u + c) else 0.0 for u, c in zip(n_unchecked, n_checked)])), 3
        )
        return n_unf, mean_n_unchecked, mean_frac

    def __eq__(self, other):
        if not isinstance(other, FWResult):
            return False
        return (
            self.graph == other.graph
            and self.variable_ids == other.variable_ids
            and np.array_equal(self.meta_variable_mask, other.meta_variable_mask)
        )

    def __repr__(self):
        from .utils.misc import mode_string

        params = self.parameters
        if all(k in params for k in ("heterogeneous", "sensitive", "max_k")):
            mode = mode_string(params["heterogeneous"], params["sensitive"], params["max_k"])
        else:
            mode = "unknown"
        g = self.graph
        n_meta = int(self.meta_variable_mask.sum())
        n_vars = g.n_nodes
        n_unf, mean_n_unchecked, mean_frac = self.unchecked_statistics()
        unf_str = (
            "none"
            if n_unf == 0
            else f"{n_unf}, on average missing {mean_n_unchecked} neighbors (mean fraction: {mean_frac})"
        )
        rej_str = "tracked" if self.rejections else "not tracked"
        return (
            f"\nMode:\n{mode}\n\nNetwork:\n"
            f"{g.n_edges()} interactions between {n_vars} variables "
            f"({n_vars - n_meta} OTUs and {n_meta} MVs)\n\n"
            f"Unfinished variables:\n{unf_str}\n\nRejections:\n{rej_str}"
        )


def graph(result: FWResult) -> Graph:
    """Extract the underlying weighted graph (reference: src/types.jl:208)."""
    return result.graph


def meta_variable_mask(result: FWResult) -> np.ndarray:
    return result.meta_variable_mask


def parameters(result: FWResult) -> Dict[str, Any]:
    return result.parameters
