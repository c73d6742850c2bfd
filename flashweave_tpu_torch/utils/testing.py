"""Copy of ``flashweave_tpu/utils/testing.py`` for the PyTorch port.

The JAX package's network comparison (numpy only), copied so that the
port imports nothing of ``flashweave_tpu``.  Nothing else differs;
``tests/test_torch_host_copies.py`` checks that.

Approximate graph comparison for parity testing.

Port of the reference's tolerance model (reference: test/learning.jl:46-103
``compare_graph_results``): candidate arrival order makes HITON accept
different-but-statistically-equivalent neighborhoods, so networks are
compared allowing a bounded number of differing neighbors and a bounded mean
relative weight difference.
"""

from __future__ import annotations

import numpy as np

from ..types import Graph


def compare_graph_results(g1: Graph, g2: Graph, verbose: bool = False,
                          rtol: float = 1e-2, atol: float = 0.0,
                          approx: bool = False, approx_nbr_diff: int = 1,
                          approx_weight_meandiff: float = 0.15) -> bool:
    if g1.n_nodes != g2.n_nodes:
        if verbose:
            print("Nodes don't match")
        return False
    nbr_diff = 0
    weight_diffvec = []
    for T in range(g1.n_nodes):
        nbrs1 = set(g1.neighbors(T))
        nbrs2 = set(g2.neighbors(T))
        if nbrs1 != nbrs2:
            num_diff = len(nbrs1 ^ nbrs2)
            if verbose:
                print(f"Neighbors for node {T} dont match ({num_diff} differ): "
                      f"{sorted(nbrs1 ^ nbrs2)}")
            if approx:
                nbr_diff += num_diff
            if not approx or nbr_diff > approx_nbr_diff:
                return False
        for nbr in nbrs1 & nbrs2:
            w1, w2 = g1.weight(T, nbr), g2.weight(T, nbr)
            if not np.isclose(w1, w2, rtol=rtol, atol=atol):
                if verbose:
                    print(f"Weights for node {T} and neighbor {nbr} dont fit: "
                          f"{w1}, {w2}")
                if approx:
                    weight_diffvec.append(abs(w1 - w2) / max(w1, w2))
                else:
                    return False
    if approx and weight_diffvec:
        meandiff = float(np.mean(weight_diffvec))
        if meandiff > approx_weight_meandiff:
            if verbose:
                print(f"Relative difference between mismatched weights "
                      f"{meandiff} > {approx_weight_meandiff}")
            return False
    return True
