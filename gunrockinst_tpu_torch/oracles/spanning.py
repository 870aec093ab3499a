"""MST host reference (Kruskal) and spanning-tree validators: a copy of
the JAX package's `oracles/spanning.py`.

Parity: `tests/mst/test_mst.cu` validates the Boruvka GPU result against
Boost `kruskal_minimum_spanning_tree` by comparing *total weights* (the
edge sets may differ when weights tie).
"""

from __future__ import annotations

import numpy as np

from gunrockinst_tpu_torch.graph.csr import CsrGraph


def mst_reference_weight(csr: CsrGraph) -> float:
    """Total weight of a minimum spanning forest (Kruskal, undirected
    interpretation of the edge list)."""
    n = csr.num_nodes
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.row_offsets))
    dst = csr.col_indices.astype(np.int64)
    w = (csr.edge_values if csr.edge_values is not None
         else np.ones(csr.num_edges, dtype=np.float32)).astype(np.float64)
    order = np.lexsort((dst, src, w))
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    total = 0.0
    for i in order:
        a, b = find(src[i]), find(dst[i])
        if a != b:
            parent[a] = b
            total += w[i]
    return float(total)


def verify_spanning_tree(csr: CsrGraph, edge_mask: np.ndarray) -> bool:
    """Check that the selected edges form a spanning forest: acyclic and
    connecting every component of the input graph."""
    n = csr.num_nodes
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.row_offsets))
    dst = csr.col_indices.astype(np.int64)
    sel = np.nonzero(edge_mask)[0]
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in sel:
        a, b = find(src[i]), find(dst[i])
        if a == b:
            return False  # cycle
        parent[a] = b
    # number of selected edges must equal n - #components of input graph
    from gunrockinst_tpu_torch.oracles.components import cc_reference
    ncomp = len(np.unique(cc_reference(csr)))
    return len(sel) == n - ncomp
