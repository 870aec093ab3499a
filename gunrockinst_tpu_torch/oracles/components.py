"""Connected components host reference (union-find).

A copy of the JAX package's `oracles/components.py`.  Parity: Boost
`connected_components` used by `tests/cc/test_cc.cu:40`.  Treats edges
as undirected (like the CC primitive's hooking, which joins src and dst
regardless of direction).
"""

from __future__ import annotations

import numpy as np

from gunrockinst_tpu_torch.graph.csr import CsrGraph


def cc_reference(csr: CsrGraph) -> np.ndarray:
    """Returns canonical component ids: comp[v] = min vertex id in v's
    (weakly) connected component."""
    n = csr.num_nodes
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    rows = np.repeat(np.arange(n), np.diff(csr.row_offsets))
    for u, v in zip(rows.tolist(), csr.col_indices.tolist()):
        ru, rv = find(u), find(v)
        if ru != rv:
            # union by min id keeps canonical labels simple
            if ru < rv:
                parent[rv] = ru
            else:
                parent[ru] = rv
    return np.array([find(v) for v in range(n)], dtype=np.int32)


def canonicalize_components(comp: np.ndarray) -> np.ndarray:
    """Relabel arbitrary component ids to min-vertex-id-in-component, so
    two labelings can be compared element-wise."""
    comp = np.asarray(comp)
    n = comp.shape[0]
    canon = {}
    for v in range(n):
        c = int(comp[v])
        if c not in canon:
            canon[c] = v
    out = np.fromiter((canon[int(c)] for c in comp), dtype=np.int32, count=n)
    return out
