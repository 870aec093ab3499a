"""BFS host reference (NumPy).

A copy of the JAX package's `oracles/traversal.py::bfs_reference`, so
that the port is checked without JAX.  Parity: SimpleReferenceBfs
(`tests/bfs/test_bfs.cu:258-330`, std::deque level BFS).
"""

from __future__ import annotations

import numpy as np

from gunrockinst_tpu_torch.graph.csr import CsrGraph

INF32 = np.iinfo(np.int32).max


def bfs_reference(csr: CsrGraph, src: int):
    """Level-synchronous BFS. Returns (labels int32, preds int32).

    labels[v] = hop distance from src (INT32_MAX if unreachable);
    preds[v] = parent with the minimum vertex id among parents at
    level labels[v]-1 (the deterministic tie-break the TPU advance
    uses via segment-min; the reference leaves ties to atomics and its
    tests only validate parent *validity*).
    """
    n = csr.num_nodes
    labels = np.full(n, INF32, dtype=np.int32)
    preds = np.full(n, -1, dtype=np.int32)
    labels[src] = 0
    frontier = [src]
    depth = 0
    ro, ci = csr.row_offsets, csr.col_indices
    while frontier:
        depth += 1
        nxt = {}
        for u in frontier:
            for e in range(ro[u], ro[u + 1]):
                v = int(ci[e])
                if labels[v] == INF32:
                    if v not in nxt or u < nxt[v]:
                        nxt[v] = u
        for v, p in nxt.items():
            labels[v] = depth
            preds[v] = p
        frontier = list(nxt.keys())
    return labels, preds
