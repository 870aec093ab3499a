"""BFS / SSSP host references (NumPy).

Copies of the JAX package's `oracles/traversal.py::bfs_reference` and
`sssp_reference`, so that the port is checked without JAX.  Parity:
SimpleReferenceBfs (`tests/bfs/test_bfs.cu:258-330`, std::deque level
BFS) and the Dijkstra reference of `tests/sssp/test_sssp.cu`.
"""

from __future__ import annotations

import heapq

import numpy as np

from gunrockinst_tpu_torch.graph.csr import CsrGraph

INF32 = np.iinfo(np.int32).max
FINF = np.float32(np.inf)


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


def sssp_reference(csr: CsrGraph, src: int):
    """Dijkstra. Returns (dist float32, preds int32).

    preds[v] = min vertex id among u minimizing dist[u]+w(u,v)
    (same deterministic tie-break as the TPU kernels).
    """
    n = csr.num_nodes
    w = (csr.edge_values if csr.edge_values is not None
         else np.ones(csr.num_edges, dtype=np.float32))
    dist = np.full(n, FINF, dtype=np.float32)
    dist[src] = 0.0
    visited = np.zeros(n, dtype=bool)
    heap = [(np.float32(0.0), src)]
    ro, ci = csr.row_offsets, csr.col_indices
    while heap:
        d, u = heapq.heappop(heap)
        if visited[u]:
            continue
        visited[u] = True
        for e in range(ro[u], ro[u + 1]):
            v = int(ci[e])
            nd = np.float32(np.float32(d) + w[e])
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    # deterministic preds from final distances
    preds = np.full(n, -1, dtype=np.int32)
    for u in range(n):
        if not np.isfinite(dist[u]):
            continue
        for e in range(ro[u], ro[u + 1]):
            v = int(ci[e])
            if v == src:
                continue
            if np.float32(dist[u] + w[e]) == dist[v] and (
                    preds[v] < 0 or u < preds[v]):
                preds[v] = u
    preds[src] = -1
    return dist, preds
