"""Betweenness centrality host references (Brandes): copies of the JAX
package's `oracles/centrality.py::bc_reference` and `bc_reference_fast`.

Parity: the reference validates per-source BC against Boost
`brandes_betweenness_centrality`-style references and halves the
accumulated values at the end (`tests/bc/test_bc.cu`).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from gunrockinst_tpu_torch.graph.csr import CsrGraph


def bc_reference(csr: CsrGraph, src: int = -1):
    """Brandes BC. src >= 0: single-source accumulation (like the
    reference's per-source enactor); src == -1: all sources.

    Returns (bc_values float32 (n,), sigmas float32 (n,) for the last
    source, labels int32 (n,) for the last source).
    Final bc values are halved (test_bc.cu convention).
    """
    n = csr.num_nodes
    ro, ci = csr.row_offsets, csr.col_indices
    bc = np.zeros(n, dtype=np.float64)
    sources = range(n) if src < 0 else [src]
    sigmas = np.zeros(n, dtype=np.float64)
    labels = np.full(n, -1, dtype=np.int32)
    for s in sources:
        sigma = np.zeros(n, dtype=np.float64)
        dist = np.full(n, -1, dtype=np.int32)
        sigma[s] = 1.0
        dist[s] = 0
        order = []
        q = deque([s])
        while q:
            u = q.popleft()
            order.append(u)
            for e in range(ro[u], ro[u + 1]):
                v = int(ci[e])
                if dist[v] < 0:
                    dist[v] = dist[u] + 1
                    q.append(v)
                if dist[v] == dist[u] + 1:
                    sigma[v] += sigma[u]
        delta = np.zeros(n, dtype=np.float64)
        for u in reversed(order):
            for e in range(ro[u], ro[u + 1]):
                v = int(ci[e])
                if dist[v] == dist[u] + 1 and sigma[v] > 0:
                    delta[u] += sigma[u] / sigma[v] * (1.0 + delta[v])
            if u != s:
                bc[u] += delta[u]
        sigmas, labels = sigma, dist
    return ((bc * 0.5).astype(np.float32), sigmas.astype(np.float32), labels)


def bc_reference_fast(csr: CsrGraph, src: int):
    """Vectorized single-source Brandes (NumPy bincount per level) for
    large-scale validation — same math as bc_reference, O(depth * m)
    array passes instead of Python edge loops.  Returns (bc_values
    f32 halved, sigma f32, labels i32 with -1 for unreached)."""
    n, m = csr.num_nodes, csr.num_edges
    esrc = np.repeat(np.arange(n, dtype=np.int64),
                     np.diff(csr.row_offsets))
    edst = csr.col_indices.astype(np.int64)
    labels = np.full(n, -1, np.int64)
    sigma = np.zeros(n, np.float64)
    labels[src] = 0
    sigma[src] = 1.0
    d = 0
    while True:
        tree = (labels[esrc] == d) & (labels[edst] < 0)
        if not tree.any():
            break
        touched = np.unique(edst[tree])
        labels[touched] = d + 1
        # now labels[edst]==d+1 exactly for this level's tree edges
        te = (labels[esrc] == d) & (labels[edst] == d + 1)
        sigma += np.bincount(edst[te], weights=sigma[esrc[te]],
                             minlength=n)
        d += 1
    delta = np.zeros(n, np.float64)
    inv_sigma = np.where(sigma > 0, 1.0 / np.maximum(sigma, 1e-300), 0.0)
    for dd in range(d, 0, -1):
        te = (labels[esrc] == dd - 1) & (labels[edst] == dd)
        contrib = sigma[esrc[te]] * inv_sigma[edst[te]] * (
            1.0 + delta[edst[te]])
        delta += np.bincount(esrc[te], weights=contrib, minlength=n)
    delta[src] = 0.0
    return ((delta * 0.5).astype(np.float32), sigma.astype(np.float32),
            labels.astype(np.int32))
