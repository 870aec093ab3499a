"""PageRank host references.

Copies of the JAX package's `oracles/ranking.py::remove_dangling_degrees`
and `pagerank_reference`.  They reproduce the reference's *exact*
update rules (unnormalized PR with rank init (1-delta),
gunrock/app/pr/pr_problem.cuh:407).
"""

from __future__ import annotations

import numpy as np

from gunrockinst_tpu_torch.graph.csr import CsrGraph


def _edge_arrays(csr: CsrGraph):
    src = np.repeat(np.arange(csr.num_nodes, dtype=np.int64),
                    np.diff(csr.row_offsets))
    dst = csr.col_indices.astype(np.int64)
    return src, dst


def remove_dangling_degrees(csr: CsrGraph) -> np.ndarray:
    """Iteratively zero out vertices whose out-degree (counting only
    edges to still-live vertices) drops to 0, mirroring the reference's
    RemoveZeroDegreeNodeFunctor pre-pass (pr_enactor.cuh:247-300).
    Returns the effective out-degree array used by PR."""
    src, dst = _edge_arrays(csr)
    deg = np.diff(csr.row_offsets).astype(np.int64)
    while True:
        dead = deg == 0
        # edges pointing at dead vertices stop counting toward src degree
        live_edge = ~dead[dst]
        new_deg = np.bincount(src[live_edge], minlength=csr.num_nodes)
        new_deg[dead] = 0
        if np.array_equal(new_deg, deg):
            return deg
        deg = new_deg


def pagerank_reference(csr: CsrGraph, delta: float = 0.85,
                       threshold: float = 0.01, max_iter: int = 50,
                       src: int = -1) -> np.ndarray:
    """Gunrock-semantics PageRank (pr_functor.cuh:49-88):

      rank0[v]    = 1 - delta
      push        : next[d] += curr[s]/deg[s]   for edges with deg[s]>0, deg[d]>0
      filter      : next[v] = delta*next[v] + (1-delta)*[src==v or src==-1]
      frontier    : keep v with |next[v]-curr[v]| > threshold
      stop        : frontier empty or max_iter

    Vertices leaving the frontier stop *pushing*, but still receive.
    """
    n = csr.num_nodes
    esrc, edst = _edge_arrays(csr)
    deg = remove_dangling_degrees(csr)
    rank = np.full(n, 1.0 - delta, dtype=np.float64)
    active = deg > 0  # initial frontier excludes removed zero-degree nodes
    it = 0
    while active.any() and it <= max_iter:
        contrib = np.where(active & (deg > 0), rank / np.maximum(deg, 1), 0.0)
        ok = (deg[esrc] > 0) & (deg[edst] > 0)
        nxt = np.bincount(edst[ok], weights=contrib[esrc[ok]], minlength=n)
        personal = (np.ones(n) if src < 0
                    else (np.arange(n) == src).astype(np.float64))
        nxt = delta * nxt + (1.0 - delta) * personal
        active = np.abs(nxt - rank) > threshold
        rank = nxt
        it += 1
    return rank.astype(np.float32)
