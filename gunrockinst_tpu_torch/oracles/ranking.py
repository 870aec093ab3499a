"""PageRank, HITS and SALSA host references.

Copies of the JAX package's `oracles/ranking.py::remove_dangling_degrees`,
`pagerank_reference`, `hits_reference` and `salsa_reference`.  They
reproduce the reference's *exact* update rules (unnormalized PR with
rank init (1-delta), gunrock/app/pr/pr_problem.cuh:407).
"""

from __future__ import annotations

from typing import Tuple

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


def hits_reference(csr: CsrGraph, src: int, delta: float = 0.85,
                   max_iter: int = 50) -> Tuple[np.ndarray, np.ndarray]:
    """Gunrock-v0.2 HITS variant (hits_functor.cuh:61-65,108-111):

      auth_next[v] = sum_{u->v} hub[u] / max(outdeg(u), 1)
      hub_next[u]  = sum_{u->v} ( [u==src] * delta/outdeg(u)
                                  + (1-delta) * auth_next[v]/indeg(v) )

    (auth is updated first and hub reads the fresh auth values —
    hits_enactor.cuh:217-330 runs the auth advance + swap, then hub.)
    Initial hub = auth = 0 except hub[src] handled by the delta term.
    """
    n = csr.num_nodes
    esrc, edst = _edge_arrays(csr)
    outdeg = np.diff(csr.row_offsets).astype(np.int64)
    indeg = np.bincount(edst, minlength=n)
    hub = np.zeros(n, dtype=np.float64)
    auth = np.zeros(n, dtype=np.float64)
    for _ in range(max_iter):
        auth = np.bincount(edst, weights=hub[esrc] / np.maximum(outdeg[esrc], 1),
                           minlength=n)
        per_edge = np.where(esrc == src, delta / np.maximum(outdeg[esrc], 1), 0.0)
        per_edge = per_edge + (1 - delta) * auth[edst] / np.maximum(indeg[edst], 1)
        hub = np.bincount(esrc, weights=per_edge, minlength=n)
    return hub.astype(np.float32), auth.astype(np.float32)


def salsa_reference(csr: CsrGraph, max_iter: int = 50
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """SALSA random-walk updates (salsa_functor.cuh:110-115,206-212):

      hub_next[u]  = sum_{e=(u,v)} (1/indeg(v)) sum_{w->v} hub[w]/outdeg(w)
      auth_next[v] = sum_{e=(u,v)} (1/outdeg(u)) sum_{u->z} auth[z]/indeg(z)

    init hub = 1/#{v: outdeg(v)>0}, auth = 1/#{v: indeg(v)>0}
    (salsa_problem.cuh:414-415). No inter-iteration normalization.
    """
    n = csr.num_nodes
    esrc, edst = _edge_arrays(csr)
    outdeg = np.diff(csr.row_offsets).astype(np.int64)
    indeg = np.bincount(edst, minlength=n)
    out_nodes = max(int((outdeg > 0).sum()), 1)
    in_nodes = max(int((indeg > 0).sum()), 1)
    hub = np.full(n, 1.0 / out_nodes, dtype=np.float64)
    auth = np.full(n, 1.0 / in_nodes, dtype=np.float64)
    so = np.maximum(outdeg, 1)
    si = np.maximum(indeg, 1)
    for _ in range(max_iter):
        # x[v] = sum_{w->v} hub[w]/outdeg(w)
        x = np.bincount(edst, weights=hub[esrc] / so[esrc], minlength=n)
        new_hub = np.bincount(esrc, weights=x[edst] / si[edst], minlength=n)
        # y[u] = sum_{u->z} auth[z]/indeg(z)
        y = np.bincount(esrc, weights=auth[edst] / si[edst], minlength=n)
        new_auth = np.bincount(edst, weights=y[esrc] / so[esrc], minlength=n)
        hub, auth = new_hub, new_auth
        hub[outdeg == 0] = 0.0
        auth[indeg == 0] = 0.0
    return hub.astype(np.float32), auth.astype(np.float32)
