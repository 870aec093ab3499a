"""Who-To-Follow host reference: a copy of the JAX package's
`oracles/wtf.py::wtf_reference`.

Reproduces gunrock/app/wtf exactly (wtf_enactor.cuh:280-530):
  1. personalized PageRank from src (PrFunctor loop),
  2. circle of trust = top `cot_size` vertices by rank
     (CUBRadixSort :403, cot_size = min(1000, n), test_wtf.cu:273),
  3. CotFunctor advance counts CoT-restricted in-degrees,
  4. 1/alpha SALSA-ish iterations with the reference's exact swap
     placement (NormalizeRank called between Auth and Hub advances,
     which gives the refscore stream a one-iteration lag):
       rank_next[s]     = sum_{s->d} ([s==src] alpha/outdeg(s)
                           + (1-alpha) refscore_curr[d]/cot_indeg[d])
       refscore_curr    <- refscore_next ; refscore_next <- 0
       refscore_next[d] = sum_{s->d, s in CoT} rank_curr[s]/max(outdeg,1)
       rank_curr        <- rank_next ; rank_next <- 0
"""

from __future__ import annotations

import numpy as np

from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.oracles.ranking import pagerank_reference


def wtf_reference(csr: CsrGraph, src: int, alpha: float = 0.2,
                  delta: float = 0.85, threshold: float = 0.01,
                  max_iter: int = 50, cot_size: int = 1000,
                  cot=None):
    """Pass `cot` to pin the circle of trust (tie-robust testing: PPR
    ties at the CoT boundary permute under different exact summation
    orders, changing the downstream SALSA phase discontinuously)."""
    n = csr.num_nodes
    esrc = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.row_offsets))
    edst = csr.col_indices.astype(np.int64)
    outdeg = np.diff(csr.row_offsets).astype(np.int64)

    ppr = pagerank_reference(csr, delta=delta, threshold=threshold,
                             max_iter=max_iter, src=src).astype(np.float64)
    order = np.lexsort((np.arange(n), -ppr))
    if cot is None:
        cot = order[: min(cot_size, n)]
    else:
        cot = np.asarray(cot, np.int64)
    in_cot = np.zeros(n, dtype=bool)
    in_cot[cot] = True

    cot_edge = in_cot[esrc]
    cot_indeg = np.bincount(edst[cot_edge], minlength=n)

    rank_curr = np.zeros(n)
    rank_next = np.zeros(n)
    ref_curr = np.zeros(n)
    ref_next = np.zeros(n)
    so = np.maximum(outdeg, 1)
    si = np.maximum(cot_indeg, 1)
    for _ in range(int(1.0 / alpha)):
        per_edge = np.where(
            esrc == src, alpha / so[esrc], 0.0
        ) + (1 - alpha) * ref_curr[edst] / si[edst]
        rank_next = np.bincount(esrc[cot_edge],
                                weights=per_edge[cot_edge], minlength=n)
        ref_curr, ref_next = ref_next, np.zeros(n)
        ref_next = np.bincount(edst[cot_edge],
                               weights=rank_curr[esrc[cot_edge]]
                               / so[esrc[cot_edge]], minlength=n)
        rank_curr, rank_next = rank_next, np.zeros(n)
    return (rank_curr.astype(np.float32), cot.astype(np.int32),
            ppr.astype(np.float32))
