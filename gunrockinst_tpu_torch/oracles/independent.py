"""MIS validators and host reference (Luby rounds): a copy of the JAX
package's `oracles/independent.py`.

Parity: the reference's MIS assigns each vertex the round at which it
became a local maximum of its random priority among still-undecided
neighbors (mis_functor.cuh:84-89); round-0 vertices form a maximal
independent set, and the rounds partition V into independent sets.
"""

from __future__ import annotations

import numpy as np

from gunrockinst_tpu_torch.graph.csr import CsrGraph


def luby_rounds_reference(csr: CsrGraph, priorities: np.ndarray) -> np.ndarray:
    """Round ids for Luby's algorithm with the given static priorities.

    A vertex joins at round r iff its priority >= the max priority among
    its still-undecided out-neighbors (isolated vertices join at round 0).
    Ties are resolved like the reference: `>=` lets equal-priority
    neighbors join at the same round; callers should use distinct
    priorities for a true independent set.
    """
    n = csr.num_nodes
    ro, ci = csr.row_offsets, csr.col_indices
    rounds = np.full(n, -1, dtype=np.int32)
    pr = np.asarray(priorities)
    r = 0
    undecided = rounds < 0
    while undecided.any():
        join = []
        for v in np.nonzero(undecided)[0]:
            nb = ci[ro[v]:ro[v + 1]]
            nb = nb[undecided[nb]]
            nb = nb[nb != v]
            if nb.size == 0 or pr[v] >= pr[nb].max():
                join.append(v)
        if not join:  # cannot happen with a max, but guard anyway
            break
        rounds[np.asarray(join)] = r
        undecided = rounds < 0
        r += 1
    return rounds


def verify_mis(csr: CsrGraph, in_set: np.ndarray) -> bool:
    """Check `in_set` (bool mask) is an independent set and maximal,
    ignoring self loops, treating edges as undirected."""
    n = csr.num_nodes
    ro, ci = csr.row_offsets, csr.col_indices
    covered = in_set.copy()
    for u in range(n):
        for v in ci[ro[u]:ro[u + 1]]:
            if v == u:
                continue
            if in_set[u] and in_set[v]:
                return False  # not independent
            if in_set[u] or in_set[v]:
                covered[u] = covered[v] = True
    return bool(covered.all())
