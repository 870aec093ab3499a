"""Minimum spanning tree (Boruvka).

Counterpart of the JAX package's `primitives/mst.py`, after
gunrock/app/mst (mst_enactor.cuh:255-832), whose supervertex pipeline
collapses to classic Boruvka on fixed-size arrays:

  per round:  the least (weight, edge id) cross edge of each component
              (two scatter-mins each), marked; then the component
              labels hooked and pointer-jumped over every marked edge
              to a fixpoint (the PJmpFunctor analog).

The (weight, edge id) order makes the result deterministic and cycles
impossible; every scatter is a min (order-free, also on floats) or a
count, so the bits are the same on every run.  Edges are canonicalized
to undirected (u < v) pairs on the host first (`canonical_edges`, a copy
of the reference's), so each undirected edge is selected and counted
once.  The rounds are a host loop with one host read a round and one a
compress step, where the reference runs nested `lax.while_loop`s.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import LANE, CsrGraph, _round_up
from gunrockinst_tpu_torch.ops.segment import scatter_min, scatter_or
from gunrockinst_tpu_torch.primitives.base import (INF32, GraphLike, Stats,
                                                   Timer, sync)

INT_MAX = INF32
F_INF = float("inf")
MAX_ROUNDS = 64


def _compress(comp, mask, cs_idx, cd_idx):
    """Hook and pointer-jump the component labels over the masked edges
    to a fixpoint."""
    while True:
        cs = torch.where(mask, comp[cs_idx], INT_MAX)
        cd = torch.where(mask, comp[cd_idx], INT_MAX)
        nc = scatter_min(comp, cd_idx, cs)
        nc = scatter_min(nc, cs_idx, cd)
        nc = nc[nc]
        nc = nc[nc]
        changed = bool((nc != comp).any())
        comp = nc
        if not changed:
            return comp


def mst_kernel(esrc: torch.Tensor, edst: torch.Tensor, w: torch.Tensor,
               n_pad: int):
    """Boruvka over canonical undirected edges (padding edges start at
    `n_pad`, weight inf).  Returns (in_mst (m_pad,) bool, comp (n_pad,)
    int32, rounds)."""
    dev = esrc.device
    m_pad = esrc.shape[0]
    real_e = esrc < n_pad
    eids = torch.arange(m_pad, dtype=torch.int32, device=dev)
    cs_idx = esrc.clamp(0, n_pad - 1)
    cd_idx = edst.clamp(0, n_pad - 1)
    comp = torch.arange(n_pad, dtype=torch.int32, device=dev)
    in_mst = torch.zeros(m_pad, dtype=torch.bool, device=dev)
    rounds, go = 0, True
    while go and rounds < MAX_ROUNDS:
        c1, c2 = comp[cs_idx], comp[cd_idx]
        cross = (c1 != c2) & real_e
        wq = torch.where(cross, w, F_INF)
        minw = torch.full((n_pad,), F_INF, dtype=torch.float32, device=dev)
        minw = scatter_min(scatter_min(minw, c1, wq), c2, wq)
        at1, at2 = w == minw[c1], w == minw[c2]
        ach = cross & (at1 | at2)
        # the least edge id among each component's lightest edges
        sel = torch.full((n_pad,), INT_MAX, dtype=torch.int32, device=dev)
        sel = scatter_min(sel, c1, torch.where(ach & at1, eids, INT_MAX))
        sel = scatter_min(sel, c2, torch.where(ach & at2, eids, INT_MAX))
        has = sel != INT_MAX
        # id m_pad drops, as the reference's mode="drop" scatter does
        in_mst = scatter_or(in_mst, torch.where(has, sel, m_pad), has)
        comp = _compress(comp, in_mst, cs_idx, cd_idx)
        go = bool(cross.any())
        rounds += 1
    return in_mst, comp, rounds


@dataclasses.dataclass
class MstResult:
    edge_mask: np.ndarray   # over canonical undirected edges
    edges: np.ndarray       # (k, 2) selected (u, v) pairs
    total_weight: float
    stats: Stats


def canonical_edges(csr: CsrGraph):
    """Undirected (u < v) canonical edge list with weights; duplicate
    pairs keep the minimum weight."""
    n = csr.num_nodes
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.row_offsets))
    dst = csr.col_indices.astype(np.int64)
    w = (csr.edge_values if csr.edge_values is not None
         else np.ones(csr.num_edges, dtype=np.float32)).astype(np.float32)
    u = np.minimum(src, dst)
    v = np.maximum(src, dst)
    keep = u != v
    u, v, w = u[keep], v[keep], w[keep]
    order = np.lexsort((w, v, u))
    u, v, w = u[order], v[order], w[order]
    first = np.ones(len(u), dtype=bool)
    first[1:] = (u[1:] != u[:-1]) | (v[1:] != v[:-1])
    return u[first].astype(np.int32), v[first].astype(np.int32), w[first]


def run(graph: GraphLike, device: DeviceLike = None) -> MstResult:
    """Host entry (run_mst analog).  Accepts a host CsrGraph (weights
    default to 1).

    `device=None` runs on the CUDA card and raises without one;
    `device="cpu"` runs there."""
    dev = resolve_device(device)
    if not isinstance(graph, CsrGraph):
        raise TypeError("mst.run expects a host CsrGraph")
    csr = graph
    n_pad = _round_up(csr.num_nodes + 1, LANE)
    u, v, w = canonical_edges(csr)
    m = len(u)
    m_pad = _round_up(max(m, 1), LANE)
    eu = np.full(m_pad, n_pad, dtype=np.int32)
    ev = np.full(m_pad, n_pad, dtype=np.int32)
    ew = np.full(m_pad, np.inf, dtype=np.float32)
    eu[:m], ev[:m], ew[:m] = u, v, w
    eu_d, ev_d, ew_d = (torch.from_numpy(a).to(dev) for a in (eu, ev, ew))
    mst_kernel(eu_d, ev_d, ew_d, n_pad)         # warm-up
    sync(dev)
    with Timer() as t:
        in_mst, _, rounds = mst_kernel(eu_d, ev_d, ew_d, n_pad)
        sync(dev)
    mask = in_mst[:m].cpu().numpy()
    total = float(w[mask].sum())
    stats = Stats(elapsed_ms=t.elapsed_ms, search_depth=rounds,
                  nodes_visited=csr.num_nodes, edges_visited=m)
    return MstResult(
        edge_mask=mask,
        edges=np.stack([u[mask], v[mask]], axis=1),
        total_weight=total,
        stats=stats,
    )
