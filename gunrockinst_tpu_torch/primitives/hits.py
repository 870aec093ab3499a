"""HITS (the reference's v0.2 variant with a personalization term): the
host entry `run`, the operator-layer `hits_kernel` and the value-plane
driver `get_hits_planes`.

Counterpart of the JAX package's `primitives/hits.py`.  Per iteration:

    auth[v] = sum over u->v of hub[u] / max(outdeg(u), 1)
    hub[u]  = [u==src] * delta * (outdeg(u) > 0)
              + (1-delta) * sum over u->v of auth[v] / max(indeg(v), 1)

Auth is refreshed first and hub reads the new auth.  Fixed iteration
count, host loop.  `mode="xla"` (the default, `hits_kernel`) runs the
two sums as the reference's scatter-adds (hits_functor.cuh:61-65,
108-111) on a `DeviceGraph`, through `ops/segment.py`'s fixed-order
sums.  `mode="planes"` runs the auth sum as one ungated f32 add sweep
of the value kernel (`ops/value.py`) over the forward device CSC (into
destinations), the hub sum as one over the reverse CSC (into sources,
`SearchGraph.reverse`); on a symmetric graph both are the one CSC that
BFS, SSSP, CC and PR sweep.  The personalization term factors out of
the hub sum exactly: over u's out-edges, the sum of [u==src] * delta /
outdeg(u) is [u==src] * delta when u has an out-edge.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph
from gunrockinst_tpu_torch.ops.segment import sum_by_dst, sum_by_src
from gunrockinst_tpu_torch.primitives.base import (GraphLike, Stats, Timer,
                                                   device_graph, sync)
from gunrockinst_tpu_torch.primitives.bfs_pallas import (add_stepper,
                                                         add_sweep,
                                                         search_graph)

_planes_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def degrees_f32(graph: DeviceGraph) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out-degree, in-degree) as float32 (n_pad,); the in-degree is
    counted from the real edges when the graph has no CSC."""
    indeg = graph.in_degree
    if indeg is None:
        indeg = torch.zeros_like(graph.out_degree).index_add_(
            0, graph.edge_dst, (graph.edge_src != graph.n).to(torch.int32))
    return graph.out_degree.to(torch.float32), indeg.to(torch.float32)


def hits_kernel(graph: DeviceGraph, src: int, delta: float,
                max_iter: int = 50) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hub (n_pad,) f32, auth (n_pad,) f32)."""
    esrc, edst = graph.edge_src, graph.edge_dst
    outdeg, indeg = degrees_f32(graph)
    so_e = torch.clamp(outdeg, min=1.0)[esrc]
    si_e = torch.clamp(indeg, min=1.0)[edst]
    is_src_e = (esrc == src).to(torch.float32)
    d = torch.tensor(delta, dtype=torch.float32, device=graph.device)
    hub = torch.zeros(graph.n_pad, dtype=torch.float32, device=graph.device)
    auth = hub
    for _ in range(max_iter):
        auth = sum_by_dst(graph, hub[esrc] / so_e)
        per_edge = is_src_e * d / so_e + (1.0 - d) * auth[edst] / si_e
        hub = sum_by_src(graph, per_edge)
    return hub, auth


class _HitsPlanes:
    """fn(src, delta, max_iter) -> (hub (n,) f32, auth (n,) f32, both in
    input ids, device_ms)."""

    def __init__(self, csr: CsrGraph, device: torch.device):
        g = search_graph(csr, device)
        self.g = g
        self.fwd = add_stepper(g)                 # auth: into dsts
        self.rev = add_stepper(g, reverse=True)   # hub: into srcs
        n = csr.num_nodes
        outdeg = np.diff(csr.row_offsets).astype(np.int64)
        indeg = np.bincount(csr.col_indices, minlength=n).astype(np.int64)
        self.inv_so = g.stage(1.0 / np.maximum(outdeg, 1))
        self.inv_si = g.stage(1.0 / np.maximum(indeg, 1))
        self.has_out = g.stage(outdeg > 0)

    def __call__(self, src: int = 0, delta: float = 0.85,
                 max_iter: int = 50) -> Tuple[np.ndarray, np.ndarray,
                                              float]:
        g = self.g
        p = np.zeros(g.n, np.float32)
        if 0 <= src < g.n:
            p[src] = 1.0
        d = torch.tensor(delta, dtype=torch.float32, device=g.device)
        pers_term = d * g.stage(p) * self.has_out
        hub = torch.zeros(g.n_words * 32, dtype=torch.float32,
                          device=g.device)
        auth = hub
        sync(g.device)
        with Timer() as t:
            for _ in range(max_iter):
                auth = add_sweep(self.fwd, hub * self.inv_so)
                hub = pers_term + (1.0 - d) * add_sweep(
                    self.rev, auth * self.inv_si)
            sync(g.device)
        return (g.to_input(hub).cpu().numpy(),
                g.to_input(auth).cpu().numpy(), t.elapsed_ms)


def get_hits_planes(csr: CsrGraph, device: DeviceLike = None
                    ) -> _HitsPlanes:
    """HITS over the value kernel's add sweeps, cached per graph and
    device: fn(src, delta, max_iter) -> (hub, auth, device_ms)."""
    dev = resolve_device(device)
    per_dev = _planes_cache.setdefault(csr, {})
    hit = per_dev.get(dev)
    if hit is None:
        hit = per_dev[dev] = _HitsPlanes(csr, dev)
    return hit


@dataclasses.dataclass
class HitsResult:
    hub_ranks: np.ndarray
    auth_ranks: np.ndarray
    stats: Stats


def run(graph: GraphLike, src: int = 0, delta: float = 0.85,
        max_iter: int = 50, mode: str = "xla",
        device: DeviceLike = None) -> HitsResult:
    """Host entry (run_hits analog); mode="planes" needs a host
    CsrGraph.  `device=None` runs on the CUDA card and raises without
    one; `device="cpu"` runs there (the kernel's plain version for
    "planes")."""
    dev = resolve_device(device)
    if mode == "planes":
        if not isinstance(graph, CsrGraph):
            raise TypeError("mode='planes' needs a host CsrGraph")
        fn = get_hits_planes(graph, dev)
        fn(src, delta, max_iter)        # warm-up: builds the kernel
        hub, auth, device_ms = fn(src, delta, max_iter)
        n, m = graph.num_nodes, graph.num_edges
    elif mode == "xla":
        g = device_graph(graph, dev)
        hits_kernel(g, src, delta, max_iter)      # warm-up
        sync(dev)
        with Timer() as t:
            hub, auth = hits_kernel(g, src, delta, max_iter)
            sync(dev)
        hub, auth = hub[: g.n].cpu().numpy(), auth[: g.n].cpu().numpy()
        device_ms, n, m = t.elapsed_ms, g.n, g.m
    else:
        raise ValueError(f"unknown mode {mode!r}")
    stats = Stats(elapsed_ms=device_ms, search_depth=max_iter,
                  nodes_visited=n, edges_visited=m * max_iter)
    return HitsResult(hub_ranks=hub, auth_ranks=auth, stats=stats)
