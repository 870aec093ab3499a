"""SALSA (stochastic approach for link-structure analysis): the host entry
`run`, the operator-layer `salsa_kernel` and the value-plane driver
`get_salsa_planes`.

Counterpart of the JAX package's `primitives/salsa.py`.  Per iteration:

    x[v]      = sum over w->v of hub[w] / outdeg(w)         forward
    hub'[u]   = sum over u->v of x[v] / indeg(v)            reverse
    y[u]      = sum over u->z of auth[z] / indeg(z)         reverse
    auth'[v]  = sum over u->v of y[u] / outdeg(u)           forward

with hub' zero where outdeg is 0 and auth' zero where indeg is 0, from
hub = 1/#(outdeg>0) and auth = 1/#(indeg>0) (salsa_problem.cuh:414-415);
fixed iteration count, host loop.  `mode="xla"` (the default,
`salsa_kernel`) runs each sum as the reference's scatter-add on a
`DeviceGraph`, through `ops/segment.py`'s fixed-order sums;
`mode="planes"` runs each as one ungated f32 add sweep of the value
kernel (`ops/value.py`) over the forward or the reverse device CSC
(`SearchGraph.reverse`), the same steppers HITS uses.
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
from gunrockinst_tpu_torch.primitives.hits import degrees_f32

_planes_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def salsa_kernel(graph: DeviceGraph, max_iter: int = 50
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hub (n_pad,) f32, auth (n_pad,) f32)."""
    esrc, edst = graph.edge_src, graph.edge_dst
    outdeg, indeg = degrees_f32(graph)
    so_e = torch.clamp(outdeg, min=1.0)[esrc]
    si_e = torch.clamp(indeg, min=1.0)[edst]
    out_nodes = torch.clamp((outdeg > 0).sum(dtype=torch.float32), min=1.0)
    in_nodes = torch.clamp((indeg > 0).sum(dtype=torch.float32), min=1.0)
    # strictly < n: the dummy vertex starts at 0 like all padding
    real = torch.arange(graph.n_pad, device=graph.device) < graph.n
    hub = torch.where(real, 1.0 / out_nodes, 0.0)
    auth = torch.where(real, 1.0 / in_nodes, 0.0)
    for _ in range(max_iter):
        x = sum_by_dst(graph, hub[esrc] / so_e)
        new_hub = sum_by_src(graph, x[edst] / si_e)
        y = sum_by_src(graph, auth[edst] / si_e)
        new_auth = sum_by_dst(graph, y[esrc] / so_e)
        hub = torch.where(outdeg > 0, new_hub, 0.0)
        auth = torch.where(indeg > 0, new_auth, 0.0)
    return hub, auth


class _SalsaPlanes:
    """fn(max_iter) -> (hub (n,) f32, auth (n,) f32, both in input ids,
    device_ms)."""

    def __init__(self, csr: CsrGraph, device: torch.device):
        g = search_graph(csr, device)
        self.g = g
        self.fwd = add_stepper(g)
        self.rev = add_stepper(g, reverse=True)
        n = csr.num_nodes
        outdeg = np.diff(csr.row_offsets).astype(np.int64)
        indeg = np.bincount(csr.col_indices, minlength=n).astype(np.int64)
        out_nodes = max(int((outdeg > 0).sum()), 1)
        in_nodes = max(int((indeg > 0).sum()), 1)
        self.inv_so = g.stage(1.0 / np.maximum(outdeg, 1))
        self.inv_si = g.stage(1.0 / np.maximum(indeg, 1))
        self.has_out = g.stage(outdeg > 0)
        self.has_in = g.stage(indeg > 0)
        self.hub0 = g.stage(np.full(n, 1.0 / out_nodes))
        self.auth0 = g.stage(np.full(n, 1.0 / in_nodes))

    def __call__(self, max_iter: int = 50
                 ) -> Tuple[np.ndarray, np.ndarray, float]:
        g = self.g
        hub, auth = self.hub0, self.auth0
        sync(g.device)
        with Timer() as t:
            for _ in range(max_iter):
                x = add_sweep(self.fwd, hub * self.inv_so)
                y = add_sweep(self.rev, auth * self.inv_si)
                hub = add_sweep(self.rev, x * self.inv_si) * self.has_out
                auth = add_sweep(self.fwd, y * self.inv_so) * self.has_in
            sync(g.device)
        return (g.to_input(hub).cpu().numpy(),
                g.to_input(auth).cpu().numpy(), t.elapsed_ms)


def get_salsa_planes(csr: CsrGraph, device: DeviceLike = None
                     ) -> _SalsaPlanes:
    """SALSA over the value kernel's add sweeps, cached per graph and
    device: fn(max_iter) -> (hub, auth, device_ms)."""
    dev = resolve_device(device)
    per_dev = _planes_cache.setdefault(csr, {})
    hit = per_dev.get(dev)
    if hit is None:
        hit = per_dev[dev] = _SalsaPlanes(csr, dev)
    return hit


@dataclasses.dataclass
class SalsaResult:
    hub_ranks: np.ndarray
    auth_ranks: np.ndarray
    stats: Stats


def run(graph: GraphLike, max_iter: int = 50, mode: str = "xla",
        device: DeviceLike = None) -> SalsaResult:
    """Host entry (run_salsa analog); mode="planes" needs a host
    CsrGraph.  `device=None` runs on the CUDA card and raises without
    one; `device="cpu"` runs there (the kernel's plain version for
    "planes")."""
    dev = resolve_device(device)
    if mode == "planes":
        if not isinstance(graph, CsrGraph):
            raise TypeError("mode='planes' needs a host CsrGraph")
        fn = get_salsa_planes(graph, dev)
        fn(max_iter)                    # warm-up: builds the kernel
        hub, auth, device_ms = fn(max_iter)
        n, m = graph.num_nodes, graph.num_edges
    elif mode == "xla":
        g = device_graph(graph, dev)
        salsa_kernel(g, max_iter)                 # warm-up
        sync(dev)
        with Timer() as t:
            hub, auth = salsa_kernel(g, max_iter)
            sync(dev)
        hub, auth = hub[: g.n].cpu().numpy(), auth[: g.n].cpu().numpy()
        device_ms, n, m = t.elapsed_ms, g.n, g.m
    else:
        raise ValueError(f"unknown mode {mode!r}")
    stats = Stats(elapsed_ms=device_ms, search_depth=max_iter,
                  nodes_visited=n, edges_visited=m * max_iter)
    return SalsaResult(hub_ranks=hub, auth_ranks=auth, stats=stats)
