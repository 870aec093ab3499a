"""Connected components: the host entry `run`, the hook-and-jump
`cc_kernel` and the value-plane driver `get_cc_planes`.

Counterpart of the JAX package's `primitives/cc.py`.  Both modes reach
the min input id of each weakly connected component:

  * "xla" (the default, `cc_kernel`): the reference's Soman hooking
    and pointer jumping (cc_functor.cuh:19-367) as one fixpoint,
    hook both ways along every edge (scatter-min), then jump twice
    (comp <- comp[comp]), with one host read a round;
  * "planes": min-label propagation, comp[v] <- min over the undirected
    neighbours u of comp[u], as rounds of full i32 min sweeps through
    the value kernel (`ops/value.py`), one launch per round and one
    read of the kernel's changed count.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.coo import CooGraph
from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph, derived
from gunrockinst_tpu_torch.graph.relabel import is_symmetric
from gunrockinst_tpu_torch.ops.segment import scatter_min
from gunrockinst_tpu_torch.ops.value import ValueStepper
from gunrockinst_tpu_torch.ops.words import pack_bitmap
from gunrockinst_tpu_torch.primitives.base import (GraphLike, Stats, Timer,
                                                   device_graph, sync)
from gunrockinst_tpu_torch.primitives.search_graph import search_graph


def cc_kernel(graph: DeviceGraph) -> Tuple[torch.Tensor, int]:
    """Returns (comp (n_pad,) int32, rounds)."""
    esrc, edst = graph.edge_src, graph.edge_dst
    comp = torch.arange(graph.n_pad, dtype=torch.int32, device=graph.device)
    changed, it = True, 0
    while changed and it < graph.n + 2:
        cs, cd = comp[esrc], comp[edst]
        hook = scatter_min(scatter_min(comp, edst, cs), esrc, cd)
        hook = hook[hook]
        hook = hook[hook]
        changed = bool((hook != comp).any())
        comp = hook
        it += 1
    return comp, it


def symmetrized(csr: CsrGraph) -> CsrGraph:
    """`csr` itself when it is already symmetric and canonical, else its
    undirected closure (weak connectivity, cc.py:88-105)."""
    n = csr.num_nodes
    esrc = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.row_offsets))
    ci = csr.col_indices
    if is_symmetric(csr):
        # equal to its transpose, so sorted by (row, col); the closure is
        # csr itself unless csr has a self-loop or a repeated edge
        repeated = (ci[1:] == ci[:-1]) & (esrc[1:] == esrc[:-1])
        if not (np.any(esrc == ci) or np.any(repeated)):
            return csr      # share the device CSC with bfs, sssp and pr
    return CsrGraph.from_coo(CooGraph(n, esrc, ci.astype(np.int64)),
                             undirected=True)


class _CcPlanes:
    """fn() -> (comp (n,) int32 in input ids, rounds, device_ms)."""

    def __init__(self, csr: CsrGraph, device: torch.device):
        self.und = symmetrized(csr)      # kept alive with this driver
        g = search_graph(self.und, device)
        self.g = g
        self.stepper = ValueStepper(g.stepper.offsets, g.stepper.in_src,
                                    mode="min", f32=False, use_active=True,
                                    out_edges=g.reverse)
        self.limit = g.n + 2

    def start(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Round-0 state: every vertex holds its INPUT id at its search
        position (so each representative stays the min input id), and
        every vertex is changed.  The padding holds 0 and has no edge."""
        g = self.g
        vals = g.to_internal(torch.arange(g.n, dtype=torch.int32,
                                          device=g.device))
        ch = pack_bitmap(torch.arange(g.n_words * 32, device=g.device)
                         < g.n, g.n_words)
        return vals, ch

    def __call__(self) -> Tuple[np.ndarray, int, float]:
        g = self.g
        vals, ch = self.start()
        sync(g.device)
        with Timer() as t:
            vals, it = self.stepper.fixpoint(vals, ch, self.limit)
            sync(g.device)
        return g.to_input(vals).cpu().numpy(), it, t.elapsed_ms


def get_cc_planes(csr: CsrGraph, device: DeviceLike = None) -> _CcPlanes:
    """Min-label propagation over the value kernel, cached per graph and
    device: fn() -> (comp (n,) int32, rounds, device_ms)."""
    dev = resolve_device(device)
    return derived(csr, ("cc_planes", dev), lambda: _CcPlanes(csr, dev))


@dataclasses.dataclass
class CcResult:
    component_ids: np.ndarray
    num_components: int
    stats: Stats


def run(graph: GraphLike, mode: str = "xla",
        device: DeviceLike = None) -> CcResult:
    """Host entry (run_cc analog, app/cc/cc_app.cu): component ids (min
    vertex id of each weakly connected component) and the stats block.
    mode="planes" needs a host CsrGraph.

    `device=None` runs on the CUDA card and raises without one;
    `device="cpu"` runs there (the kernel's plain version for
    "planes")."""
    dev = resolve_device(device)
    if mode == "planes":
        if not isinstance(graph, CsrGraph):
            raise TypeError("mode='planes' needs a host CsrGraph")
        fn = get_cc_planes(graph, dev)
        fn()                # warm-up: the first call builds the kernel
        comp_np, it, device_ms = fn()
        n, m = graph.num_nodes, graph.num_edges
    elif mode == "xla":
        g = device_graph(graph, dev)
        cc_kernel(g)                    # warm-up
        sync(dev)
        with Timer() as t:
            comp, it = cc_kernel(g)
            sync(dev)
        comp_np, device_ms = comp[: g.n].cpu().numpy(), t.elapsed_ms
        n, m = g.n, g.m
    else:
        raise ValueError(f"unknown mode {mode!r}")
    roots = int((comp_np == np.arange(n)).sum())
    stats = Stats(elapsed_ms=device_ms, search_depth=int(it),
                  nodes_visited=n, edges_visited=m)
    return CcResult(component_ids=comp_np, num_components=roots,
                    stats=stats)
