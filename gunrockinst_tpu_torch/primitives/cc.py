"""Connected components: the host entry `run` and the value-plane driver
`get_cc_planes`.

Counterpart of the JAX package's `primitives/cc.py`.  This slice of the
port carries `mode="planes"`: min-label propagation, comp[v] <- min over
the undirected neighbours u of comp[u], as rounds of full i32 min
sweeps through the value kernel (`ops/value.py`), one launch per round
and one read of the kernel's changed count.  The fixpoint is the min
input id of each weakly connected component.  The hook-and-jump
`mode="xla"` is not ported yet and raises `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.coo import CooGraph
from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.graph.relabel import is_symmetric
from gunrockinst_tpu_torch.ops.value import ValueStepper
from gunrockinst_tpu_torch.ops.words import pack_bitmap
from gunrockinst_tpu_torch.primitives.base import Stats, Timer, sync
from gunrockinst_tpu_torch.primitives.bfs_pallas import search_graph

_planes_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


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
                                    mode="min", f32=False, use_active=True)
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
    per_dev = _planes_cache.setdefault(csr, {})
    hit = per_dev.get(dev)
    if hit is None:
        hit = per_dev[dev] = _CcPlanes(csr, dev)
    return hit


@dataclasses.dataclass
class CcResult:
    component_ids: np.ndarray
    num_components: int
    stats: Stats


def run(graph: CsrGraph, mode: str = "xla",
        device: DeviceLike = None) -> CcResult:
    """Host entry (run_cc analog, app/cc/cc_app.cu): component ids (min
    vertex id of each weakly connected component) and the stats block.

    `device=None` runs on the CUDA card and raises without one;
    `device="cpu"` runs the kernel's plain version."""
    dev = resolve_device(device)
    if mode != "planes":
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet: ROADMAP.md queue 1, item 6")
    if not isinstance(graph, CsrGraph):
        raise TypeError("mode='planes' needs a host CsrGraph")
    fn = get_cc_planes(graph, dev)
    fn()                    # warm-up: the first call builds the kernel
    comp_np, it, device_ms = fn()
    roots = int((comp_np == np.arange(graph.num_nodes)).sum())
    stats = Stats(elapsed_ms=device_ms, search_depth=int(it),
                  nodes_visited=graph.num_nodes,
                  edges_visited=graph.num_edges)
    return CcResult(component_ids=comp_np, num_components=roots,
                    stats=stats)
