"""Single-source shortest paths: the host entry `run` and the value-plane
driver `get_sssp_planes`.

Counterpart of the JAX package's `primitives/sssp.py`.  This slice of
the port carries `mode="planes"`: Bellman rounds of full min-plus
sweeps through the value kernel (`ops/value.py`), one launch per round
and one read of the kernel's changed count, until no distance changes.
Candidates are exact f32 adds, so the fixpoint equals the Dijkstra
oracle bit for bit.  The near-far modes ("delta", "bellman", "sparse")
are not ported yet and raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.ops.value import ValueStepper
from gunrockinst_tpu_torch.primitives.base import Stats, Timer, sync
from gunrockinst_tpu_torch.primitives.bfs_pallas import search_graph

_planes_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class _SsspPlanes:
    """fn(src) -> (dist (n,) f32 in input ids, rounds, device_ms)."""

    def __init__(self, csr: CsrGraph, device: torch.device):
        g = search_graph(csr, device)   # the device CSC BFS uses too
        self.g = g
        w = g.csc.edge_values
        # uniform weights (the unweighted-graph case): one constant in
        # the kernel instead of a weight per edge (sssp.py:188-197)
        uniform = w is None or w.size == 0 or bool(np.all(w == w.flat[0]))
        weights, const_w = None, None
        if uniform:
            const_w = (float(np.float32(w.flat[0]))
                       if w is not None and w.size else 1.0)
        else:
            weights = torch.from_numpy(np.ascontiguousarray(
                w, dtype=np.float32)).to(device)
        self.stepper = ValueStepper(
            g.stepper.offsets, g.stepper.in_src, mode="min", f32=True,
            weights=weights, const_w=const_w, use_active=True)
        self.limit = 4 * g.n + 8

    def start(self, src: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Round-0 state: dist = inf but 0.0 at the source, and the
        changed map holding only the source, in search ids."""
        g = self.g
        psrc = g.internal(src)
        vals = torch.full((g.n_words * 32,), float("inf"),
                          dtype=torch.float32,
                          device=g.device).view(torch.int32)
        vals[psrc] = 0                   # the bits of 0.0f
        ch = g.start(psrc)
        return vals, ch

    def __call__(self, src: int) -> Tuple[np.ndarray, int, float]:
        g = self.g
        vals, ch = self.start(src)
        sync(g.device)
        with Timer() as t:
            vals, it = self.stepper.fixpoint(vals, ch, self.limit)
            sync(g.device)
        dist = g.to_input(vals.view(torch.float32)).cpu().numpy()
        return dist, it, t.elapsed_ms

    def preds(self, dist_np: np.ndarray, src: int) -> np.ndarray:
        """preds[v] = least input id of the in-neighbours u with
        dist[u] + w(u,v) == dist[v] (one f32 add), -1 where there is
        none and at the source (sssp.py:267-279), over the device CSC
        and weights the sweeps read."""
        g, st = self.g, self.stepper
        dist = g.to_internal(torch.from_numpy(dist_np).to(g.device),
                             float("inf"))
        w = (st.weights if st.weights is not None else torch.tensor(
            st.const_w, dtype=torch.float32, device=g.device))

        def achieves(u, v):
            du, dv = dist[u], dist[v]
            return torch.isfinite(du) & torch.isfinite(dv) & (du + w == dv)

        preds = g.min_preds(achieves)
        preds[src] = -1
        return preds


def get_sssp_planes(csr: CsrGraph, device: DeviceLike = None) -> _SsspPlanes:
    """Bellman driver over the value kernel, cached per graph and
    device: fn(src) -> (dist (n,) f32, rounds, device_ms)."""
    dev = resolve_device(device)
    per_dev = _planes_cache.setdefault(csr, {})
    hit = per_dev.get(dev)
    if hit is None:
        hit = per_dev[dev] = _SsspPlanes(csr, dev)
    return hit


@dataclasses.dataclass
class SsspResult:
    dist: np.ndarray
    preds: Optional[np.ndarray]
    stats: Stats


def run(graph: CsrGraph, src: int, delta: Optional[float] = None,
        mode: str = "sparse", mark_preds: bool = True,
        device: DeviceLike = None) -> SsspResult:
    """Host entry (run_sssp analog, app/sssp/sssp_app.cu): distances,
    optional predecessors (min-id tie-break) and the stats block.
    `delta` belongs to the modes not ported yet and is not read.

    `device=None` runs on the CUDA card and raises without one;
    `device="cpu"` runs the kernel's plain version."""
    dev = resolve_device(device)
    if mode != "planes":
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet: ROADMAP.md queue 1, item 6")
    if not isinstance(graph, CsrGraph):
        raise TypeError("mode='planes' needs a host CsrGraph")
    if not 0 <= int(src) < graph.num_nodes:
        raise ValueError(
            f"source vertex {src} out of range [0, {graph.num_nodes})")
    if graph.edge_values is not None and np.any(graph.edge_values < 0):
        raise ValueError("SSSP requires non-negative edge weights")
    fn = get_sssp_planes(graph, dev)
    fn(src)                 # warm-up: the first call builds the kernel
    dist_np, it, device_ms = fn(src)
    preds_np = fn.preds(dist_np, int(src)) if mark_preds else None
    visited = np.isfinite(dist_np)
    deg = np.diff(graph.row_offsets)
    stats = Stats(elapsed_ms=device_ms, search_depth=int(it),
                  nodes_visited=int(visited.sum()),
                  edges_visited=int(deg[visited].sum()))
    return SsspResult(dist=dist_np, preds=preds_np, stats=stats)
