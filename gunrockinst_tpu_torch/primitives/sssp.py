"""Single-source shortest paths: the host entry `run`, the operator-layer
search `sssp_kernel` and the value-plane driver `get_sssp_planes`.

Counterpart of the JAX package's `primitives/sssp.py`.  The reference's
atomicMin relax (sssp_functor.cuh:64) is a scatter-min; modes:

  * "sparse" (the default): Bellman rounds that relax only the pending
    vertices' out-edges, expanded load-balanced from their compacted
    ids (`ops/advance.py::expand_frontier`'s scan and binary search),
    or every edge when the pending out-edges pass a quarter of m_pad;
  * "delta": near/far delta-stepping buckets (`ops/priority.py`);
  * "bellman": relax the whole pending set each round;
  * "planes": Bellman rounds of full min-plus sweeps through the value
    kernel (`ops/value.py`), one launch per round and one read of the
    kernel's changed count, until no distance changes.

Every mode converges to the least fixpoint of the float32 Bellman
operator, so distances match the Dijkstra oracle bit for bit; rounds
count as the reference counts them (a delta-stepping level bump is a
round).  Predecessors are derived afterwards from the final distances
with the least-id tie-break.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph
from gunrockinst_tpu_torch.ops import frontier as fr
from gunrockinst_tpu_torch.ops.advance import expand_frontier
from gunrockinst_tpu_torch.ops.priority import (near_far_split,
                                                next_nonempty_level)
from gunrockinst_tpu_torch.ops.segment import scatter_min
from gunrockinst_tpu_torch.ops.value import ValueStepper
from gunrockinst_tpu_torch.primitives.base import (INF32, GraphLike, Stats,
                                                   Timer, device_graph,
                                                   sync)
from gunrockinst_tpu_torch.primitives.bfs_pallas import search_graph

INT_MAX = INF32
F_INF = float("inf")


def _relax(graph: DeviceGraph, dist, pending, active):
    """One Bellman round over every edge from an `active` vertex:
    (new dist, new pending = pending - active + changed)."""
    esrc, edst = graph.edge_src, graph.edge_dst
    vals = torch.where(active[esrc], dist[esrc] + graph.edge_w, F_INF)
    relaxed = scatter_min(torch.full_like(dist, F_INF), edst, vals)
    newdist = torch.minimum(dist, relaxed)
    return newdist, (pending & ~active) | (newdist < dist)


def _relax_compact(graph: DeviceGraph, dist, pending, count: int,
                   edges: int):
    """`_relax` of the whole pending set through its compacted ids: the
    `count` pending vertices' `edges` out-edges expanded into lanes.
    The same candidates reach the same scatter-min, so the round gives
    the same bits as `_relax`."""
    ids, _ = fr.compact(pending, count, graph.n)
    src, dst, eid, _ = expand_frontier(graph, ids, count, edges)
    vals = dist[src] + graph.edge_w[eid]
    relaxed = scatter_min(torch.full_like(dist, F_INF), dst, vals)
    newdist = torch.minimum(dist, relaxed)
    return newdist, newdist < dist


def min_preds(graph: DeviceGraph, dist: torch.Tensor,
              src: int) -> torch.Tensor:
    """preds[v] = the least u with dist[u] + w(u,v) == dist[v] (one f32
    add), -1 where there is none and at the source."""
    esrc, edst = graph.edge_src, graph.edge_dst
    ds = dist[esrc]
    achieves = torch.isfinite(ds) & (ds + graph.edge_w == dist[edst])
    preds = scatter_min(torch.full((graph.n_pad,), INT_MAX,
                                   dtype=torch.int32, device=esrc.device),
                        edst, torch.where(achieves, esrc, INT_MAX))
    preds = torch.where(torch.isfinite(dist) & (preds != INT_MAX), preds,
                        -1)
    preds[int(src)] = -1
    return preds


def sssp_kernel(graph: DeviceGraph, src: int, delta: float,
                mode: str = "delta", max_iter: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (dist (n_pad,) f32, preds (n_pad,) int32, rounds), one
    host read a round.  `delta` is cast to float32 (the bucket width of
    mode "delta")."""
    if mode not in ("delta", "bellman", "sparse"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = graph.device
    limit = max_iter if max_iter is not None else 4 * graph.n + 8
    delta_t = torch.tensor(delta, dtype=torch.float32, device=dev)
    dist = torch.full((graph.n_pad,), F_INF, dtype=torch.float32,
                      device=dev)
    dist[int(src)] = 0.0
    pending = fr.singleton_bitmap(src, graph.n_pad, dev)
    level, it = 0, 0
    while it < limit:
        if mode == "sparse":
            # one host read: the pending count and their out-edges
            count, edges = torch.stack((
                pending.sum(dtype=torch.int64),
                torch.where(pending, graph.out_degree, 0).sum(
                    dtype=torch.int64))).tolist()
            if count == 0:
                break
            if 4 * edges <= graph.m_pad:
                dist, pending = _relax_compact(graph, dist, pending, count,
                                               edges)
            else:
                dist, pending = _relax(graph, dist, pending, pending)
        elif not bool(pending.any()):
            break
        elif mode == "bellman":
            dist, pending = _relax(graph, dist, pending, pending)
        else:
            near, _ = near_far_split(pending, dist, level, delta_t)
            if bool(near.any()):
                dist, pending = _relax(graph, dist, pending, near)
            else:
                # jump straight to the bucket of the nearest pending
                # vertex (one bump a round would stall for a tiny delta)
                level = next_nonempty_level(pending, dist, level, delta_t)
        it += 1
    return dist, min_preds(graph, dist, src), it

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


def default_delta(graph: DeviceGraph) -> float:
    """The near/far split granularity of mode "delta": the mean edge
    weight in the reference's arithmetic (sssp.py:298-302), a float32
    sum over the m_pad weights and a float32 divide by max(m, 1), at
    least 1e-6.  The sum's order is each library's own: where the
    float32 sum is not exact (weights that are not small integers, or a
    total above 2^24), its last bit can differ from the reference's."""
    mean_w = graph.edge_w.sum() / torch.tensor(max(graph.m, 1),
                                               dtype=torch.float32)
    return max(float(mean_w), 1e-6)


def run(graph: GraphLike, src: int, delta: Optional[float] = None,
        mode: str = "sparse", mark_preds: bool = True,
        device: DeviceLike = None) -> SsspResult:
    """Host entry (run_sssp analog, app/sssp/sssp_app.cu): distances,
    optional predecessors (min-id tie-break) and the stats block.
    `delta` is the bucket width of mode "delta", by default the mean
    edge weight; mode="planes" needs a host CsrGraph.

    `device=None` runs on the CUDA card and raises without one;
    `device="cpu"` runs there (the kernel's plain version for
    "planes")."""
    dev = resolve_device(device)
    if mode == "planes":
        return _run_planes(graph, src, mark_preds, dev)
    g = device_graph(graph, dev)
    if not 0 <= int(src) < g.n:
        raise ValueError(f"source vertex {src} out of range [0, {g.n})")
    # negative weights: neither delta-stepping nor the reference's
    # atomicMin relax (sssp_functor.cuh:64) terminates meaningfully on
    # negative cycles, and the Dijkstra oracle is undefined
    if bool((g.edge_w < 0).any()):
        raise ValueError("SSSP requires non-negative edge weights")
    if delta is None:
        delta = default_delta(g)
    sssp_kernel(g, src, delta, mode=mode)       # warm-up
    sync(dev)
    with Timer() as t:
        dist, preds, it = sssp_kernel(g, src, delta, mode=mode)
        sync(dev)
    dist_np = dist[: g.n].cpu().numpy()
    visited = np.isfinite(dist_np)
    deg = g.out_degree[: g.n].cpu().numpy()
    stats = Stats(elapsed_ms=t.elapsed_ms, search_depth=it,
                  nodes_visited=int(visited.sum()),
                  edges_visited=int(deg[visited].sum()), route=mode)
    return SsspResult(dist=dist_np,
                      preds=preds[: g.n].cpu().numpy() if mark_preds
                      else None, stats=stats)


def _run_planes(graph, src, mark_preds, dev) -> SsspResult:
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
