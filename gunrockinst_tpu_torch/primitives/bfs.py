"""Breadth-first search: the host entry `run` and the operator-layer
searches `bfs_dense` and `bfs_sparse`.

Counterpart of the JAX package's `primitives/bfs.py`.  Traversal modes
(the --traversal-mode analog):

  * "dense" (the default): one O(m) edge-centric sweep per level
    (`bfs_dense`);
  * "sparse": a compacted frontier and load-balanced lane expansion,
    with a capacity tier picked per level (`bfs_sparse`);
  * "auto": for a host `CsrGraph` and no depth cap, the step kernel
    ("mega", below); otherwise `bfs_sparse` with the dense sweep for
    levels heavier than m_pad/4;
  * "mega": the step kernel, and the chain kernel for searches deeper
    than 255 levels (`primitives/bfs_pallas.py`);
  * "pallas": the grid-stepped touched sweeps.

The operator-layer searches run on a `DeviceGraph` with one host read a
level (the loop condition), where the reference runs one
`lax.while_loop`.  The reference's atomicCAS child claim
(bfs_functor.cuh:56-58) is a scatter-min of parent ids, so preds take
the least parent id.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph
from gunrockinst_tpu_torch.ops import frontier as fr
from gunrockinst_tpu_torch.ops.advance import advance_sparse, degree_sum
from gunrockinst_tpu_torch.ops.segment import scatter_min, scatter_or
from gunrockinst_tpu_torch.primitives import bfs_pallas
from gunrockinst_tpu_torch.primitives.base import (INF32, GraphLike, Stats,
                                                   device_graph, sync)
from gunrockinst_tpu_torch.utils import trace

INT_MAX = INF32


def _start(graph: DeviceGraph, src: int):
    """labels (INT_MAX but 0 at src), preds (-1), the frontier {src}."""
    dev = graph.device
    labels = torch.full((graph.n_pad,), INT_MAX, dtype=torch.int32,
                        device=dev)
    labels[int(src)] = 0
    preds = torch.full((graph.n_pad,), -1, dtype=torch.int32, device=dev)
    return labels, preds, fr.singleton_bitmap(src, graph.n_pad, dev)


def _dense_level(graph: DeviceGraph, frontier, labels):
    """One dense sweep: (pmin, touched, active) with pmin the least
    frontier parent of each unlabeled vertex the frontier reaches."""
    esrc, edst = graph.edge_src, graph.edge_dst
    active = frontier[esrc]
    cand = active & (labels[edst] == INT_MAX)
    empty = torch.zeros(graph.n_pad, dtype=torch.bool, device=esrc.device)
    touched = scatter_or(empty, edst, cand)
    pmin = scatter_min(torch.full((graph.n_pad,), INT_MAX,
                                  dtype=torch.int32, device=esrc.device),
                       edst, torch.where(cand, esrc, INT_MAX))
    return pmin, touched, active


def bfs_dense(graph: DeviceGraph, src: int, mark_preds: bool = True,
              max_depth: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Whole-search BFS as a host loop of dense sweeps.

    Returns (labels (n_pad,), preds (n_pad,), depth, total_queued).
    labels[v] = INT_MAX if unreachable; preds = -1 where undefined (and
    everywhere if mark_preds=False)."""
    limit = max_depth if max_depth is not None else graph.n + 1
    labels, preds, frontier = _start(graph, src)
    depth, queued = 0, torch.ones((), dtype=torch.int32,
                                  device=graph.device)
    while depth < limit and bool(frontier.any()):
        pmin, touched, active = _dense_level(graph, frontier, labels)
        newf = touched & (labels == INT_MAX)
        labels = torch.where(newf, depth + 1, labels)
        if mark_preds:
            preds = torch.where(newf, pmin, preds)
        # total_queued counts expanded frontier out-edges (the
        # reference's pre-filter enqueues, app/bfs/bfs_app.cu:115)
        queued = queued + active.sum(dtype=torch.int32)
        frontier = newf
        depth += 1
    return labels, preds, depth, int(queued)


def capacity_tiers(m_pad: int):
    """Lane capacities 4^k * 512, capped by m_pad (the light/heavy
    split)."""
    tiers = []
    t = min(512, m_pad)
    while t < m_pad:
        tiers.append(t)
        t *= 4
    tiers.append(m_pad)
    return tiers


def bfs_sparse(graph: DeviceGraph, src: int, mark_preds: bool = True,
               max_depth: Optional[int] = None, mode: str = "auto"
               ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """BFS with compacted frontiers and tiered lane expansion.

    Each level compacts the frontier bitmap to an id list and expands
    it with the least capacity tier that holds the frontier's total
    out-degree.  mode="auto" takes the dense sweep for tiers above
    m_pad/4 instead; that sweep reads the frontier back from the id
    list padded with the dummy vertex, as the reference's does, so the
    dummy joins the frontier there and the search depth counts the
    same levels.  Same return contract as `bfs_dense`."""
    n_pad, m_pad = graph.n_pad, graph.m_pad
    limit = max_depth if max_depth is not None else graph.n + 1
    tiers = capacity_tiers(m_pad)
    dense = [mode == "auto" and c > m_pad // 4 for c in tiers]
    v_cap = n_pad
    lanes = torch.arange(v_cap, dtype=torch.int32, device=graph.device)

    def edge_fn(s, d, w, eid, labels):
        return labels[d] == INT_MAX, s

    labels, preds, frontier = _start(graph, src)
    depth, queued = 0, 1
    while depth < limit and bool(frontier.any()):
        ids, num = fr.compact(frontier, v_cap, graph.n)
        need = int(degree_sum(graph, frontier))
        tier = min(int(np.searchsorted(tiers, need, side="left")),
                   len(tiers) - 1)
        if dense[tier]:
            full = fr.bitmap_from_ids(torch.where(lanes < num, ids,
                                                  graph.n), n_pad)
            pmin, touched, _ = _dense_level(graph, full, labels)
        else:
            pmin, touched = advance_sparse(
                graph, ids, num, edge_fn, state=labels, combine="min",
                payload_dtype=torch.int32, e_cap=tiers[tier])
        newf = touched & (labels == INT_MAX)
        labels = torch.where(newf, depth + 1, labels)
        if mark_preds:
            preds = torch.where(newf, pmin, preds)
        # expanded out-edges of the frontier (see bfs_dense)
        queued += need
        frontier = newf
        depth += 1
    return labels, preds, depth, queued


@dataclasses.dataclass
class BfsResult:
    labels: np.ndarray
    preds: Optional[np.ndarray]
    stats: Stats


def run(graph: GraphLike, src: int, mark_preds: bool = True,
        traversal_mode: str = "dense",
        max_depth: Optional[int] = None,
        device: DeviceLike = None) -> BfsResult:
    """Host entry (run_bfs analog, app/bfs/bfs_app.cu:241): labels,
    optional predecessors (min-id tie-break) and the stats block.

    `device=None` runs on the CUDA card and raises without one;
    `device="cpu"` runs there (the kernels' plain versions for "mega"
    and "pallas").  The call is traced under `gt.bfs.run`
    (`utils/trace.py`)."""
    with trace.call("gt.bfs.run", "bfs", src) as root:
        res = _run(graph, src, mark_preds, traversal_mode, max_depth,
                   device)
        root.set_route(res.stats.route)
        return res


def _run(graph, src, mark_preds, traversal_mode, max_depth, device):
    dev = resolve_device(device)
    if (traversal_mode == "auto" and max_depth is None
            and isinstance(graph, CsrGraph)):
        traversal_mode = "mega"
    if traversal_mode in ("mega", "pallas"):
        return _run_kernels(graph, src, mark_preds, traversal_mode, dev)
    fn = {"dense": bfs_dense,
          "sparse": lambda *a, **k: bfs_sparse(*a, mode="sparse", **k),
          "auto": lambda *a, **k: bfs_sparse(*a, mode="auto", **k),
          }.get(traversal_mode)
    if fn is None:
        raise ValueError(f"unknown traversal_mode {traversal_mode!r}")
    g = device_graph(graph, dev)
    with trace.span("gt.entry.check"):
        if not 0 <= int(src) < g.n:
            raise ValueError(f"source vertex {src} out of range [0, {g.n})")
    # warm-up, then the timed run (the reference times the warm run)
    with trace.span("gt.entry.warmup"):
        fn(g, src, mark_preds=mark_preds, max_depth=max_depth)
        sync(dev)
    with trace.span("gt.entry.search") as t:
        labels, preds, _, queued = fn(g, src, mark_preds=mark_preds,
                                      max_depth=max_depth)
        sync(dev)
    with trace.span("gt.entry.extract"):
        labels_np = trace.d2h(labels[: g.n]).cpu().numpy()
    preds_np = None
    if mark_preds:
        with trace.span("gt.entry.preds"):
            preds_np = trace.d2h(preds[: g.n]).cpu().numpy()
    with trace.span("gt.entry.stats"):
        visited = labels_np != INF32
        deg = trace.d2h(g.out_degree[: g.n]).cpu().numpy()
        stats = Stats(
            elapsed_ms=t.elapsed_ms,
            search_depth=(int(labels_np[visited].max()) if visited.any()
                          else 0),
            nodes_visited=int(visited.sum()),
            edges_visited=int(deg[visited].sum()),
            total_queued=queued,
            route=traversal_mode,
        )
    return BfsResult(labels=labels_np, preds=preds_np, stats=stats)


def _run_kernels(graph, src, mark_preds, traversal_mode, dev):
    """The kernel routes: "mega" (step kernel, chain kernel for deep
    searches) and "pallas" (grid-stepped touched sweeps)."""
    with trace.span("gt.entry.check"):
        if not isinstance(graph, CsrGraph):
            raise TypeError(f"traversal_mode={traversal_mode!r} needs a "
                            "host CsrGraph")
        if not 0 <= int(src) < graph.num_nodes:
            raise ValueError(f"source vertex {src} out of range "
                             f"[0, {graph.num_nodes})")
    variant = "mega" if traversal_mode == "mega" else "fused"
    # warm-up: the first call builds and loads the kernels
    with trace.span("gt.entry.warmup"):
        bfs_pallas.bfs_pallas_fused(graph, src, mark_preds=False,
                                    variant=variant, device=dev)
    # timed: device traversal only (reference times Enact(); Extract
    # runs outside the GpuTimer, tests/bfs/test_bfs.cu:402-431)
    labels_np, preds_np, _, device_ms = bfs_pallas.bfs_pallas_fused(
        graph, src, mark_preds=mark_preds, variant=variant, device=dev)
    with trace.span("gt.entry.stats"):
        visited = labels_np != INF32
        deg = np.diff(graph.row_offsets)
        edges = int(deg[visited].sum())
        stats = Stats(
            elapsed_ms=device_ms,
            search_depth=(int(labels_np[visited].max())
                          if visited.any() else 0),
            nodes_visited=int(visited.sum()),
            edges_visited=edges,
            # every visited vertex's out-edges are scanned once and
            # dedup is exact (bit OR): enqueues equal useful edge visits
            total_queued=edges,
            route=bfs_pallas.get_fused_bfs(graph, variant == "mega",
                                           dev).route,
        )
    return BfsResult(labels=labels_np, preds=preds_np, stats=stats)
