"""Direction-optimizing BFS (push/pull switching).

Counterpart of the JAX package's `primitives/dobfs.py`, after
gunrock/app/dobfs (dobfs_enactor.cuh:206-600): each level picks push
(the CSR, from the frontier's out-edges) or pull (the CSC, the
unvisited vertices' in-edges) with the alpha/beta heuristics of Beamer
et al. that the reference hard-codes.  The reference's one
`lax.while_loop` is a host loop here, with one host read a level: the
frontier's size and the direction the switch test chose.

The switch test runs in int32 as the reference's does: alpha and beta
are truncated to int32 first, and `frontier_edges * alpha` wraps as an
int32 product does.  Labels and min-id preds equal plain BFS's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import DeviceGraph
from gunrockinst_tpu_torch.primitives.base import (INF32, GraphLike, Stats,
                                                   Timer, device_graph,
                                                   sync)
from gunrockinst_tpu_torch.primitives.bfs import _dense_level, _start

INT_MAX = INF32


def dobfs_kernel(graph: DeviceGraph, src: int, alpha: int, beta: int,
                 mark_preds: bool = True):
    """Returns (labels (n_pad,), preds (n_pad,), depth, pull_levels);
    `alpha` and `beta` are int32 values."""
    if not graph.has_csc:
        raise ValueError("DOBFS requires a graph built with_csc=True")
    dev = graph.device
    csc = dataclasses.replace(graph, edge_src=graph.csc_src,
                              edge_dst=graph.csc_dst)
    alpha_t = torch.tensor(alpha, dtype=torch.int32, device=dev)
    beta_t = torch.tensor(beta, dtype=torch.int32, device=dev)
    labels, preds, frontier = _start(graph, src)
    depth, pulls = 0, 0
    while depth <= graph.n:
        unvisited = labels == INT_MAX
        frontier_edges = torch.where(frontier, graph.out_degree, 0).sum(
            dtype=torch.int32)
        unvisited_edges = torch.where(unvisited, graph.in_degree, 0).sum(
            dtype=torch.int32)
        frontier_n = frontier.sum(dtype=torch.int32)
        # Beamer heuristic (the reference's alpha/beta switch points,
        # dobfs_enactor.cuh:397,569), int32 products
        use_pull = ((frontier_edges * alpha_t > unvisited_edges)
                    & (frontier_n * beta_t > 1))
        size, pull = torch.stack((frontier_n,
                                  use_pull.to(torch.int32))).tolist()
        if size == 0:
            break
        # pull: the reverse phase (ReverseBFSFunctor,
        # dobfs_functor.cuh:45-213), the same edges in CSC order, so
        # that unvisited v scans its in-neighbours
        pmin, touched, _ = _dense_level(csc if pull else graph, frontier,
                                        labels)
        newf = touched & unvisited
        labels = torch.where(newf, depth + 1, labels)
        if mark_preds:
            preds = torch.where(newf, pmin, preds)
        pulls += pull
        frontier = newf
        depth += 1
    return labels, preds, depth, pulls


@dataclasses.dataclass
class DobfsResult:
    labels: np.ndarray
    preds: Optional[np.ndarray]
    pull_levels: int
    stats: Stats


def run(graph: GraphLike, src: int, alpha: float = 6.0, beta: float = 2.0,
        mark_preds: bool = True, device: DeviceLike = None) -> DobfsResult:
    """Host entry: labels, optional predecessors (min-id tie-break), the
    number of levels that pulled, and the stats block.

    `device=None` runs on the CUDA card and raises without one;
    `device="cpu"` runs there."""
    dev = resolve_device(device)
    g = device_graph(graph, dev)
    if not 0 <= int(src) < g.n:
        raise ValueError(f"source vertex {src} out of range [0, {g.n})")
    # the reference passes jnp.int32(alpha): truncated toward zero
    a, b = int(alpha), int(beta)
    dobfs_kernel(g, src, a, b, mark_preds=mark_preds)     # warm-up
    sync(dev)
    with Timer() as t:
        labels, preds, _, pulls = dobfs_kernel(g, src, a, b,
                                               mark_preds=mark_preds)
        sync(dev)
    labels_np = labels[: g.n].cpu().numpy()
    visited = labels_np != INF32
    deg = g.out_degree[: g.n].cpu().numpy()
    stats = Stats(
        elapsed_ms=t.elapsed_ms,
        search_depth=int(labels_np[visited].max()) if visited.any() else 0,
        nodes_visited=int(visited.sum()),
        edges_visited=int(deg[visited].sum()),
    )
    return DobfsResult(
        labels=labels_np,
        preds=preds[: g.n].cpu().numpy() if mark_preds else None,
        pull_levels=pulls, stats=stats)
