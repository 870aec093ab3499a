"""Top-K degree centrality.

Counterpart of the JAX package's `primitives/topk.py`, after
gunrock/app/topk (topk_enactor.cuh:245-285): degree centrality =
in-degree + out-degree, sorted descending with ties broken by ascending
vertex id.  The reference's two-key sort over all n_pad slots becomes a
stable sort of the negated centralities: the slots start in id order,
so equal centralities keep it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import DeviceGraph
from gunrockinst_tpu_torch.primitives.base import (GraphLike, Stats, Timer,
                                                   device_graph, sync)


def topk_kernel(graph: DeviceGraph):
    """Returns (sorted vertex ids, centralities, in_deg, out_deg) over
    all n_pad slots (padding sorts last: centrality 0, id large)."""
    out_deg = graph.out_degree
    if graph.in_degree is not None:
        in_deg = graph.in_degree
    else:
        # a graph built without the CSC: count the real edges into each
        # vertex (the padding edges start at the dummy)
        in_deg = torch.zeros_like(out_deg).index_add_(
            0, graph.edge_dst, (graph.edge_src != graph.n).to(torch.int32))
    cent = in_deg + out_deg
    ids = torch.sort(-cent, stable=True).indices
    return ids.to(torch.int32), cent[ids], in_deg[ids], out_deg[ids]


@dataclasses.dataclass
class TopkResult:
    node_ids: np.ndarray
    centralities: np.ndarray
    in_degrees: np.ndarray
    out_degrees: np.ndarray
    stats: Stats


def run(graph: GraphLike, k: int, device: DeviceLike = None) -> TopkResult:
    """Host entry (run_topk analog, app/topk/topk_app.cu): the k
    vertices of highest degree centrality.

    `device=None` runs on the CUDA card and raises without one;
    `device="cpu"` runs there."""
    dev = resolve_device(device)
    g = device_graph(graph, dev)
    k = min(k, g.n)
    topk_kernel(g)                      # warm-up
    sync(dev)
    with Timer() as t:
        ids, cent, ind, outd = topk_kernel(g)
        sync(dev)
    stats = Stats(elapsed_ms=t.elapsed_ms, nodes_visited=g.n,
                  edges_visited=g.m)
    return TopkResult(
        node_ids=ids[:k].cpu().numpy(),
        centralities=cent[:k].cpu().numpy(),
        in_degrees=ind[:k].cpu().numpy(),
        out_degrees=outd[:k].cpu().numpy(),
        stats=stats,
    )
