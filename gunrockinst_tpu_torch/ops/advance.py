"""The advance operator: frontier neighbour expansion.

Counterpart of the JAX package's `ops/advance.py`, after the reference's
advance dispatch (oprtr/advance/kernel.cuh:101-765).  Two strategies
with the same semantics:

  * dense sweep (`advance_dense`): an edge-centric pass over all m_pad
    edges: gather frontier membership at the sources, evaluate the
    functor, scatter-combine the payloads at the destinations;
  * sparse gather (`expand_frontier`): the reference's load-balanced
    pipeline (edge_map_partitioned/kernel.cuh:202-559): degrees of the
    frontier vertices, an exclusive scan, and a binary search that maps
    each of e_cap output lanes to its source vertex and edge id.

Backward (pull) advance is `advance_dense(..., reverse=True)`, over
`graph.reverse_view()`.

Functor contract (the vectorized Cond/Apply pair):
    edge_fn(src_ids, dst_ids, w, eids, state) -> (cond_mask, payload)
applied to every edge lane; the payloads of passing edges are combined
at the destination by a deterministic reduction (`ops/segment.py`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from gunrockinst_tpu_torch.graph.csr import DeviceGraph
from gunrockinst_tpu_torch.ops.segment import combine_fn, scatter_or


def _combine(graph: DeviceGraph, dst, cond, payload, combine,
             payload_dtype):
    """(combined (n_pad,), touched (n_pad,) bool) of the passing lanes."""
    touched = scatter_or(torch.zeros(graph.n_pad, dtype=torch.bool,
                                     device=dst.device), dst, cond)
    if payload is None:
        return touched, touched
    return _reduce(graph, dst, cond, payload, combine,
                   payload_dtype), touched


def _reduce(graph: DeviceGraph, ids, cond, payload, combine,
            payload_dtype):
    """The payloads of the passing lanes combined at `ids` into an
    (n_pad,) array of the combine's identity."""
    scatter, ident_of = combine_fn(combine)
    dt = payload_dtype or payload.dtype
    ident = ident_of(dt)
    vals = torch.where(cond, payload.to(dt), ident)
    init = torch.full((graph.n_pad,), ident, dtype=dt, device=ids.device)
    return scatter(init, ids, vals)


def advance_dense(
    graph: DeviceGraph,
    frontier: Optional[torch.Tensor],   # (n_pad,) bool, or None = all
    edge_fn: Callable,
    state=None,
    combine: str = "or",
    payload_dtype: Optional[torch.dtype] = None,
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-edge advance.  Returns (combined (n_pad,), touched (n_pad,)
    bool): `touched[v]` is True iff some passing edge ended at v, and
    `combined[v]` is the reduction of the payloads of the passing edges
    into v (the identity elsewhere)."""
    if reverse:
        graph = graph.reverse_view()
    src, dst, w = graph.edge_src, graph.edge_dst, graph.edge_w
    cond, payload = edge_fn(src, dst, w, None, state)
    if frontier is not None:
        cond = cond & frontier[src]
    return _combine(graph, dst, cond, payload, combine, payload_dtype)


def expand_frontier(
    graph: DeviceGraph,
    frontier_ids: torch.Tensor,    # (cap,) int32, padded with graph.n
    num_frontier,                  # int or scalar int32 tensor
    e_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Load-balanced frontier expansion into per-edge lanes.

    Returns (lane_src, lane_dst, lane_eid, lane_valid), each (e_cap,).
    Lanes beyond the total neighbour count are invalid and point at the
    dummy vertex (eid m_pad-1).  If the frontier's neighbour count
    exceeds e_cap the tail is cut off; callers pick e_cap from
    `degree_sum` first (the queue-sizing analog)."""
    dev = frontier_ids.device
    cap = frontier_ids.shape[0]
    # the reference's gathers clamp an index; the frontier's own ids
    # are in range, so this only keeps the card from asserting
    fids = frontier_ids.clamp(0, graph.n_pad - 1)
    lane_pos = torch.arange(cap, dtype=torch.int32, device=dev)
    valid_src = lane_pos < num_frontier
    deg = torch.where(valid_src, graph.out_degree[fids], 0)
    offs = torch.cumsum(deg, 0, dtype=torch.int32) - deg  # exclusive
    total = deg.sum(dtype=torch.int32)
    lanes = torch.arange(e_cap, dtype=torch.int32, device=dev)
    # binary search: the frontier slot that owns each lane
    # (RelaxPartitionedEdges2's smem BinarySearch,
    # edge_map_partitioned/kernel.cuh:369)
    slot = torch.searchsorted(offs, lanes, right=True, out_int32=True) - 1
    slot = slot.clamp(0, cap - 1)
    lane_valid = lanes < total
    src = torch.where(lane_valid, fids[slot], graph.n)
    eid = graph.row_offsets[src] + (lanes - offs[slot])
    eid = torch.where(lane_valid, eid, graph.m_pad - 1)
    dst = torch.where(lane_valid, graph.edge_dst[eid], graph.n)
    return src, dst, eid, lane_valid


def advance_sparse(
    graph: DeviceGraph,
    frontier_ids: torch.Tensor,
    num_frontier,
    edge_fn: Callable,
    state=None,
    combine: str = "or",
    payload_dtype: Optional[torch.dtype] = None,
    e_cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse advance over a compacted frontier: `advance_dense`'s
    contract at a cost of O(e_cap) instead of O(m_pad)."""
    if e_cap is None:
        e_cap = graph.m_pad
    src, dst, eid, lane_valid = expand_frontier(
        graph, frontier_ids, num_frontier, e_cap)
    w = graph.edge_w[eid]
    cond, payload = edge_fn(src, dst, w, eid, state)
    cond = cond & lane_valid
    return _combine(graph, dst, cond, payload, combine, payload_dtype)


def neighborhood_reduce(
    graph: DeviceGraph,
    frontier: Optional[torch.Tensor],   # (n_pad,) bool, or None
    edge_fn: Callable,
    state=None,
    combine: str = "add",
    payload_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Per-SOURCE reduction over each vertex's outgoing edges (the
    reference's SegReduceCsr after an advance, advance/kernel.cuh:
    733-760).  Returns (n_pad,) combined values, the identity for
    sources with no passing edge."""
    src, dst, w = graph.edge_src, graph.edge_dst, graph.edge_w
    cond, payload = edge_fn(src, dst, w, None, state)
    if frontier is not None:
        cond = cond & frontier[src]
    return _reduce(graph, src, cond, payload, combine, payload_dtype)


def degree_sum(graph: DeviceGraph, frontier: torch.Tensor) -> torch.Tensor:
    """Total out-degree of a frontier bitmap (the scan total the
    reference copies to the host each iteration, advance/kernel.cuh:
    315-317); an int32 scalar on the device."""
    return torch.where(frontier, graph.out_degree, 0).sum(dtype=torch.int32)
