"""Deterministic scatter-combine primitives.

Counterpart of the JAX package's `ops/segment.py`: the reference's
atomics (atomicCAS claim in bfs_functor.cuh:56, atomicMin in
sssp_functor.cuh:64, atomicAdd in pr_functor.cuh:67) become reductions
that give the same bits on every run.

Every scatter takes a destination-sized `init` and per-item
``(ids, vals)``; ids outside ``[-len(init), len(init))`` are dropped,
as the reference's ``mode="drop"`` drops them, and negative ones count
from the end.  PyTorch raises on such an index
(on the card, a device-side assert that ends the process), so they are
masked to an identity update first.

- min, max and or are order-free: `index_reduce_` (int32 ids) and an
  integer count for or.
- Integer add is order-free: `index_add_`.
- Float add is not: the card's `index_add_` adds with atomics in no
  fixed order.  A float scatter-add sorts the items stably by id and
  sums each id's run in a fixed order (`segment_sum`), so that a
  destination adds its items in the order they came, the order a
  sequential scatter adds them in.  `sum_by_dst` and `sum_by_src` do
  the same for one value per edge of a `DeviceGraph` without a sort:
  the CSR is already grouped by source, and the CSC (a stable sort by
  destination, reached through `csc_edge_id`) keeps each destination's
  sources ascending.
"""

from __future__ import annotations

import torch

from gunrockinst_tpu_torch.graph.csr import DeviceGraph


def _masked(init: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor,
            ident):
    """(ids, vals) with a negative id counted from the end (NumPy's
    rule, which the reference's scatters keep) and every id still
    outside [0, len(init)) sent to 0 with the identity as its value:
    the reference's drop."""
    size = init.shape[0]
    ids = torch.where(ids < 0, ids + size, ids)
    ok = (ids >= 0) & (ids < size)
    ids = torch.where(ok, ids, 0).to(torch.int32)
    vals = torch.where(ok, vals.to(init.dtype), ident)
    return ids, vals


def _identity(name: str, dtype: torch.dtype):
    if name == "min":
        return (torch.iinfo(dtype).max if not dtype.is_floating_point
                else float("inf"))
    if name == "max":
        return (torch.iinfo(dtype).min if not dtype.is_floating_point
                else float("-inf"))
    return False if dtype == torch.bool else 0


def scatter_min(init, ids, vals):
    ids, vals = _masked(init, ids, vals, _identity("min", init.dtype))
    return init.clone().index_reduce_(0, ids, vals, "amin")


def scatter_max(init, ids, vals):
    ids, vals = _masked(init, ids, vals, _identity("max", init.dtype))
    return init.clone().index_reduce_(0, ids, vals, "amax")


def scatter_or(init, ids, flags):
    """Boolean accumulate (the visited-bitmask set); on a non-bool
    `init` it is the reference's max."""
    if init.dtype != torch.bool:
        return scatter_max(init, ids, flags)
    ids, flags = _masked(init, ids, flags, False)
    hits = torch.zeros(init.shape, dtype=torch.int32, device=init.device)
    hits.index_add_(0, ids, flags.to(torch.int32))
    return init | (hits > 0)


def segment_sum(vals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sums of consecutive runs of `vals` along its last dimension, run
    i holding `lengths[i]` items (the lengths add up to that
    dimension), each run added in a fixed order; empty runs give 0.  A
    (K, E) batch is summed as one (K*E,) row with the lengths repeated
    K times."""
    lengths = lengths.to(torch.int64)
    if vals.dim() == 1:
        return torch.segment_reduce(vals, "sum", lengths=lengths,
                                    unsafe=True)
    k = vals.shape[0]
    out = torch.segment_reduce(vals.reshape(-1), "sum",
                               lengths=lengths.repeat(k), unsafe=True)
    return out.reshape(k, -1)


class SlotSums:
    """Float sums of per-item values at fixed slot ids in [0, size),
    each slot's items added in the order they came, as `scatter_add`
    adds them; the stable sort by id is made once, so a call is a
    gather and a `segment_sum` along the values' last dimension (a
    (K, E) batch gives (K, size))."""

    def __init__(self, ids: torch.Tensor, size: int):
        self.order = torch.argsort(ids, stable=True)
        self.lengths = torch.bincount(ids, minlength=size)

    def __call__(self, vals: torch.Tensor) -> torch.Tensor:
        return segment_sum(vals.index_select(-1, self.order), self.lengths)


def _sorted_sum(ids: torch.Tensor, vals: torch.Tensor,
                size: int) -> torch.Tensor:
    """(..., size) sums of vals[..., i] at ids[i] (ids in [0, size))."""
    return SlotSums(ids, size)(vals)


def scatter_add(init, ids, vals):
    """init + the sum of vals at each id.  Integer sums are order-free;
    float sums add each id's items in the order they came."""
    ids, vals = _masked(init, ids, vals, 0)
    if not init.dtype.is_floating_point:
        return init.clone().index_add_(0, ids, vals)
    return init + _sorted_sum(ids, vals, init.shape[0])


def _lengths(degree: torch.Tensor, graph: DeviceGraph) -> torch.Tensor:
    """Per-vertex edge counts with the padding edges at the dummy."""
    lengths = degree.to(torch.int64, copy=True)
    lengths[graph.n] = graph.m_pad - graph.m
    return lengths


def sum_by_src(graph: DeviceGraph, vals: torch.Tensor) -> torch.Tensor:
    """(..., m_pad) values in CSR edge order -> (..., n_pad) float sums
    at each edge's source: `scatter_add` at `edge_src` from zeros."""
    return segment_sum(vals, _lengths(graph.out_degree, graph))


def sum_by_dst(graph: DeviceGraph, vals: torch.Tensor) -> torch.Tensor:
    """(..., m_pad) values in CSR edge order -> (..., n_pad) float sums
    at each edge's destination: `scatter_add` at `edge_dst` from zeros,
    through the CSC when the graph has `csc_edge_id` (a `reverse_view`
    has not), else through a stable sort."""
    if graph.csc_edge_id is None:
        return _sorted_sum(graph.edge_dst, vals, graph.n_pad)
    # the CSC's padding slots all name one padding edge: take the
    # padding edges' own values there, in CSR order
    m = graph.m
    ordered = torch.cat((vals.index_select(-1, graph.csc_edge_id[:m]),
                         vals[..., m:]), dim=-1)
    return segment_sum(ordered, _lengths(graph.in_degree, graph))


_COMBINES = {
    "min": scatter_min,
    "max": scatter_max,
    "add": scatter_add,
    "or": scatter_or,
}


def combine_fn(name: str):
    """Returns (scatter, identity_for_dtype) for a combine name.

    The combine set mirrors the reference's REDUCE_OP enum
    (oprtr/advance/kernel_policy.cuh:43-81: NONE/PLUS/MULTIPLIES/
    MAXIMUM/MINIMUM) minus MULTIPLIES (unused by any reference
    primitive) plus OR (bitmap union)."""
    return _COMBINES[name], lambda dt: _identity(name, dt)
