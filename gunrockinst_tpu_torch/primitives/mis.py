"""Maximal independent set (Luby rounds with static random priorities).

Counterpart of the JAX package's `primitives/mis.py`, after
gunrock/app/mis: the advance with a neighbourhood reduce (the maximum
of the undecided neighbours' priorities, mis_enactor.cuh:234-357) and
the join test (a vertex joins round r iff its priority >= that
maximum, mis_functor.cuh:84-89).  `mis_ids[v]` is the round at which v
was decided: round 0 is a maximal independent set, and each round's set
is independent among the vertices undecided when it began.  `in_set`
is classic Luby with neighbour exclusion, a truly maximal set.

Both are host loops with one host read a round, where the reference
runs one `lax.while_loop`; every scatter is an int32 max (or a count
for "or"), which gives the same bits in any order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import DeviceGraph
from gunrockinst_tpu_torch.ops.advance import neighborhood_reduce
from gunrockinst_tpu_torch.ops.segment import scatter_max, scatter_or
from gunrockinst_tpu_torch.primitives.base import (GraphLike, Stats, Timer,
                                                   device_graph, sync)

INT_MIN = int(np.iinfo(np.int32).min)


def _real(graph: DeviceGraph) -> torch.Tensor:
    return torch.arange(graph.n_pad, device=graph.device) < graph.n


def mis_kernel(graph: DeviceGraph, priorities: torch.Tensor):
    """Returns (mis_ids (n_pad,) int32 round numbers, rounds);
    `priorities` is (n_pad,) int32, INT_MIN in the padding."""
    # the padding counts as decided
    rounds = torch.where(_real(graph), -1, 0).to(torch.int32)

    def edge_fn(s, d, w, eid, und):
        return und[d], priorities[d]

    r = 0
    while r <= graph.n and bool((rounds < 0).any()):
        und = rounds < 0
        # the largest undecided-neighbour priority of each source
        nbmax = neighborhood_reduce(graph, und, edge_fn, state=und,
                                    combine="max",
                                    payload_dtype=torch.int32)
        join = und & (priorities >= nbmax)
        rounds = torch.where(join, r, rounds)
        r += 1
    return rounds, r


def luby_kernel(graph: DeviceGraph, priorities: torch.Tensor):
    """Classic Luby MIS with neighbour exclusion (a maximal independent
    set, unlike the reference's rounds).  Returns (in_set (n_pad,)
    bool, rounds).  States: 0 undecided, 1 in the set, 2 excluded."""
    esrc, edst = graph.edge_src, graph.edge_dst
    n_pad, dev = graph.n_pad, graph.device
    state = torch.where(_real(graph), 0, 2).to(torch.int32)
    r = 0
    while r <= graph.n and bool((state == 0).any()):
        und = state == 0
        cand_e = und[esrc] & und[edst]
        nbmax = scatter_max(
            torch.full((n_pad,), INT_MIN, dtype=torch.int32, device=dev),
            esrc, torch.where(cand_e, priorities[edst], INT_MIN))
        join = und & (priorities >= nbmax)
        # exclude the undecided neighbours of freshly joined vertices
        excl = scatter_or(torch.zeros(n_pad, dtype=torch.bool, device=dev),
                          edst, join[esrc])
        excl = scatter_or(excl, esrc, join[edst])
        state = torch.where(join, 1, torch.where(und & excl, 2, state))
        r += 1
    return state == 1, r


@dataclasses.dataclass
class MisResult:
    mis_ids: np.ndarray       # round each vertex was decided
    in_set: np.ndarray        # bool: member of a maximal independent set
    stats: Stats


def run(graph: GraphLike, seed: int = 0,
        priorities: Optional[np.ndarray] = None,
        device: DeviceLike = None) -> MisResult:
    """Host entry.  Priorities default to a random permutation drawn on
    the host from `np.random.default_rng(seed)` (distinct values, so
    each round's set is independent), as the reference's do.

    `device=None` runs on the CUDA card and raises without one;
    `device="cpu"` runs there."""
    dev = resolve_device(device)
    g = device_graph(graph, dev)
    if priorities is None:
        rng = np.random.default_rng(seed)
        priorities = rng.permutation(g.n).astype(np.int32)
    pr_pad = np.full(g.n_pad, INT_MIN, dtype=np.int32)
    pr_pad[: g.n] = priorities
    pr_dev = torch.from_numpy(pr_pad).to(dev)
    mis_kernel(g, pr_dev)               # warm-up
    sync(dev)
    with Timer() as t:
        rounds, r = mis_kernel(g, pr_dev)
        sync(dev)
    in_set, _ = luby_kernel(g, pr_dev)
    stats = Stats(elapsed_ms=t.elapsed_ms, search_depth=r,
                  nodes_visited=g.n, edges_visited=g.m * r)
    return MisResult(mis_ids=rounds[: g.n].cpu().numpy(),
                     in_set=in_set[: g.n].cpu().numpy(), stats=stats)
