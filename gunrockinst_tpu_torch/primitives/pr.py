"""PageRank (Gunrock semantics): the host entry `run`, the operator-layer
`pr_kernel`, the value-plane driver `get_pr_planes` and the pull-SpMV
driver `pr_pallas`.

Counterpart of the JAX package's `primitives/pr.py`.  Each iteration
sums rank/deg over the in-edges (fixed summation order, so repeated
runs give the same bits), then runs the elementwise update:

    contrib = rank / deg where active, else 0
    next    = delta * sums + (1 - delta) * personal   (live vertices)
    active  = |next - rank| > threshold

with the dangling-vertex pre-pass of `oracles.remove_dangling_degrees`.
`mode="xla"` (the default, `pr_kernel`) runs it on a `DeviceGraph`
with the reference's per-edge live guard and the float sums of
`ops/segment.py::sum_by_dst` (the reference's atomicAdd,
pr_functor.cuh:67); `mode="planes"` sweeps the relabeled device CSC
that BFS holds (`ops/value.py`); `mode="pallas"` sweeps the input
graph's own CSC, unrelabeled, through `ops/spmv.py::SpmvSweeper` (the
reference's pull-SpMV route).  All loop on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph, derived
from gunrockinst_tpu_torch.ops.segment import sum_by_dst
from gunrockinst_tpu_torch.ops.spmv import SpmvSweeper
from gunrockinst_tpu_torch.oracles.ranking import remove_dangling_degrees
from gunrockinst_tpu_torch.primitives.base import (GraphLike, Stats, Timer,
                                                   device_graph, sync)
from gunrockinst_tpu_torch.primitives.search_graph import (add_stepper,
                                                           add_sweep,
                                                           search_graph)


def effective_degrees(graph: DeviceGraph) -> torch.Tensor:
    """The dangling-removal fixpoint (pr_enactor.cuh:247-300): a
    vertex's effective out-degree counts only the edges to vertices
    that still have out-edges themselves.  (n_pad,) int32."""
    esrc, edst = graph.edge_src, graph.edge_dst
    deg = graph.out_degree
    while True:
        live = (deg[edst] > 0) & (deg[esrc] > 0)
        newdeg = torch.zeros_like(deg).index_add_(0, esrc,
                                                  live.to(deg.dtype))
        newdeg = torch.where(deg > 0, newdeg, 0)
        if not bool((newdeg != deg).any()):
            return newdeg
        deg = newdeg


def pr_kernel(graph: DeviceGraph, delta: float, threshold: float,
              src: int = -1, max_iter: int = 50
              ) -> Tuple[torch.Tensor, int]:
    """Returns (rank (n_pad,) f32, iterations): the reference's update
    rule, iterated while some vertex moved more than `threshold` and
    at most max_iter + 1 times; src >= 0 personalizes."""
    dev = graph.device
    f32 = dict(dtype=torch.float32, device=dev)
    esrc, edst = graph.edge_src, graph.edge_dst
    deg = effective_degrees(graph)
    degf = torch.clamp(deg.to(torch.float32), min=1.0)
    vids = torch.arange(graph.n_pad, dtype=torch.int32, device=dev)
    real = vids < graph.n
    personal = (real if src < 0 else vids == src).to(torch.float32)
    d = torch.tensor(delta, **f32)
    keep = 1.0 - d
    thr = torch.tensor(threshold, **f32)
    rank = torch.where(real, keep, 0.0)
    active = (deg > 0) & real
    ok = (deg[esrc] > 0) & (deg[edst] > 0)
    it = 0
    while it <= max_iter and bool(active.any()):
        contrib = torch.where(active, rank / degf, 0.0)
        nxt = sum_by_dst(graph, torch.where(ok, contrib[esrc], 0.0))
        nxt = torch.where(real, d * nxt + keep * personal, 0.0)
        active = (torch.abs(nxt - rank) > thr) & real
        rank = nxt
        it += 1
    return rank, it


def _iterate(sweep, deg1: torch.Tensor, live: torch.Tensor,
             real: torch.Tensor, personal: torch.Tensor, delta: float,
             threshold: float, max_iter: int
             ) -> Tuple[torch.Tensor, int, float]:
    """The PageRank loop on the host over (n_pad,) state in the ids of
    `sweep` (f32 contributions -> f32 sums over in-edges): deg1 the
    dangling-pruned out-degrees clamped to 1, live where they are
    nonzero, real the vertices that are not padding.  Returns (ranks,
    iterations, wall ms ended by a device sync)."""
    dev = deg1.device
    f32 = dict(dtype=torch.float32, device=dev)
    d = torch.tensor(delta, **f32)
    keep = 1.0 - d                      # f32, as the reference
    thr = torch.tensor(threshold, **f32)
    zero = torch.zeros((), **f32)
    sync(dev)
    with Timer() as t:
        rank = torch.where(real, keep, zero)
        active = live
        it = 0
        while it <= max_iter and bool(active.any()):
            # inactive sources contribute 0, so the ungated sum needs no
            # changed map
            contrib = torch.where(active, rank / deg1, zero)
            sums = torch.where(live, sweep(contrib), zero)
            nxt = torch.where(real, d * sums + keep * personal, zero)
            active = (torch.abs(nxt - rank) > thr) & real
            rank = nxt
            it += 1
        sync(dev)
    return rank, it, t.elapsed_ms


def _personal(src, n: int, real: torch.Tensor, at) -> torch.Tensor:
    """The personalization vector: 1 on every real vertex for src < 0,
    else 1 at index `at(src)` alone."""
    if src is None or src < 0:
        return real.to(torch.float32)
    if not int(src) < n:
        raise ValueError(f"personalization source {src} out of range "
                         f"[0, {n})")
    personal = torch.zeros(real.shape, dtype=torch.float32,
                           device=real.device)
    personal[at(int(src))] = 1.0
    return personal


class _PrPlanes:
    """fn(delta, threshold, src, max_iter) -> (ranks (n,) f32 in input
    ids, iterations, device_ms)."""

    def __init__(self, csr: CsrGraph, device: torch.device):
        g = search_graph(csr, device)   # the device CSC BFS uses too
        self.g = g
        self.stepper = add_stepper(g)
        deg = torch.from_numpy(
            remove_dangling_degrees(csr).astype(np.float32)).to(device)
        self.deg = g.to_internal(torch.clamp(deg, min=1.0))
        self.live = g.to_internal(deg > 0, False)
        self.real = g.to_internal(torch.ones(g.n, dtype=torch.bool,
                                             device=device), False)

    def __call__(self, delta: float = 0.85, threshold: float = 0.01,
                 src: int = -1, max_iter: int = 50
                 ) -> Tuple[np.ndarray, int, float]:
        g = self.g
        personal = _personal(src, g.n, self.real, g.internal)
        rank, it, ms = _iterate(
            lambda c: add_sweep(self.stepper, c), self.deg, self.live,
            self.real, personal, delta, threshold, max_iter)
        return g.to_input(rank).cpu().numpy(), it, ms


def get_pr_planes(csr: CsrGraph, device: DeviceLike = None) -> _PrPlanes:
    """PageRank over the value kernel's add sweep, cached per graph and
    device: fn(delta, threshold, src, max_iter) -> (ranks, iterations,
    device_ms)."""
    dev = resolve_device(device)
    return derived(csr, ("pr_planes", dev), lambda: _PrPlanes(csr, dev))


def get_spmv_sweeper(csr: CsrGraph, device: DeviceLike = None
                     ) -> SpmvSweeper:
    """The pull-SpMV over `csr`'s own CSC (no relabeling, as the
    reference's `get_spmv_sweeper`, pr.py:90), cached per graph and
    device.  It plans nothing and so fits at any size: the reference's
    SMEM budget check has no counterpart on the card."""
    dev = resolve_device(device)

    def build():
        csc = csr.transposed()
        return SpmvSweeper(*(
            torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
            for a in (csc.row_offsets, csc.col_indices)))
    return derived(csr, ("spmv_sweeper", dev), build)


def pr_pallas(csr: CsrGraph, delta: float = 0.85, threshold: float = 0.01,
              max_iter: int = 50, src: int = -1, device: DeviceLike = None
              ) -> Tuple[np.ndarray, int, float]:
    """PageRank with the pull-SpMV as its push (the reference's
    `pr_pallas`, pr.py:118): the update rule of `get_pr_planes` in input
    ids, one sweep per iteration from a host loop.  Returns (ranks (n,)
    f32, iterations, wall ms of the loop, ended by a device sync)."""
    dev = resolve_device(device)
    sweeper = get_spmv_sweeper(csr, dev)
    n, n_pad = csr.num_nodes, sweeper.n_pad
    deg = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    deg[:n] = torch.from_numpy(
        remove_dangling_degrees(csr).astype(np.float32))
    real = torch.arange(n_pad, device=dev) < n
    personal = _personal(src, n, real, int)
    rank, it, ms = _iterate(sweeper, torch.clamp(deg, min=1.0),
                            (deg > 0) & real, real, personal, delta,
                            threshold, max_iter)
    return rank[:n].cpu().numpy(), it, ms


@dataclasses.dataclass
class PrResult:
    ranks: np.ndarray         # per-vertex rank
    node_ids: np.ndarray      # vertices sorted by descending rank
    sorted_ranks: np.ndarray  # ranks in that order
    stats: Stats


def run(graph: GraphLike, delta: float = 0.85, threshold: float = 0.01,
        max_iter: int = 50, src: int = -1, normalize: bool = False,
        mode: str = "xla", device: DeviceLike = None) -> PrResult:
    """Host entry (run_pr analog, app/pr/pr_app.cu).  src >= 0 enables
    personalized PageRank; normalize=True rescales ranks to sum 1.
    mode "xla" runs `pr_kernel` on a DeviceGraph; "planes" sweeps the
    relabeled device CSC (`get_pr_planes`) and "pallas" the input
    graph's own CSC (`pr_pallas`), both from a host CsrGraph.

    `device=None` runs on the CUDA card and raises without one;
    `device="cpu"` runs there (the kernel's plain version for "planes"
    and "pallas")."""
    dev = resolve_device(device)
    if mode == "xla":
        g = device_graph(graph, dev)

        def fn(delta, threshold, src, max_iter):
            sync(dev)
            with Timer() as t:
                rank, it = pr_kernel(g, delta, threshold, src, max_iter)
                sync(dev)
            return rank[: g.n].cpu().numpy(), it, t.elapsed_ms
        n, m = g.n, g.m
    elif mode in ("planes", "pallas"):
        if not isinstance(graph, CsrGraph):
            raise TypeError(f"mode={mode!r} needs a host CsrGraph")
        if mode == "planes":
            fn = get_pr_planes(graph, dev)
        else:
            def fn(delta, threshold, src, max_iter):
                return pr_pallas(graph, delta, threshold, max_iter, src,
                                 dev)
        n, m = graph.num_nodes, graph.num_edges
    else:
        raise ValueError(f"unknown mode {mode!r}")
    fn(delta, threshold, src, max_iter)  # warm-up: builds the kernel
    ranks, it, device_ms = fn(delta, threshold, src, max_iter)
    if normalize and ranks.sum() > 0:
        ranks = ranks / ranks.sum()
    order = np.lexsort((np.arange(n), -ranks))
    stats = Stats(elapsed_ms=device_ms, search_depth=int(it),
                  nodes_visited=n, edges_visited=m * int(it))
    return PrResult(ranks=ranks, node_ids=order.astype(np.int32),
                    sorted_ranks=ranks[order], stats=stats)
