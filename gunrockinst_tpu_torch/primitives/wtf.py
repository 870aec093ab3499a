"""Who-To-Follow (personalized PageRank, circle of trust, personalized
SALSA): the host entry `run`, the operator-layer `wtf_salsa_kernel`
and the value-plane driver `get_wtf_planes`.

Counterpart of the JAX package's `primitives/wtf.py`, with the
reference's exact swap placement (`oracles/wtf.py` states it step by
step):

1. personalized PageRank from src;
2. the circle of trust (CoT): the `cot_size` vertices of highest rank,
   sorted on the host with the ties broken by vertex id;
3. the CoT in-degree: one forward add sweep of the CoT indicator;
4. int(1/alpha) iterations of

       rank_next = cot * (pers_term + (1-alpha) * reverse sweep of
                          ref_curr / max(cot_indeg, 1))
       ref_curr  <- ref_next
       ref_next  = forward sweep of cot * rank_curr / max(outdeg, 1)
       rank_curr <- rank_next

   with pers_term = alpha at src when src has an out-edge (the
   personalization factors out of the reverse sum, as in HITS).

`mode="xla"` (the default) runs phase 1 through `pr.pr_kernel` and
phases 3-4 through `wtf_salsa_kernel` on a `DeviceGraph`, with the
reference's scatter-adds as `ops/segment.py`'s fixed-order sums.
`mode="planes"` runs phase 1 through `pr.get_pr_planes` and every sum
as an ungated f32 add sweep of the value kernel (`ops/value.py`) over
the forward or reverse device CSC, shared with PR, HITS and SALSA.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Dict, Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph
from gunrockinst_tpu_torch.ops.segment import sum_by_dst, sum_by_src
from gunrockinst_tpu_torch.primitives.base import (GraphLike, Stats,
                                                   device_graph, sync)
from gunrockinst_tpu_torch.primitives.bfs_pallas import (add_stepper,
                                                         add_sweep,
                                                         search_graph)
from gunrockinst_tpu_torch.primitives.pr import get_pr_planes, pr_kernel

_planes_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def wtf_salsa_kernel(graph: DeviceGraph, in_cot: torch.Tensor, src: int,
                     alpha: float, salsa_iters: int) -> torch.Tensor:
    """Phases 3 and 4: the CoT in-degree count, then the Auth/Hub loop
    with the reference's swap placement.  `in_cot` is the (n_pad,) bool
    CoT indicator.  Returns the ranks (n_pad,) f32."""
    esrc, edst = graph.edge_src, graph.edge_dst
    so_e = torch.clamp(graph.out_degree.to(torch.float32), min=1.0)[esrc]
    cot_edge = in_cot[esrc]
    cot_indeg = torch.zeros_like(graph.out_degree).index_add_(
        0, edst, cot_edge.to(torch.int32))
    si_e = torch.clamp(cot_indeg.to(torch.float32), min=1.0)[edst]
    is_src_e = (esrc == src).to(torch.float32)
    a = torch.tensor(alpha, dtype=torch.float32, device=graph.device)
    rank_curr = torch.zeros(graph.n_pad, dtype=torch.float32,
                            device=graph.device)
    ref_curr = ref_next = rank_curr
    for _ in range(salsa_iters):
        per_edge = is_src_e * a / so_e + (1.0 - a) * ref_curr[edst] / si_e
        rank_next = sum_by_src(graph, torch.where(cot_edge, per_edge, 0.0))
        ref_curr = ref_next
        ref_next = sum_by_dst(graph, torch.where(
            cot_edge, rank_curr[esrc] / so_e, 0.0))
        rank_curr = rank_next
    return rank_curr


class _WtfPlanes:
    """fn(src, alpha, delta, threshold, max_iter, cot_size) -> (rank (n,)
    f32, cot (cot_size,) int32, ppr (n,) f32, device_ms, phases), ranks
    in input ids; phases holds the wall ms of each phase and the PPR
    iterations."""

    def __init__(self, csr: CsrGraph, device: torch.device):
        g = search_graph(csr, device)
        self.g = g
        self.fwd = add_stepper(g)
        self.rev = add_stepper(g, reverse=True)
        self.pr_fn = get_pr_planes(csr, device)
        self.outdeg = np.diff(csr.row_offsets).astype(np.int64)
        self.inv_so = g.stage(1.0 / np.maximum(self.outdeg, 1))

    def __call__(self, src: int, alpha: float = 0.2, delta: float = 0.85,
                 threshold: float = 0.01, max_iter: int = 50,
                 cot_size: int = 1000
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float,
                            Dict[str, float]]:
        g = self.g
        n = g.n
        salsa_iters = int(1.0 / alpha)
        cot_size = min(cot_size, n)
        sync(g.device)
        t0 = time.perf_counter()
        ppr, ppr_iters, _ = self.pr_fn(delta, threshold, src, max_iter)
        t1 = time.perf_counter()
        order = np.lexsort((np.arange(n), -ppr))
        cot = order[:cot_size].astype(np.int32)
        in_cot = np.zeros(n, np.float32)
        in_cot[cot] = 1.0
        cot_v = g.stage(in_cot)
        pt = np.zeros(n, np.float32)
        if 0 <= src < n:
            pt[src] = alpha * float(self.outdeg[src] > 0)
        pers_term = g.stage(pt)
        a = torch.tensor(alpha, dtype=torch.float32, device=g.device)
        t2 = time.perf_counter()
        inv_si = 1.0 / torch.clamp(add_sweep(self.fwd, cot_v), min=1.0)
        rank_curr = torch.zeros_like(cot_v)
        ref_curr = ref_next = rank_curr
        for _ in range(salsa_iters):
            rank_next = cot_v * (pers_term + (1.0 - a) * add_sweep(
                self.rev, ref_curr * inv_si))
            ref_curr = ref_next
            ref_next = add_sweep(self.fwd, cot_v * rank_curr * self.inv_so)
            rank_curr = rank_next
        sync(g.device)
        t3 = time.perf_counter()
        phases = {"ppr_ms": (t1 - t0) * 1e3, "ppr_iters": int(ppr_iters),
                  "cot_sort_ms": (t2 - t1) * 1e3,
                  "salsa_ms": (t3 - t2) * 1e3}
        return (g.to_input(rank_curr).cpu().numpy(), cot, ppr,
                (t3 - t0) * 1e3, phases)


def get_wtf_planes(csr: CsrGraph, device: DeviceLike = None) -> _WtfPlanes:
    """WTF over PR planes and the value kernel's add sweeps, cached per
    graph and device: fn(src, alpha, delta, threshold, max_iter,
    cot_size) -> (rank, cot, ppr, device_ms, phases)."""
    dev = resolve_device(device)
    per_dev = _planes_cache.setdefault(csr, {})
    hit = per_dev.get(dev)
    if hit is None:
        hit = per_dev[dev] = _WtfPlanes(csr, dev)
    return hit


@dataclasses.dataclass
class WtfResult:
    wtf_ranks: np.ndarray     # final who-to-follow scores
    cot: np.ndarray           # circle-of-trust vertex ids
    ppr_ranks: np.ndarray     # phase-1 personalized PageRank
    stats: Stats
    phases: dict = dataclasses.field(default_factory=dict)


def run(graph: GraphLike, src: int, alpha: float = 0.2,
        delta: float = 0.85, threshold: float = 0.01,
        max_iter: int = 50, cot_size: int = 1000, mode: str = "xla",
        device: DeviceLike = None) -> WtfResult:
    """Host entry (run_wtf analog); mode="planes" needs a host
    CsrGraph.  `device=None` runs on the CUDA card and raises without
    one; `device="cpu"` runs there (the kernel's plain version for
    "planes")."""
    dev = resolve_device(device)
    salsa_iters = int(1.0 / alpha)
    if mode == "xla":
        return _run_xla(graph, src, alpha, delta, threshold, max_iter,
                        cot_size, dev)
    if mode != "planes":
        raise ValueError(f"unknown mode {mode!r}")
    if not isinstance(graph, CsrGraph):
        raise TypeError("mode='planes' needs a host CsrGraph")
    if not 0 <= src < graph.num_nodes:
        raise ValueError(f"source vertex {src} out of range "
                         f"[0, {graph.num_nodes})")
    fn = get_wtf_planes(graph, dev)
    fn(src, alpha, delta, threshold, max_iter, cot_size)   # warm-up
    rank, cot, ppr, device_ms, phases = fn(
        src, alpha, delta, threshold, max_iter, cot_size)
    stats = Stats(elapsed_ms=device_ms, search_depth=salsa_iters,
                  nodes_visited=graph.num_nodes,
                  edges_visited=graph.num_edges * salsa_iters)
    return WtfResult(wtf_ranks=rank, cot=cot, ppr_ranks=ppr, stats=stats,
                     phases=phases)


def _run_xla(graph, src, alpha, delta, threshold, max_iter, cot_size,
             dev) -> WtfResult:
    """PPR through `pr_kernel`, the CoT sort on the host, then
    `wtf_salsa_kernel`; the timed window holds all three."""
    g = device_graph(graph, dev)
    if not 0 <= src < g.n:
        raise ValueError(f"source vertex {src} out of range [0, {g.n})")
    salsa_iters = int(1.0 / alpha)
    cot_size = min(cot_size, g.n)

    def call():
        t0 = time.perf_counter()
        ppr, ppr_iters = pr_kernel(g, delta, threshold, src, max_iter)
        ppr_np = ppr[: g.n].cpu().numpy()
        t1 = time.perf_counter()
        order = np.lexsort((np.arange(g.n), -ppr_np))
        cot = order[:cot_size].astype(np.int32)
        in_cot = np.zeros(g.n_pad, dtype=bool)
        in_cot[cot] = True
        in_cot_t = torch.from_numpy(in_cot).to(dev)
        t2 = time.perf_counter()
        rank = wtf_salsa_kernel(g, in_cot_t, src, alpha, salsa_iters)
        sync(dev)
        t3 = time.perf_counter()
        phases = {"ppr_ms": (t1 - t0) * 1e3, "ppr_iters": int(ppr_iters),
                  "cot_sort_ms": (t2 - t1) * 1e3,
                  "salsa_ms": (t3 - t2) * 1e3}
        return rank, cot, ppr_np, (t3 - t0) * 1e3, phases

    call()                                  # warm-up
    sync(dev)
    rank, cot, ppr_np, device_ms, phases = call()
    stats = Stats(elapsed_ms=device_ms, search_depth=salsa_iters,
                  nodes_visited=g.n, edges_visited=g.m * salsa_iters)
    return WtfResult(wtf_ranks=rank[: g.n].cpu().numpy(), cot=cot,
                     ppr_ranks=ppr_np, stats=stats, phases=phases)
