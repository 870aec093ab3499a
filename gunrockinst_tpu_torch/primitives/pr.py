"""PageRank (Gunrock semantics): the host entry `run` and the value-plane
driver `get_pr_planes`.

Counterpart of the JAX package's `primitives/pr.py`.  This slice of the
port carries `mode="planes"`: each iteration sums rank/deg over the
in-edges with one f32 add sweep of the value kernel (`ops/value.py`,
fixed summation order, so repeated runs give the same bits), then runs
the elementwise update in plain torch:

    contrib = rank / deg where active, else 0
    next    = delta * sums + (1 - delta) * personal   (live vertices)
    active  = |next - rank| > threshold

with the dangling-vertex pre-pass of `oracles.remove_dangling_degrees`.
The XLA scatter mode and the pull-SpMV `mode="pallas"` are not ported
yet and raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.ops.value import ValueStepper
from gunrockinst_tpu_torch.oracles.ranking import remove_dangling_degrees
from gunrockinst_tpu_torch.primitives.base import Stats, Timer, sync
from gunrockinst_tpu_torch.primitives.bfs_pallas import search_graph

_planes_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class _PrPlanes:
    """fn(delta, threshold, src, max_iter) -> (ranks (n,) f32 in input
    ids, iterations, device_ms)."""

    def __init__(self, csr: CsrGraph, device: torch.device):
        g = search_graph(csr, device)   # the device CSC BFS uses too
        self.g = g
        self.stepper = ValueStepper(
            g.stepper.offsets, g.stepper.in_src, mode="add", f32=True,
            use_active=False)
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
        f32 = dict(dtype=torch.float32, device=g.device)
        if src is None or src < 0:
            personal = self.real.to(torch.float32)
        else:
            if not int(src) < g.n:
                raise ValueError(f"personalization source {src} out of "
                                 f"range [0, {g.n})")
            personal = torch.zeros(g.n_words * 32, **f32)
            personal[g.internal(src)] = 1.0
        d = torch.tensor(delta, **f32)
        keep = 1.0 - d                      # f32, as the reference
        thr = torch.tensor(threshold, **f32)
        zero = torch.zeros((), **f32)
        sync(g.device)
        with Timer() as t:
            rank = torch.where(self.real, keep, zero)
            active = self.live
            it = 0
            while it <= max_iter and bool(active.any()):
                # inactive sources contribute 0, so the ungated sum
                # needs no changed map
                contrib = torch.where(active, rank / self.deg, zero)
                sums, _, _ = self.stepper.sweep(contrib.view(torch.int32))
                sums = torch.where(self.live, sums.view(torch.float32),
                                   zero)
                nxt = torch.where(self.real, d * sums + keep * personal,
                                  zero)
                active = (torch.abs(nxt - rank) > thr) & self.real
                rank = nxt
                it += 1
            sync(g.device)
        return g.to_input(rank).cpu().numpy(), it, t.elapsed_ms


def get_pr_planes(csr: CsrGraph, device: DeviceLike = None) -> _PrPlanes:
    """PageRank over the value kernel's add sweep, cached per graph and
    device: fn(delta, threshold, src, max_iter) -> (ranks, iterations,
    device_ms)."""
    dev = resolve_device(device)
    per_dev = _planes_cache.setdefault(csr, {})
    hit = per_dev.get(dev)
    if hit is None:
        hit = per_dev[dev] = _PrPlanes(csr, dev)
    return hit


@dataclasses.dataclass
class PrResult:
    ranks: np.ndarray         # per-vertex rank
    node_ids: np.ndarray      # vertices sorted by descending rank
    sorted_ranks: np.ndarray  # ranks in that order
    stats: Stats


def run(graph: CsrGraph, delta: float = 0.85, threshold: float = 0.01,
        max_iter: int = 50, src: int = -1, normalize: bool = False,
        mode: str = "xla", device: DeviceLike = None) -> PrResult:
    """Host entry (run_pr analog, app/pr/pr_app.cu).  src >= 0 enables
    personalized PageRank; normalize=True rescales ranks to sum 1.

    `device=None` runs on the CUDA card and raises without one;
    `device="cpu"` runs the kernel's plain version."""
    dev = resolve_device(device)
    if mode != "planes":
        item = 8 if mode == "pallas" else 6
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet: ROADMAP.md queue 1, "
            f"item {item}")
    if not isinstance(graph, CsrGraph):
        raise TypeError("mode='planes' needs a host CsrGraph")
    fn = get_pr_planes(graph, dev)
    fn(delta, threshold, src, max_iter)  # warm-up: builds the kernel
    ranks, it, device_ms = fn(delta, threshold, src, max_iter)
    if normalize and ranks.sum() > 0:
        ranks = ranks / ranks.sum()
    n = graph.num_nodes
    order = np.lexsort((np.arange(n), -ranks))
    stats = Stats(elapsed_ms=device_ms, search_depth=int(it),
                  nodes_visited=n, edges_visited=graph.num_edges * int(it))
    return PrResult(ranks=ranks, node_ids=order.astype(np.int32),
                    sorted_ranks=ranks[order], stats=stats)
