"""Betweenness centrality, single source (Brandes): the host entry `run`
and the value-plane driver `get_bc_planes`.

Counterpart of the JAX package's `primitives/bc.py` `mode="planes"`.

- Forward: one gated f32 add sweep of the value kernel per level over
  the forward device CSC, gated on the frontier's words:
  contrib[v] = sum of sigma over v's frontier in-neighbours.  The
  nonzero entries of contrib are the touched vertices, so the next
  frontier is touched & ~visited, and sigma grows by contrib there.
  The level words are kept in a host list.
- Backward, deepest level first: one gated add sweep over the reverse
  CSC (`SearchGraph.reverse`), gated on the child level's words, sums
  t[u] = (1 + delta[v]) / sigma[v] over u's out-neighbours v at level
  d + 1; then delta[u] += sigma[u] * t[u] for u at level d
  (BackwardFunctor, gunrock/app/bc/bc_functor.cuh:147-253).

bc_values = delta / 2, with delta 0 at the source.  Labels are
recovered from the level words, in input ids: 0 at the source, INF32
where the search never reached.  The reference's `level_cap` and its
rerun with a larger cap exist for a static-shape loop; the host loop
here keeps one word map per level and runs to the search's end at any
depth.  All-sources BC (`src=-1`) and the XLA mode are not ported yet
and raise.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.ops.words import (host_unpack_words, pack_bitmap,
                                             unpack_bitmap)
from gunrockinst_tpu_torch.primitives.base import INF32, Stats, Timer, sync
from gunrockinst_tpu_torch.primitives.bfs_pallas import (add_stepper,
                                                         add_sweep,
                                                         search_graph)

_planes_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class _BcPlanes:
    """fn(src) -> (delta (n,) f32, sigma (n,) f32, labels (n,) int32, all
    in input ids, depth, device_ms)."""

    def __init__(self, csr: CsrGraph, device: torch.device):
        g = search_graph(csr, device)
        self.g = g
        self.fwd = add_stepper(g, gated=True)
        self.rev = add_stepper(g, reverse=True, gated=True)

    def __call__(self, src: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, float]:
        g = self.g
        n_pad = g.n_words * 32
        psrc = g.internal(src)
        fw = g.start(psrc)
        x = torch.zeros(n_pad, dtype=torch.float32, device=g.device)
        x[psrc] = 1.0
        sync(g.device)
        with Timer() as t:
            # forward: sigma and the level words
            sigma, vw, levels = x, fw, [fw]
            while True:
                contrib = add_sweep(self.fwd, x, fw)
                fw = pack_bitmap(contrib != 0, g.n_words) & ~vw
                if not bool(fw.any()):
                    break
                x = contrib * unpack_bitmap(fw, n_pad)
                sigma = sigma + x
                vw = vw | fw
                levels.append(fw)
            depth = len(levels) - 1
            # backward: delta, deepest level first
            inv_sigma = torch.where(sigma > 0, 1.0 / torch.where(
                sigma > 0, sigma, 1.0), 0.0)
            delta = torch.zeros_like(sigma)
            for d in range(depth, 0, -1):
                cw = levels[d]
                y = unpack_bitmap(cw, n_pad) * (1.0 + delta) * inv_sigma
                t_sum = add_sweep(self.rev, y, cw)
                delta = delta + (unpack_bitmap(levels[d - 1], n_pad)
                                 * sigma * t_sum)
            sync(g.device)
        # labels from the level words, outside the timed window
        labels = np.full(g.n, INF32, np.int32)
        for d, words in enumerate(levels):
            labels[host_unpack_words(words.cpu().numpy(), g.n)
                   .astype(bool)] = d
        if g.perm is not None:
            labels = labels[g.perm]
        labels[int(src)] = 0
        delta_np = g.to_input(delta).cpu().numpy()
        delta_np[int(src)] = 0.0
        return (delta_np, g.to_input(sigma).cpu().numpy(), labels, depth,
                t.elapsed_ms)


def get_bc_planes(csr: CsrGraph, device: DeviceLike = None) -> _BcPlanes:
    """Single-source Brandes over the value kernel's gated add sweeps,
    cached per graph and device: fn(src) -> (delta, sigma, labels,
    depth, device_ms)."""
    dev = resolve_device(device)
    per_dev = _planes_cache.setdefault(csr, {})
    hit = per_dev.get(dev)
    if hit is None:
        hit = per_dev[dev] = _BcPlanes(csr, dev)
    return hit


@dataclasses.dataclass
class BcResult:
    bc_values: np.ndarray
    sigmas: np.ndarray
    labels: np.ndarray
    stats: Stats


def run(graph: CsrGraph, src: int = -1, batch=None, mode: str = "xla",
        device: DeviceLike = None) -> BcResult:
    """Host entry.  mode="planes" with src >= 0: single-source
    accumulation (the reference enactor is per source).  `batch`
    belongs to all-sources BC, not ported yet, and is not read.

    `device=None` runs on the CUDA card and raises without one;
    `device="cpu"` runs the kernel's plain version."""
    dev = resolve_device(device)
    if mode != "planes":
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet: ROADMAP.md queue 1, item 6")
    if not isinstance(graph, CsrGraph):
        raise TypeError("mode='planes' needs a host CsrGraph")
    if src < 0:
        raise ValueError("mode='planes' is single-source")
    fn = get_bc_planes(graph, dev)
    fn(src)                             # warm-up: builds the kernel
    delta, sigma, labels, depth, device_ms = fn(src)
    stats = Stats(elapsed_ms=device_ms, search_depth=depth,
                  nodes_visited=graph.num_nodes,
                  edges_visited=graph.num_edges)
    return BcResult(bc_values=(delta * 0.5).astype(np.float32),
                    sigmas=sigma, labels=labels, stats=stats)
