"""Betweenness centrality (Brandes): the host entry `run`, the
operator-layer searches `bc_source` and `bc_batch_kernel`, and the
value-plane driver `get_bc_planes`.

Counterpart of the JAX package's `primitives/bc.py`.  A forward BFS
accumulates path counts (sigma; the reference's atomicAdd in
bc_functor.cuh ForwardFunctor), then a backward replay of the levels,
deepest first, accumulates dependencies (BackwardFunctor,
bc_functor.cuh:147-253).

- `mode="xla"` (the default): the labels drive the replay, as in the
  reference: the backward pass masks edges by labels[u]+1 == labels[v]
  and counts down from the depth.  `src >= 0` runs one source
  (`bc_source`); `src=-1` runs every source, `batch` at a time, as one
  (batch, n_pad) state (`bc_batch_kernel`), and adds the batches' sums
  in float64 on the host after the timed window.  Every float sum is a
  fixed-order sum of `ops/segment.py`, so two runs give the same bits.
- `mode="planes"`, `src >= 0`: one gated f32 add sweep of the value
  kernel per level over the forward device CSC, gated on the
  frontier's words (contrib[v] = sum of sigma over v's frontier
  in-neighbours; its nonzero entries are the touched vertices, so the
  next frontier is touched & ~visited and sigma grows by contrib
  there), the level words kept in a host list; then, deepest level
  first, one gated add sweep over the reverse CSC
  (`SearchGraph.reverse`), gated on the child level's words, sums
  t[u] = (1 + delta[v]) / sigma[v] over u's out-neighbours v at level
  d + 1, and delta[u] += sigma[u] * t[u] for u at level d.  Labels are
  recovered from the level words.  The reference's `level_cap` and its
  rerun with a larger cap exist for a static-shape loop; the host loop
  here keeps one word map per level and runs to the search's end at
  any depth.

bc_values = delta / 2 (the undirected double count, test_bc.cu), with
delta 0 at the source; labels are INF32 where the search never
reached.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph
from gunrockinst_tpu_torch.ops.segment import sum_by_dst, sum_by_src
from gunrockinst_tpu_torch.ops.words import (host_unpack_words, pack_bitmap,
                                             unpack_bitmap)
from gunrockinst_tpu_torch.primitives.base import (INF32, GraphLike, Stats,
                                                   Timer, device_graph,
                                                   sync)
from gunrockinst_tpu_torch.primitives.bfs_pallas import (add_stepper,
                                                         add_sweep,
                                                         search_graph)

_planes_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

INT_MAX = INF32


def _safe_inverse(sigma: torch.Tensor) -> torch.Tensor:
    """1/sigma where sigma > 0, else 0: every intermediate stays finite."""
    pos = sigma > 0.0
    return torch.where(pos, 1.0 / torch.where(pos, sigma, 1.0), 0.0)


def bc_batch_kernel(graph: DeviceGraph, srcs: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               int]:
    """K Brandes sources at once as (K, n_pad) state: one shared
    forward level loop (to the batch's largest depth; finished lanes
    have empty frontiers) and one shared backward countdown (levels a
    lane never reached match no edge).  srcs: (K,) int32, padded with
    the dummy `n` (a dummy source contributes nothing).  Returns
    (bc_partial (n_pad,) f32 summed over the real lanes, sigma (K,
    n_pad), labels (K, n_pad), max depth)."""
    dev = graph.device
    esrc, edst = graph.edge_src, graph.edge_dst
    k, n_pad = srcs.shape[0], graph.n_pad
    lanes = torch.arange(k, device=dev)
    at = (lanes, srcs.long())
    labels = torch.full((k, n_pad), INT_MAX, dtype=torch.int32, device=dev)
    labels[at] = 0
    sigma = torch.zeros((k, n_pad), dtype=torch.float32, device=dev)
    sigma[at] = 1.0
    frontier = torch.zeros((k, n_pad), dtype=torch.bool, device=dev)
    frontier[at] = True

    depth = 0
    while depth <= graph.n and bool(frontier.any()):
        active = frontier.index_select(1, esrc)
        cand = active & (labels.index_select(1, edst) == INT_MAX)
        hits = torch.zeros((k, n_pad), dtype=torch.int32, device=dev)
        hits.index_add_(1, edst, cand.to(torch.int32))
        newf = (hits > 0) & (labels == INT_MAX)
        labels = torch.where(newf, depth + 1, labels)
        sadd = sum_by_dst(graph, torch.where(
            cand, sigma.index_select(1, esrc), 0.0))
        sigma = torch.where(newf, sadd, sigma)
        frontier = newf
        depth += 1

    # backward: one countdown from the batch's largest depth, with the
    # loop-invariant edge gathers hoisted
    lab_s, lab_d = labels.index_select(1, esrc), labels.index_select(1, edst)
    sig_s = sigma.index_select(1, esrc)
    inv_d = _safe_inverse(sigma).index_select(1, edst)
    delta = torch.zeros((k, n_pad), dtype=torch.float32, device=dev)
    for d in range(depth - 1, 0, -1):
        mask_e = (lab_s == d - 1) & (lab_d == d)
        contrib = torch.where(
            mask_e, sig_s * inv_d * (1.0 + delta.index_select(1, edst)),
            0.0)
        delta = delta + sum_by_src(graph, contrib)
    delta[at] = 0.0
    valid = (srcs < graph.n)[:, None]
    bc_part = torch.where(valid, delta, 0.0).sum(dim=0)
    return bc_part, sigma, labels, depth - 1


def bc_source(graph: DeviceGraph, src: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """One Brandes source.  Returns (delta (n_pad,) f32 dependency
    scores, sigma (n_pad,) f32, labels (n_pad,) int32, depth): the
    batch of one, whose reported depth is one more than the batch's."""
    srcs = torch.tensor([int(src)], dtype=torch.int32, device=graph.device)
    delta, sigma, labels, depth = bc_batch_kernel(graph, srcs)
    return delta, sigma[0], labels[0], depth + 1


def auto_batch(graph: DeviceGraph) -> int:
    """The largest power-of-two source batch whose edge arrays fit a
    scratch budget, clamped to [1, 128].  Per lane the reference counts
    22 * m_pad bytes (16 B of hoisted backward gathers, ~6 B of forward
    temporaries) against 2 GiB of a 16 GB card.  On a CUDA card the
    budget is an eighth of its free memory, since eager PyTorch keeps
    more temporaries alive than one fused program; on the CPU it is
    the reference's 2 GiB."""
    per_lane = 22 * graph.m_pad
    if graph.device.type == "cuda":
        budget = torch.cuda.mem_get_info(graph.device)[0] // 8
    else:
        budget = 2 << 30
    k = max(1, budget // max(per_lane, 1))
    return 1 << min(max(k.bit_length() - 1, 0), 7)


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


def run(graph: GraphLike, src: int = -1, batch: Optional[int] = None,
        mode: str = "xla", device: DeviceLike = None) -> BcResult:
    """Host entry.  src >= 0: one source (the reference enactor is per
    source); src == -1 (mode "xla" only): every source, `batch` sources
    at a time (`auto_batch` when None); sigmas and labels are then those
    of the last source, as in the reference's test.  mode="planes"
    needs a host CsrGraph.

    `device=None` runs on the CUDA card and raises without one;
    `device="cpu"` runs there (the kernel's plain version for
    "planes")."""
    dev = resolve_device(device)
    if mode == "planes":
        return _run_planes(graph, src, dev)
    if mode != "xla":
        raise ValueError(f"unknown mode {mode!r}")
    g = device_graph(graph, dev)
    if src >= g.n:
        raise ValueError(f"source vertex {src} out of range [0, {g.n})")
    if src >= 0:
        bc_source(g, src)                           # warm-up
        sync(dev)
        with Timer() as t:
            delta, sigma, labels, depth = bc_source(g, src)
            sync(dev)
        bc = delta.to(torch.float64).cpu().numpy()
        n_sources = 1
    else:
        k = batch or auto_batch(g)
        ids = np.arange(k, dtype=np.int32)
        ids[ids >= g.n] = g.n                       # dummy-pad the tail
        bc_batch_kernel(g, torch.from_numpy(ids).to(dev))   # warm-up
        sync(dev)
        depth, parts = 0, []
        with Timer() as t:
            # device batches only: the host-side sum runs after the
            # timer, like the reference's Extract after GpuTimer::Stop
            for b0 in range(0, g.n, k):
                ids = np.arange(b0, b0 + k, dtype=np.int32)
                ids[ids >= g.n] = g.n
                part, sig_b, lab_b, d = bc_batch_kernel(
                    g, torch.from_numpy(ids).to(dev))
                parts.append(part)
                depth = max(depth, d)
            sync(dev)
        last = (g.n - 1) % k
        sigma, labels = sig_b[last], lab_b[last]
        bc = np.zeros(g.n_pad, dtype=np.float64)
        for part in parts:
            bc += part.cpu().numpy()
        n_sources = g.n
    stats = Stats(elapsed_ms=t.elapsed_ms, search_depth=depth,
                  nodes_visited=g.n, edges_visited=g.m * n_sources)
    return BcResult(bc_values=(bc[: g.n] * 0.5).astype(np.float32),
                    sigmas=sigma[: g.n].cpu().numpy(),
                    labels=labels[: g.n].cpu().numpy(), stats=stats)


def _run_planes(graph, src, dev) -> BcResult:
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
