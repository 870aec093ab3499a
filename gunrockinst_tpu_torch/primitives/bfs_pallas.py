"""BFS over the level-step kernel (traversal_mode="mega" / "auto").

Counterpart of the JAX package's `primitives/bfs_pallas.py`: the mega
branch of `get_fused_bfs`, `get_fused_bfs_multi`, `bfs_pallas_fused`
and `_post_preds` (`SearchGraph.min_preds`), with the same return
contracts.

The level loop runs on the host: one launch of the step kernel
(`ops/mega.py`) per level, then one read of the kernel's count of new
vertices to test whether the frontier is empty.  This replaces the
reference's `lax.while_loop`, its per-level source-or-destination plan
choice (`_PlanSet`) and its TPU tile plans; the step kernel reads a CSC
of the relabeled graph and skips by destination word itself.

Labels are kept as bit-planes of word maps during the search and
unpacked on the host afterwards, as in the reference.  A search runs
with 8 planes first (depth <= 255, every scale-free graph); when it
reaches depth 255 with a frontier left, it reruns with
`(n+1).bit_length()` planes through the same kernel.  `Stats.route`
and `_FusedBfs.route` say which ran ("step8" or "step_full").
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.graph.relabel import reach_words_for, relabeled
from gunrockinst_tpu_torch.ops.mega import MegaStepper
from gunrockinst_tpu_torch.ops.words import host_unpack_words
from gunrockinst_tpu_torch.primitives.base import INF32, Timer, sync

REACH_CACHE = 64    # per-source reach masks kept on the device
MULTI_PLANES = 8    # label planes of a multi-search (its labels are dropped)


class SearchGraph:
    """The relabeled graph of one CsrGraph on one device: its CSC on the
    host (`csc`, with the edge values in CSC order) and on the device
    (the stepper's `offsets` and `in_src`, which the value sweeps of
    primitives/sssp.py, cc.py and pr.py share), and the per-source
    reach masks."""

    def __init__(self, csr: CsrGraph, device: torch.device):
        self.n = csr.num_nodes
        self.device = device
        self.csr_p, self.perm = relabeled(csr)
        self.csc = self.csr_p.transposed()
        self.stepper = MegaStepper(self.csc.row_offsets,
                                   self.csc.col_indices, device)
        self.rows = self.stepper.rows
        self.n_words = self.stepper.n_words
        self._reach = {}
        self._perm = (None if self.perm is None else torch.from_numpy(
            self.perm.astype(np.int64)).to(device))

    def to_internal(self, x: torch.Tensor, fill=0) -> torch.Tensor:
        """(n,) values in input ids -> (32 * n_words,) values in search
        ids, `fill` in the padding."""
        out = torch.full((self.n_words * 32,), fill, dtype=x.dtype,
                         device=self.device)
        if self._perm is None:
            out[: self.n] = x
        else:
            out[self._perm] = x
        return out

    def to_input(self, t: torch.Tensor) -> torch.Tensor:
        """(>= n,) values in search ids -> (n,) values in input ids."""
        t = t[: self.n]
        return t if self._perm is None else t[self._perm]

    def internal(self, src: int) -> int:
        """The search-space id of input vertex `src`."""
        if not 0 <= int(src) < self.n:
            raise ValueError(f"source vertex {src} out of range "
                             f"[0, {self.n})")
        return int(src) if self.perm is None else int(self.perm[int(src)])

    def reach(self, psrc: int) -> torch.Tensor:
        hit = self._reach.get(psrc)
        if hit is None:
            if len(self._reach) >= REACH_CACHE:
                self._reach.clear()
            hit = torch.from_numpy(reach_words_for(
                self.csr_p, psrc, self.n_words)).to(self.device)
            self._reach[psrc] = hit
        return hit

    def min_preds(self, achieves) -> np.ndarray:
        """(n,) int32 predecessors in input ids: for each vertex v the
        least input id of the in-neighbours u with achieves(u, v), -1
        where there is none (the oracles' min-id tie-break).  achieves
        takes the search ids of every CSC edge's source and destination,
        int64 on the device, and returns a bool per edge; the device
        CSC is the only edge list read."""
        st = self.stepper
        u, v = st.in_src.long(), st.edge_dst()
        ids = self.to_internal(torch.arange(self.n, dtype=torch.int32,
                                            device=self.device), INF32)
        preds = torch.full((self.n_words * 32,), INF32, dtype=torch.int32,
                           device=self.device)
        preds.scatter_reduce_(0, v, torch.where(achieves(u, v), ids[u],
                                                INF32), "amin")
        preds = torch.where(preds == INF32, -1, preds)
        return self.to_input(preds).cpu().numpy()

    def start(self, psrc: int) -> torch.Tensor:
        """The word map holding only vertex `psrc`."""
        fw = torch.zeros((self.rows, 128), dtype=torch.int32,
                         device=self.device)
        bit = np.array([1 << (psrc & 31)], np.uint32).view(np.int32)
        fw.view(-1)[psrc >> 5] = int(bit[0])
        return fw

    def search(self, psrc: int, reach: torch.Tensor, n_planes: int,
               cap_depth: int):
        """Levels 1, 2, ... from `psrc` until the frontier is empty or
        `cap_depth` levels ran.  Returns (planes, visited words, depth,
        cont); depth counts the last, empty level, and cont is True
        when the cap stopped the search."""
        fw = self.start(psrc)
        vw = fw.clone()
        planes = torch.zeros((n_planes * self.rows, 128),
                             dtype=torch.int32, device=self.device)
        depth, cont = 0, True
        while cont and depth < cap_depth:
            depth += 1
            fw, n_new = self.stepper.step(fw, vw, planes, depth, reach)
            cont = int(n_new.item()) > 0
        return planes, vw, depth, cont


_graph_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def search_graph(csr: CsrGraph, device: torch.device) -> SearchGraph:
    """The SearchGraph of `csr` on `device`, built once per graph."""
    per_dev = _graph_cache.setdefault(csr, {})
    hit = per_dev.get(device)
    if hit is None:
        hit = per_dev[device] = SearchGraph(csr, device)
    return hit


class _FusedBfs:
    """fn(src) -> (labels (n,) int32 in input ids, depth, device_ms);
    `route` names the route the last call took."""

    def __init__(self, g: SearchGraph):
        self.g = g
        self.planes_full = max((g.n + 1).bit_length(), 1)
        self.went_deep = False
        self.route = ""

    def __call__(self, src: int) -> Tuple[np.ndarray, int, float]:
        g = self.g
        psrc = g.internal(src)
        reach = g.reach(psrc)
        sync(g.device)
        with Timer() as t:
            p8 = min(8, self.planes_full)
            if not self.went_deep:
                planes, vw, depth, cont = g.search(
                    psrc, reach, p8, min(g.n, (1 << p8) - 1))
                n_planes, self.route = p8, "step8"
                if cont and self.planes_full > p8:
                    self.went_deep = True
            if self.went_deep:
                # depth passed the 8-plane cap: rerun with every plane
                # the labels can need, through the same step kernel
                n_planes, self.route = self.planes_full, "step_full"
                planes, vw, depth, cont = g.search(
                    psrc, reach, n_planes, min(g.n, (1 << n_planes) - 1))
            sync(g.device)
        # label assembly on the host, outside the timed window (the
        # reference times Enact only, tests/bfs/test_bfs.cu:402-431);
        # only planes up to bit_length(depth) can be nonzero
        n = g.n
        planes_np = planes.cpu().numpy().reshape(n_planes, g.n_words)
        visited = host_unpack_words(vw.cpu().numpy(), n).astype(bool)
        labels = np.zeros(n, dtype=np.int32)
        for b in range(min(max(depth, 1).bit_length(), n_planes)):
            labels |= host_unpack_words(planes_np[b], n).astype(
                np.int32) << b
        labels[~visited] = INF32
        if g.perm is not None:
            labels = labels[g.perm]   # back to input ids
        labels[int(src)] = 0
        return labels, depth, t.elapsed_ms


_fused_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def get_fused_bfs(csr: CsrGraph, device: DeviceLike = None) -> _FusedBfs:
    """Whole-search BFS on the step kernel, cached per graph and
    device: fn(src) -> (labels, depth, device_ms)."""
    dev = resolve_device(device)
    per_dev = _fused_cache.setdefault(csr, {})
    hit = per_dev.get(dev)
    if hit is None:
        hit = per_dev[dev] = _FusedBfs(search_graph(csr, dev))
    return hit


_multi_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def get_fused_bfs_multi(csr: CsrGraph, reps: int = 8,
                        device: DeviceLike = None):
    """`reps` complete BFS searches per call, one after another.

    Returns fn(srcs (reps,) i32) -> (depths (reps,) np, visited_words
    (reps, rows, 128) np, wall_ms), wall_ms being the wall time of all
    searches, ended by a device sync.  Visited words are in the
    search's (possibly relabeled) space; `fn.visited_of(row)` maps one
    to an (n,) bool mask in input ids, and `fn.perm` is the
    permutation."""
    dev = resolve_device(device)
    per_graph = _multi_cache.setdefault(csr, {})
    hit = per_graph.get((reps, dev))
    if hit is not None:
        return hit
    g = search_graph(csr, dev)
    n = g.n

    def fn(srcs):
        srcs = np.asarray(srcs, np.int32)
        if srcs.shape != (reps,):
            raise ValueError(f"expected {reps} sources, got shape "
                             f"{srcs.shape}")
        psrcs = [g.internal(s) for s in srcs]
        reach = torch.from_numpy(np.stack(
            [reach_words_for(g.csr_p, p, g.n_words) for p in psrcs]
        )).to(dev)
        sync(dev)
        with Timer() as t:
            depths, vws = [], []
            for i, p in enumerate(psrcs):
                _, vw, depth, _ = g.search(p, reach[i], MULTI_PLANES, n)
                depths.append(depth)
                vws.append(vw)
            sync(dev)
        return (np.asarray(depths, np.int32),
                torch.stack(vws).cpu().numpy(), t.elapsed_ms)

    fn.perm = g.perm

    def visited_of(vws_row):
        bits = host_unpack_words(np.asarray(vws_row), n).astype(bool)
        return bits if g.perm is None else bits[g.perm]

    fn.visited_of = visited_of
    per_graph[(reps, dev)] = fn
    return fn


def bfs_pallas_fused(csr: CsrGraph, src: int, mark_preds: bool = True,
                     device: DeviceLike = None
                     ) -> Tuple[np.ndarray, Optional[np.ndarray], int,
                                float]:
    """Returns (labels, preds|None, depth, device_ms); device_ms is the
    search time (extraction excluded).  Only the reference's "mega"
    variant is ported; the grid-stepped sweeps are ROADMAP.md queue 1,
    item 9."""
    fn = get_fused_bfs(csr, device)
    labels_np, depth, device_ms = fn(src)
    preds_np = None
    if mark_preds:
        g = fn.g
        labels = g.to_internal(torch.from_numpy(labels_np).to(g.device),
                               INF32)

        def achieves(u, v):
            lu = labels[u].long()
            return (lu != INF32) & (labels[v].long() == lu + 1)

        preds_np = g.min_preds(achieves)
        preds_np[src] = -1
    return labels_np, preds_np, int(depth), device_ms
