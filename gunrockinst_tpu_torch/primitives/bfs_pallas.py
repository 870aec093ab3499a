"""BFS over the port's sweep kernels: the counterpart of the JAX
package's `primitives/bfs_pallas.py`, with the same return contracts.

Two branches, as in the reference's `get_fused_bfs`:

- **mega** (`use_mega=True`, `bfs_pallas_fused(variant="mega")`, the
  route of `bfs.run` modes "mega" and "auto").  The graph is relabeled
  (`graph/relabel.py`) and searched through the level-step kernel
  (`ops/mega.py`), one launch per level from a host loop that reads the
  kernel's count of new vertices; labels are kept as bit-planes of word
  maps and unpacked on the host afterwards.  A search runs with 8
  planes first (depth <= 255, every scale-free graph).  When it reaches
  depth 255 with a frontier left, the search runs again, whole, in one
  launch of the chain kernel (`ops/chain.py`) with `(n+1).bit_length()`
  planes, and every later search of that graph goes to the chain kernel
  directly, as the reference's `run_impl` does.  The level widths the
  8-plane loop counted pick the chain kernel's layout.  This replaces the
  reference's `lax.while_loop` and its TPU tile plans; its per-level
  plan choice (`_PlanSet`) becomes the step kernel's choice of push or
  pull, made on the card.
- **grid-stepped** (`use_mega=False`, `variant` other than "mega", the
  route of `bfs.run(traversal_mode="pallas")`): no relabeling, no reach
  mask, full planes, and a host level loop over the touched sweep
  (`ops/pull.py`).

`Stats.route` and the search object's `route` say which ran: "step8",
"chain" or "sweep".  The v1 entry point `bfs_pallas` runs the fused touched
sweep per level into an int32 label array, and `get_pull_sweeper`,
`get_pull_sweeper_v2` and `get_pull_sweeper_v3` give the sweeper that
stands for the reference's three.  Predecessors are rebuilt from the
labels with the min-id tie-break (`SearchGraph.min_preds`).
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.graph.relabel import (is_symmetric,
                                                 reach_words_for, relabeled)
from gunrockinst_tpu_torch.ops import preds as preds_op
from gunrockinst_tpu_torch.ops.chain import ChainBfs
from gunrockinst_tpu_torch.ops.mega import MegaStepper
from gunrockinst_tpu_torch.ops.pull import PullSweeper
from gunrockinst_tpu_torch.ops.value import ValueStepper
from gunrockinst_tpu_torch.ops.words import (host_unpack_words, start_words,
                                             unpack_bitmap)
from gunrockinst_tpu_torch.primitives.base import INF32, Timer, sync
from gunrockinst_tpu_torch.utils import trace

REACH_CACHE = 64    # per-source reach masks kept on the device


def download(t: torch.Tensor) -> np.ndarray:
    """`t` on the host, counted as one host read.  From a CUDA device
    the copy lands in a page-locked block of PyTorch's caching host
    allocator, so that the card's part is one DMA that does not wait on
    the host's paging, and the array returned owns that block."""
    trace.d2h(t)
    if t.device.type != "cuda":
        return t.cpu().numpy()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out.numpy()


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array `a` on `device`, its bytes counted; to a CUDA device
    through a page-locked block, filled by NumPy (a PyTorch CPU copy
    would wake the intra-op threads, which then spin)."""
    host = torch.from_numpy(trace.h2d(a))
    if device.type != "cuda":
        return host.to(device)
    buf = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    np.copyto(buf.numpy(), a)
    return buf.to(device)


def first_candidates(reach_words: np.ndarray, psrc: int) -> int:
    """The candidates of a search's first level: the vertices of the
    host reach mask other than the source."""
    bits = int(np.unpackbits(np.ascontiguousarray(reach_words).view(
        np.uint8)).sum())
    word = int(reach_words.reshape(-1)[psrc >> 5]) & 0xffffffff
    return bits - ((word >> (psrc & 31)) & 1)


class SearchGraph:
    """The relabeled graph of one CsrGraph on one device: its CSC on the
    host (`csc`, with the edge values in CSC order) and on the device
    (the stepper's `offsets` and `in_src`, which the value sweeps of
    the planes primitives share), the CSC of the reverse graph
    (`reverse`, for the sweeps into sources), and the per-source reach
    masks."""

    def __init__(self, csr: CsrGraph, device: torch.device):
        self.n = csr.num_nodes
        self.device = device
        self.csr_p, self.perm = relabeled(csr)
        self.csc = self.csr_p.transposed()
        self.stepper = MegaStepper(self.csc.row_offsets,
                                   self.csc.col_indices, device,
                                   out_edges=self.reverse)
        self.rows = self.stepper.rows
        self.n_words = self.stepper.n_words
        self._reach = {}
        self._reverse = None
        self._add_steppers = {}
        self._preds_plan = None
        self._perm = None
        if self.perm is not None:
            with trace.span("gt.setup.upload"):
                self._perm = torch.from_numpy(trace.h2d(
                    self.perm.astype(np.int64))).to(device)

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

    def stage(self, v: np.ndarray) -> torch.Tensor:
        """(n,) host values in input ids -> (32 * n_words,) f32 on the
        device in search ids, 0 in the padding."""
        return self.to_internal(torch.from_numpy(
            np.asarray(v, dtype=np.float32)).to(self.device))

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

    def reverse(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(offsets (n+1,), in_src (m,)) int32 on the device: the CSC of
        the reverse graph in the same internal ids, whose in-edges of u
        are u's out-edges (counterpart of the reference's
        `get_reverse_plan`, pallas_value.py:532).  That is the
        relabeled CSR, uploaded once; a symmetric graph is its own
        reverse and returns the forward CSC's tensors."""
        if self._reverse is None:
            st = self.stepper
            if is_symmetric(self.csr_p):
                self._reverse = (st.offsets, st.in_src)
            else:
                with trace.span("gt.setup.upload"):
                    self._reverse = tuple(
                        torch.from_numpy(trace.h2d(np.ascontiguousarray(
                            a, dtype=np.int32))).to(self.device)
                        for a in (self.csr_p.row_offsets,
                                  self.csr_p.col_indices))
        return self._reverse

    def reach(self, psrc: int) -> torch.Tensor:
        return self._reach_of(psrc)[0]

    def _reach_of(self, psrc: int) -> Tuple[torch.Tensor, int]:
        """(the reach mask of psrc on the device, its candidates at the
        first level: the reach vertices other than psrc)."""
        hit = self._reach.get(psrc)
        if hit is None:
            with trace.span("gt.entry.reach"):
                if len(self._reach) >= REACH_CACHE:
                    self._reach.clear()
                words = reach_words_for(self.csr_p, psrc, self.n_words)
                hit = (torch.from_numpy(trace.h2d(words)).to(self.device),
                       first_candidates(words, psrc))
                self._reach[psrc] = hit
        return hit

    def min_preds(self, vals: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  const_w: Optional[float] = None) -> np.ndarray:
        """(n,) int32 predecessors in input ids: for each vertex v the
        least input id of the in-neighbours u that achieve v's value, -1
        where there is none (the oracles' min-id tie-break).  `vals` are
        the search's values in search ids on the device: int32 BFS
        labels (lu + 1 == lv), or float32 SSSP distances with the
        stepper's per-edge `weights` in CSC order or `const_w` (du + w ==
        dv).  The device CSC (the stepper's `offsets` and `in_src`) is
        the only edge list read (`ops/preds.py`); the pass's plan is
        built on the first call and kept."""
        st = self.stepper
        if self._preds_plan is None:
            self._preds_plan = preds_op.plan(st.offsets, self._perm)
        out = preds_op.min_preds(st.offsets, st.in_src, vals,
                                 self._preds_plan, weights, const_w)
        return download(out)

    def start(self, psrc: int, candidates: Optional[int] = None
              ) -> torch.Tensor:
        """The word map holding only vertex `psrc`, made by the step
        kernel's `MegaStepper.start` with the first level's candidate
        count (`candidates`, else that of psrc's cached reach mask, if
        any), so that the first level needs no stats pass."""
        if candidates is None and psrc in self._reach:
            candidates = self._reach[psrc][1]
        return self.stepper.start(psrc, candidates)

    def search(self, psrc: int, reach: torch.Tensor, n_planes: int,
               cap_depth: int, candidates: Optional[int] = None,
               widths: Optional[list] = None):
        """Levels 1, 2, ... from `psrc` until the frontier is empty or
        `cap_depth` levels ran.  Returns (planes, visited words, depth,
        cont); depth counts the last, empty level, and cont is True
        when the cap stopped the search.  `candidates`: see `start`.
        Each level's count of new vertices is appended to `widths`, if
        given.  Each level's span counts the order the step kernel took,
        `level.push` or `level.pull`, read with the count."""
        fw = self.start(psrc, candidates)
        vw = fw.clone()
        planes = torch.zeros((n_planes * self.rows, 128),
                             dtype=torch.int32, device=self.device)
        depth, cont = 0, True
        while cont and depth < cap_depth:
            depth += 1
            with trace.span("gt.driver.level"):
                fw, n_new = self.stepper.step(fw, vw, planes, depth, reach)
                count, way = self.stepper.read_level(n_new)
                if way is not None:
                    trace.count(f"level.{way}")
            if widths is not None:
                widths.append(count)
            cont = count > 0
        return planes, vw, depth, cont


_graph_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def add_stepper(g: SearchGraph, reverse: bool = False,
                gated: bool = False) -> ValueStepper:
    """The f32 add sweep over g's forward CSC (into destinations) or its
    reverse CSC (into sources), ungated or gated on the sources' ch
    bits; one stepper per combination, cached on g, so the sweeps of
    PR, HITS, SALSA, WTF and BC share it (counterpart of the
    reference's `get_add_stepper`, pallas_value.py:991).  A gated
    stepper's touched route walks the active sources' out-edges: the
    reverse CSC's in-lists for a forward sweep, the forward CSC's for a
    reverse one."""
    key = (bool(reverse), bool(gated))
    hit = g._add_steppers.get(key)
    if hit is None:
        forward = (g.stepper.offsets, g.stepper.in_src)
        offsets, in_src = g.reverse() if reverse else forward
        out_edges = None
        if gated:
            out_edges = (lambda: forward) if reverse else g.reverse
        hit = g._add_steppers[key] = ValueStepper(
            offsets, in_src, mode="add", f32=True, use_active=gated,
            out_edges=out_edges)
    return hit


def add_sweep(st: ValueStepper, x: torch.Tensor,
              ch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sweep of an add stepper over f32 values x (n_pad,): the f32
    sums per vertex."""
    return st.sweep(x.view(torch.int32), ch)[0].view(torch.float32)


def search_graph(csr: CsrGraph, device: torch.device) -> SearchGraph:
    """The SearchGraph of `csr` on `device`, built once per graph."""
    per_dev = _graph_cache.setdefault(csr, {})
    hit = per_dev.get(device)
    if hit is None:
        hit = per_dev[device] = SearchGraph(csr, device)
    return hit


def _labels(planes, vw, depth: int, n_planes: int, n: int, perm,
            src: int) -> np.ndarray:
    """(n,) int32 labels in input ids from a search's label planes and
    visited words, on the host: only planes up to bit_length(depth) can
    be nonzero; unvisited vertices get INF32."""
    with trace.span("gt.entry.extract"):
        planes_np = download(planes).reshape(n_planes, -1)
        visited = host_unpack_words(download(vw), n).astype(bool)
        labels = np.zeros(n, dtype=np.int32)
        for b in range(min(max(depth, 1).bit_length(), n_planes)):
            labels |= host_unpack_words(planes_np[b], n).astype(
                np.int32) << b
        labels[~visited] = INF32
        if perm is not None:
            labels = labels[perm]   # back to input ids
        labels[int(src)] = 0
        return labels


class _FusedBfs:
    """The mega branch: fn(src) -> (labels (n,) int32 in input ids,
    depth, device_ms); `route` names the route the last call took and
    `warm_routes` the routes a call has completed."""

    def __init__(self, g: SearchGraph):
        self.g = g
        self.planes_full = max((g.n + 1).bit_length(), 1)
        self.went_deep = False
        self.route = ""
        self.warm_routes = set()
        self._chain = None
        self._widths = []   # new vertices a level of the deep search

    def chain(self) -> ChainBfs:
        """The chain kernel with full planes, built at first use with
        the level widths the 8-plane search counted (they pick the
        kernel's layout); a build or launch failure raises (no
        fallback)."""
        if self._chain is None:
            self._chain = ChainBfs(self.g, self.planes_full,
                                   widths=self._widths)
        return self._chain

    def __call__(self, src: int) -> Tuple[np.ndarray, int, float]:
        g = self.g
        psrc = g.internal(src)
        reach = None if self.went_deep else g.reach(psrc)
        sync(g.device)
        with trace.span("gt.entry.search") as t:
            if not self.went_deep:
                n_planes = min(8, self.planes_full)
                self._widths = []
                planes, vw, depth, cont = g.search(
                    psrc, reach, n_planes, min(g.n, (1 << n_planes) - 1),
                    widths=self._widths)
                self.route = "step8"
                if cont and self.planes_full > n_planes:
                    self.went_deep = True
            if self.went_deep:
                # depth passed the 8-plane cap: the whole search again,
                # in one launch, with every plane the labels can need
                n_planes, self.route = self.planes_full, "chain"
                chain = self.chain()
                with trace.span("gt.driver.chain"):
                    planes, vw, depth = chain(psrc)
                    depth = int(trace.d2h(depth).item())
            sync(g.device)
        # label assembly on the host, outside the timed window (the
        # reference times Enact only, tests/bfs/test_bfs.cu:402-431)
        labels = _labels(planes, vw, depth, n_planes, g.n, g.perm, src)
        self.warm_routes.add(self.route)
        return labels, depth, t.elapsed_ms


class _SweptBfs:
    """The grid-stepped branch: fn(src) -> (labels, depth, device_ms),
    levels of the touched sweep from a host loop over the unrelabeled
    graph, with full planes, up to n levels; depth counts the last,
    empty level.  `warm_routes` holds "sweep" once a call has
    completed."""

    route = "sweep"

    def __init__(self, csr: CsrGraph, device: torch.device):
        self.n = csr.num_nodes
        self.warm_routes = set()
        self.sweeper = get_pull_sweeper(csr, device)
        self.planes_full = max((self.n + 1).bit_length(), 1)

    def __call__(self, src: int) -> Tuple[np.ndarray, int, float]:
        sw, n, n_planes = self.sweeper, self.n, self.planes_full
        src = _checked(src, n)
        rows = sw.rows
        fw = start_words(src, rows, sw.device)
        vw = fw.clone()
        planes = torch.zeros((n_planes * rows, 128), dtype=torch.int32,
                             device=sw.device)
        sync(sw.device)
        with trace.span("gt.entry.search") as t:
            depth, cont = 0, True
            while cont and depth < n:
                with trace.span("gt.driver.level"):
                    nfw = sw(fw) & ~vw
                    vw |= nfw
                    depth += 1
                    for b in range(n_planes):
                        if (depth >> b) & 1:
                            planes[b * rows:(b + 1) * rows] |= nfw
                    fw = nfw
                    cont = bool(trace.d2h(nfw.any()))
            sync(sw.device)
        labels = _labels(planes, vw, depth, n_planes, n, None, src)
        self.warm_routes.add(self.route)
        return labels, depth, t.elapsed_ms


def _checked(src: int, n: int) -> int:
    if not 0 <= int(src) < n:
        raise ValueError(f"source vertex {src} out of range [0, {n})")
    return int(src)


_fused_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def get_fused_bfs(csr: CsrGraph, use_mega: bool = True,
                  device: DeviceLike = None):
    """Whole-search BFS, cached per graph, branch and device:
    fn(src) -> (labels, depth, device_ms).  `use_mega` picks the mega
    branch (step kernel, then the chain kernel for deep searches) or
    the grid-stepped one (touched sweeps)."""
    dev = resolve_device(device)
    per_graph = _fused_cache.setdefault(csr, {})
    key = (bool(use_mega), dev)
    hit = per_graph.get(key)
    if hit is None:
        hit = per_graph[key] = (_FusedBfs(search_graph(csr, dev))
                                if use_mega else _SweptBfs(csr, dev))
    return hit


_multi_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def get_fused_bfs_multi(csr: CsrGraph, reps: int = 8, planes: int = 8,
                        device: DeviceLike = None):
    """`reps` complete BFS searches per call, one after another, with
    `planes` label planes each (their labels are dropped).

    Returns fn(srcs (reps,) i32) -> (depths (reps,) np, visited_words
    (reps, rows, 128) np, wall_ms), wall_ms being the wall time of all
    searches, ended by a device sync.  Visited words are in the
    search's (possibly relabeled) space; `fn.visited_of(row)` maps one
    to an (n,) bool mask in input ids, and `fn.perm` is the
    permutation."""
    dev = resolve_device(device)
    per_graph = _multi_cache.setdefault(csr, {})
    hit = per_graph.get((reps, planes, dev))
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
        words = [reach_words_for(g.csr_p, p, g.n_words) for p in psrcs]
        cands = [first_candidates(w, p) for w, p in zip(words, psrcs)]
        reach = torch.from_numpy(np.stack(words)).to(dev)
        sync(dev)
        with Timer() as t:
            depths, vws = [], []
            for i, p in enumerate(psrcs):
                _, vw, depth, _ = g.search(p, reach[i], planes, n, cands[i])
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
    per_graph[(reps, planes, dev)] = fn
    return fn


def _preds(csr: CsrGraph, dev: torch.device, labels_np: np.ndarray,
           src: int) -> np.ndarray:
    """(n,) int32 predecessors from final labels: the least input id
    among the in-neighbours one level up (`SearchGraph.min_preds`); -1
    at the source and at unreached vertices."""
    with trace.span("gt.entry.preds"):
        g = search_graph(csr, dev)
        labels = g.to_internal(upload(labels_np, g.device), INF32)
        preds = g.min_preds(labels)
        preds[src] = -1
        return preds


def bfs_pallas_fused(csr: CsrGraph, src: int, mark_preds: bool = True,
                     variant: str = "mega", device: DeviceLike = None
                     ) -> Tuple[np.ndarray, Optional[np.ndarray], int,
                                float]:
    """Returns (labels, preds|None, depth, device_ms); device_ms is the
    search time (extraction excluded).  `variant` "mega" takes the mega
    branch; any other value the grid-stepped one."""
    dev = resolve_device(device)
    fn = get_fused_bfs(csr, use_mega=variant == "mega", device=dev)
    labels_np, depth, device_ms = fn(src)
    preds_np = _preds(csr, dev, labels_np, src) if mark_preds else None
    return labels_np, preds_np, int(depth), device_ms


_sweeper_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def get_pull_sweeper(csr: CsrGraph, device: DeviceLike = None
                     ) -> PullSweeper:
    """The touched sweeper over `csr`'s CSC (no relabeling), cached per
    graph and device: `sweeper(fw) -> touched`, `sweeper.sweep_fused(fw,
    vw) -> touched & ~vw`.  The reference's v1 `PullSweeper`."""
    dev = resolve_device(device)
    per_dev = _sweeper_cache.setdefault(csr, {})
    hit = per_dev.get(dev)
    if hit is None:
        csc = csr.transposed()
        hit = per_dev[dev] = PullSweeper(csc.row_offsets, csc.col_indices,
                                         dev)
    return hit


def get_pull_sweeper_v2(csr: CsrGraph, device: DeviceLike = None
                        ) -> PullSweeper:
    """The reference's `PullSweeperV2` (v2 tile placement): the same
    function, so the same sweeper as `get_pull_sweeper`."""
    return get_pull_sweeper(csr, device)


def get_pull_sweeper_v3(csr: CsrGraph, device: DeviceLike = None
                        ) -> PullSweeper:
    """The reference's `PullSweeperV3` (v3 tile placement): the same
    function, so the same sweeper as `get_pull_sweeper`."""
    return get_pull_sweeper(csr, device)


def bfs_pallas(csr: CsrGraph, src: int, mark_preds: bool = True,
               max_depth: Optional[int] = None, device: DeviceLike = None
               ) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    """The v1 entry point: returns (labels (n,), preds (n,)|None,
    depth).  One fused touched sweep per level from a host loop, at
    most `max_depth` levels; unlike the fused searches, depth does not
    count the last, empty level (the reference's `depth -= 1`)."""
    dev = resolve_device(device)
    n = csr.num_nodes
    src = _checked(src, n)
    sw = get_pull_sweeper(csr, dev)
    n_bits = sw.n_words * 32
    labels = torch.full((n_bits,), INF32, dtype=torch.int32, device=dev)
    labels[src] = 0
    fw = start_words(src, sw.rows, dev)
    vw = fw.clone()
    depth = 0
    limit = max_depth if max_depth is not None else n + 1
    while depth < limit:
        fw = sw.sweep_fused(fw, vw)
        vw |= fw
        labels.masked_fill_(unpack_bitmap(fw, n_bits), depth + 1)
        depth += 1
        if not bool(fw.any()):
            depth -= 1
            break
    labels_np = labels[:n].cpu().numpy()
    preds_np = _preds(csr, dev, labels_np, src) if mark_preds else None
    return labels_np, preds_np, depth
