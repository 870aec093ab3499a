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
stands for the reference's three.  The graph searched, its reach masks
and the predecessor pass (the min-id tie-break, rebuilt from the labels)
are the shared `search_graph.SearchGraph`'s.  A search object's `preds`
feeds that pass the labels of its last search where they are: the mega
branch's decoded from its label planes on the device, in search ids
(`ops/preds.py::plane_labels`); the grid-stepped branch's, whose planes
are in input ids, uploaded from the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, download, resolve_device
from gunrockinst_tpu_torch.graph.csr import CsrGraph, derived
from gunrockinst_tpu_torch.graph.relabel import reach_words_for
from gunrockinst_tpu_torch.ops import preds as preds_op
from gunrockinst_tpu_torch.ops.chain import ChainBfs
from gunrockinst_tpu_torch.ops.pull import PullSweeper
from gunrockinst_tpu_torch.ops.words import (host_unpack_words, start_words,
                                             unpack_bitmap)
from gunrockinst_tpu_torch.primitives.base import INF32, Timer, sync
from gunrockinst_tpu_torch.primitives.search_graph import (SearchGraph,
                                                           first_candidates,
                                                           search_graph)
from gunrockinst_tpu_torch.utils import trace


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
    `warm_routes` the routes a call has completed; `preds()` gives the
    last call's predecessors."""

    def __init__(self, g: SearchGraph):
        self.g = g
        self.planes_full = max((g.n + 1).bit_length(), 1)
        self.went_deep = False
        self.route = ""
        self.warm_routes = set()
        self._chain = None
        self._widths = []   # new vertices a level of the deep search
        self._last = None   # (planes, vw, depth, psrc, src) of the last call

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
        self._last = None   # the last search's planes go before this one's
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
        self._last = (planes, vw, depth, psrc, int(src))
        self.warm_routes.add(self.route)
        return labels, depth, t.elapsed_ms

    def preds(self) -> np.ndarray:
        """(n,) int32 predecessors of the last call's search (`_preds`),
        fed from its label planes and visited words on the device, decoded
        there into labels in search ids: the host labels the call returned
        are the same values, and are not uploaded again."""
        planes, vw, depth, psrc, src = self._last
        with trace.span("gt.entry.preds"):
            labels = preds_op.plane_labels(planes, vw, self.g.n, depth, psrc)
            return self.g.preds_from_card(labels, src)


class _SweptBfs:
    """The grid-stepped branch: fn(src) -> (labels, depth, device_ms),
    levels of the touched sweep from a host loop over the unrelabeled
    graph, with full planes, up to n levels; depth counts the last,
    empty level.  `warm_routes` holds "sweep" once a call has
    completed; `preds()` gives the last call's predecessors."""

    route = "sweep"

    def __init__(self, csr: CsrGraph, device: torch.device):
        self.csr, self.device = csr, device
        self.n = csr.num_nodes
        self._last = None   # (labels, src) of the last call
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
        self._last = (labels, src)
        self.warm_routes.add(self.route)
        return labels, depth, t.elapsed_ms

    def preds(self) -> np.ndarray:
        """(n,) int32 predecessors of the last call's search (`_preds`):
        its planes are in input ids, not the search graph's, so its host
        labels are uploaded."""
        labels, src = self._last
        return _preds(self.csr, self.device, labels, src)


def _checked(src: int, n: int) -> int:
    if not 0 <= int(src) < n:
        raise ValueError(f"source vertex {src} out of range [0, {n})")
    return int(src)


def get_fused_bfs(csr: CsrGraph, use_mega: bool = True,
                  device: DeviceLike = None):
    """Whole-search BFS, cached per graph, branch and device:
    fn(src) -> (labels, depth, device_ms).  `use_mega` picks the mega
    branch (step kernel, then the chain kernel for deep searches) or
    the grid-stepped one (touched sweeps)."""
    dev = resolve_device(device)
    return derived(csr, ("fused_bfs", bool(use_mega), dev),
                   lambda: (_FusedBfs(search_graph(csr, dev)) if use_mega
                            else _SweptBfs(csr, dev)))


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
    return derived(csr, ("fused_bfs_multi", reps, planes, dev),
                   lambda: _multi(search_graph(csr, dev), reps, planes))


def _multi(g: SearchGraph, reps: int, planes: int):
    dev = g.device
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
    return fn


def _preds(csr: CsrGraph, dev: torch.device, labels_np: np.ndarray,
           src: int) -> np.ndarray:
    """(n,) int32 predecessors from final host labels in input ids: the
    least input id among the in-neighbours one level up
    (`SearchGraph.preds_of`, the labels uploaded); -1 at the source and
    at unreached vertices."""
    with trace.span("gt.entry.preds"):
        return search_graph(csr, dev).preds_of(labels_np, src, INF32)


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
    preds_np = fn.preds() if mark_preds else None
    return labels_np, preds_np, int(depth), device_ms


def get_pull_sweeper(csr: CsrGraph, device: DeviceLike = None
                     ) -> PullSweeper:
    """The touched sweeper over `csr`'s CSC (no relabeling), cached per
    graph and device: `sweeper(fw) -> touched`, `sweeper.sweep_fused(fw,
    vw) -> touched & ~vw`.  The reference's v1 `PullSweeper`."""
    dev = resolve_device(device)

    def build():
        csc = csr.transposed()
        return PullSweeper(csc.row_offsets, csc.col_indices, dev)
    return derived(csr, ("pull_sweeper", dev), build)


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
