"""The search graph the kernel routes of BFS, SSSP, CC, PR, HITS, SALSA,
WTF and BC share: the relabeled device CSC of one host graph
(`SearchGraph`) with its reverse CSC, per-source reach masks, the
predecessor pass (`preds_of` and `preds_from_card`, the min-id
tie-break) and the f32 add
steppers.  `search_graph(csr, device)` builds it once per graph and
device, whichever primitive reaches the graph first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.device import download, upload
from gunrockinst_tpu_torch.graph.csr import CsrGraph, derived
from gunrockinst_tpu_torch.graph.relabel import (is_symmetric,
                                                 reach_words_for, relabeled)
from gunrockinst_tpu_torch.ops import preds as preds_op
from gunrockinst_tpu_torch.ops.mega import MegaStepper
from gunrockinst_tpu_torch.ops.value import ValueStepper
from gunrockinst_tpu_torch.utils import trace

REACH_CACHE = 64    # per-source reach masks kept on the device


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

    def preds_of(self, values: np.ndarray, src: int, fill,
                 weights: Optional[torch.Tensor] = None,
                 const_w: Optional[float] = None) -> np.ndarray:
        """`min_preds` of a search's final (n,) host values in input ids
        (BFS labels, `fill` INF32; SSSP distances, `fill` inf, with
        `weights` or `const_w`), uploaded and moved to search ids with
        `fill` in the padding; -1 at `src`.  Counted
        `preds.host_values`."""
        trace.count("preds.host_values")
        vals = self.to_internal(upload(values, self.device), fill)
        preds = self.min_preds(vals, weights, const_w)
        preds[src] = -1
        return preds

    def preds_from_card(self, vals: torch.Tensor, src: int,
                        weights: Optional[torch.Tensor] = None,
                        const_w: Optional[float] = None) -> np.ndarray:
        """`min_preds` of a search's final values where the search left
        them: on the device, in search ids, with the fill in the padding
        (nothing is uploaded); -1 at `src`.  Counted
        `preds.card_values`."""
        trace.count("preds.card_values")
        preds = self.min_preds(vals, weights, const_w)
        preds[src] = -1
        return preds

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


def search_graph(csr: CsrGraph, device: torch.device) -> SearchGraph:
    """The SearchGraph of `csr` on `device`, built once per graph."""
    return derived(csr, ("search_graph", device),
                   lambda: SearchGraph(csr, device))


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
