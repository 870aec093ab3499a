"""BFS level step: the Hopper kernel `csrc/mega_step.cu`, its wrapper,
its plain PyTorch versions and its launch counter.

Counterpart of the JAX package's `ops/pallas_mega.py::MegaStepper`
(kernel `_make_step_kernel`, pallas_mega.py:422).  One call runs one
BFS level on word maps (`ops/words.py`):

    nfw    = (OR over in-edges u->v of fw[u]) & reach & ~vw
    vw'    = vw | nfw
    planes'[b] = planes[b] | nfw   for every bit b set in d
    n_new  = popcount(nfw)

The TPU plan (hub/packed tiles, 32K-vertex regions, SMEM and VMEM
budgets) does not carry over.  The kernel computes the level in one of
two orders, as the reference's `_PlanSet.level` picks frontier-ordered
or destination-ordered work each level
(gunrockinst_tpu/primitives/bfs_pallas.py:185-223): a push along the
frontier's out-edges (the graph's out-CSR, shared with the chain
kernel and the reverse sweeps) or a pull over the candidates' in-edges
(the CSC).  `reach` must be a superset of what the search can still
claim (`graph/relabel.py::reach_words_for`); for the inputs a search
produces the result equals the reference's bit for bit, in either
order.

The direction rule (`choose_direction`): push when the frontier's
out-edges are fewer than the candidates (reach & ~vw), else pull.  On
the card the counts come from the launch that produced the frontier:
each launch leaves the candidates left after it and the out-edge total
of the vertices it claimed in a device slot, and the next launch reads
them and branches, with no host round trip.  The wrapper hands the
kernel that slot when the call's fw is the nfw it returned last (the
same tensor, on the same stream).  A search's first frontier made by
`start(psrc, candidates)` carries its counts with it (the start
vertex's out-list and the caller's candidate count); any other input
is first counted by a small stats kernel.

The slot also lists the hubs (more than 256 out-ids) among the vertices
the launch claimed, so that the next push can cut their out-lists into
pieces for the whole grid.  What the kernel computes does not depend on
the slot describing fw: if fw, vw or reach were edited after the launch
that filled it (through a raw pointer, say, which no `_version` sees),
the choice may be slow but the bits are right.  The direction only
picks one of two orders of the same function, and the hub list is
checked against fw: a listed hub is walked only if fw holds it, and a
frontier vertex leaves its out-list to that walk only if the slot's
launch listed it (each launch tags the hubs it lists with its own
number, `seq`, in a per-vertex array).  `direction="push"` or `"pull"`
forces an order, for the smoke run and the tests only.

The wrapper launches the kernel for CUDA tensors and takes the plain
versions, `step_reference` (pull) and `push_reference` (push), only for
CPU tensors.  It updates `vw` and `planes` in place; `nfw` and `n_new`
are new tensors each call.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.ops import _build
from gunrockinst_tpu_torch.ops.words import (pack_bitmap, start_words,
                                             unpack_bitmap, word_rows)
from gunrockinst_tpu_torch.utils import trace

DIRECTIONS = ("auto", "push", "pull")
_CODE = {"auto": 0, "push": 1, "pull": 2}
_SLOTS = 4          # stats slots on the card (mega_step.cu's kSlots)
_DIR_AT = 4         # a slot's "direction taken" (kDir)


def _kernel_fn():
    fn = _build.load("mega_step").gt_mega_step
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 13 + [i32] * 11 + [ptr]
        fn.restype = i32
    return fn


def _raw_stream(index: int) -> int:
    """The handle of the current CUDA stream of device `index`."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(index).cuda_stream
    return raw(index)


def choose_direction(frontier_edges: int, candidates: int) -> str:
    """The level's order: "push" when the frontier's out-edges are fewer
    than the candidates (reach & ~vw), else "pull" (mega_step.cu's
    `push_rule`)."""
    return "push" if int(frontier_edges) < int(candidates) else "pull"


def level_stats(out_off: torch.Tensor, fw: torch.Tensor, vw: torch.Tensor,
                reach: torch.Tensor) -> Tuple[int, int]:
    """(the frontier's out-edge total, the candidate count) of a level's
    inputs: what `choose_direction` reads.  Bits of vertices >= n count
    for neither."""
    n = out_off.shape[0] - 1
    front = unpack_bitmap(fw, n)
    deg = (out_off[1:] - out_off[:-1]).long()
    cand = unpack_bitmap(reach & ~vw, n)
    return int(deg[front].sum()), int(cand.sum())


def push_reference(out_off: torch.Tensor, out_dst: torch.Tensor,
                   fw: torch.Tensor, vw: torch.Tensor,
                   planes: torch.Tensor, d: int, reach: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Plain PyTorch version of one level in push order: the
    destinations of the frontier vertices' out-edges (the out-CSR
    `out_off`, `out_dst`), packed, & reach & ~vw.  Pure: returns (nfw,
    vw', planes', n_new) as new tensors, equal to `step_reference`'s
    bit for bit."""
    n = out_off.shape[0] - 1
    rows = fw.shape[0]
    n_bits = rows * 128 * 32
    front = torch.nonzero(unpack_bitmap(fw, n)).squeeze(1)
    beg, end = out_off[front].long(), out_off[front + 1].long()
    span = end - beg
    first = torch.repeat_interleave(beg - torch.cumsum(span, 0) + span,
                                    span)
    dst = out_dst[first + torch.arange(first.numel(),
                                       device=fw.device)].long()
    hit = torch.zeros(n_bits, dtype=torch.bool, device=fw.device)
    hit[dst] = True
    nfw = pack_bitmap(hit, rows * 128) & reach & ~vw
    planes2 = planes.clone()
    for b in range(planes.shape[0] // rows):
        if (d >> b) & 1:
            planes2[b * rows:(b + 1) * rows] |= nfw
    n_new = unpack_bitmap(nfw, n_bits).sum().to(torch.int32).reshape(1)
    return nfw, vw | nfw, planes2, n_new


def step_reference(offsets: torch.Tensor, in_src: torch.Tensor,
                   fw: torch.Tensor, vw: torch.Tensor,
                   planes: torch.Tensor, d: int, reach: torch.Tensor,
                   dst: torch.Tensor = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Plain PyTorch version of one level: gathers the frontier bit of
    every in-edge's source, ORs them per destination (`index_add_` of
    the hits) and packs the result.  Pure: returns (nfw, vw', planes',
    n_new) as new tensors.  `dst` is the destination of each CSC edge,
    recomputed from `offsets` when not given."""
    n = offsets.shape[0] - 1
    rows = fw.shape[0]
    n_bits = rows * 128 * 32
    if dst is None:
        dst = torch.repeat_interleave(
            torch.arange(n, device=offsets.device),
            (offsets[1:] - offsets[:-1]).long())
    hit = unpack_bitmap(fw, n_bits)[in_src.long()]
    count = torch.zeros(n_bits, dtype=torch.int32, device=fw.device)
    count.index_add_(0, dst.long(), hit.to(torch.int32))
    touched = pack_bitmap(count > 0, rows * 128)
    nfw = touched & reach & ~vw
    planes2 = planes.clone()
    for b in range(planes.shape[0] // rows):
        if (d >> b) & 1:
            planes2[b * rows:(b + 1) * rows] |= nfw
    n_new = unpack_bitmap(nfw, n_bits).sum().to(torch.int32).reshape(1)
    return nfw, vw | nfw, planes2, n_new


class MegaStepper:
    """One BFS level per call over an n-vertex graph.

    `col_offsets` (n+1,) and `in_src` (m,) are the graph's CSC (the CSR
    of its transpose), on the host; they are put on `device` once.
    `out_edges`, when given, returns the graph's out-CSR (offsets,
    destinations) as int32 tensors on `device` (a `SearchGraph` passes
    its `reverse`, which a symmetric graph answers with the CSC itself
    and the chain kernel shares); otherwise the out-CSR is built from
    the CSC at first need."""

    def __init__(self, col_offsets: np.ndarray, in_src: np.ndarray,
                 device: torch.device,
                 out_edges: Optional[Callable[[], Tuple[torch.Tensor,
                                                        torch.Tensor]]]
                 = None):
        n = int(col_offsets.shape[0] - 1)
        m = int(in_src.shape[0])
        if m >= 2**31:
            raise ValueError(f"{m} edges do not fit int32 CSC offsets")
        self.n = n
        self.rows = word_rows(n)
        self.n_words = self.rows * 128
        with trace.span("gt.setup.upload"):
            self.offsets = torch.from_numpy(trace.h2d(np.ascontiguousarray(
                col_offsets, dtype=np.int32))).to(device)
            self.in_src = torch.from_numpy(trace.h2d(np.ascontiguousarray(
                in_src, dtype=np.int32))).to(device)
        self.device = self.offsets.device    # with its index on CUDA
        self._dst = None
        self._out_edges = out_edges
        self._out = None
        self._slots = None      # the kernel's stats slots (CUDA)
        self._hub_tag = None    # (n,) the launch number that listed a hub
        self._seq = 0           # the last launch's number (counts by 2)
        self._slot = 0          # the slot the last launch filled
        self._stream = None     # ... on this stream
        self._last_nfw = None   # ... describing this frontier
        self._next = None       # the zeroed buffer of the next nfw, n_new
        self._start = None      # (fw, psrc, candidates) `start` made last
        self._cpu_direction = None

    def edge_dst(self) -> torch.Tensor:
        """Destination of every CSC edge, cached (for the plain versions;
        `SearchGraph.min_preds` makes its own int32 one per call)."""
        if self._dst is None:
            self._dst = torch.repeat_interleave(
                torch.arange(self.n, device=self.device),
                (self.offsets[1:] - self.offsets[:-1]).long())
        return self._dst

    def out_csr(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(out-offsets (n+1,), out-destinations (m,)) int32 on the
        device: the out-CSR the push reads."""
        if self._out is None:
            if self._out_edges is not None:
                self._out = self._out_edges()
            else:
                from gunrockinst_tpu_torch.ops.value import out_csr_of
                self._out = out_csr_of(self.offsets, self.in_src)[:2]
        return self._out

    def _check(self, fw, vw, planes, d, reach, direction) -> int:
        rows = self.rows
        if direction not in DIRECTIONS:
            raise ValueError(f"direction must be one of {DIRECTIONS}, not "
                             f"{direction!r}")
        for name, t in (("fw", fw), ("vw", vw), ("reach", reach),
                        ("planes", planes)):
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous int32 "
                                 "tensor")
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, the graph on "
                                 f"{self.device}")
        for name, t in (("fw", fw), ("vw", vw), ("reach", reach)):
            if tuple(t.shape) != (rows, 128):
                raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                                 f"expected ({rows}, 128)")
        if (planes.dim() != 2 or planes.shape[1] != 128
                or planes.shape[0] % rows or planes.shape[0] == 0):
            raise ValueError(f"planes has shape {tuple(planes.shape)}, "
                             f"expected (P*{rows}, 128)")
        if len({t.data_ptr() for t in (fw, vw, reach, planes)}) != 4:
            raise ValueError("fw, vw, reach and planes must be distinct "
                             "buffers")
        if not 0 < int(d) < 2**31:
            raise ValueError(f"depth {d} out of range")
        return planes.shape[0] // rows

    def start(self, psrc: int, candidates: Optional[int] = None
              ) -> torch.Tensor:
        """The word map holding only vertex `psrc`, the frontier of a
        search's first level.  Given `candidates` (reach & ~{psrc}, as
        the caller's host masks count them), the kernel takes that level
        with the counts of the start vertex alone and no stats pass."""
        fw = start_words(int(psrc), self.rows, self.device)
        self._start = (None if candidates is None
                       else (fw, int(psrc), int(candidates)))
        return fw

    def last_direction(self) -> str:
        """The order the last call took ("push" or "pull"); on the card
        this reads the kernel's slot (a host sync).  For the smoke run
        and the tests."""
        if self.device.type == "cpu":
            if self._cpu_direction is None:
                raise RuntimeError("no level has run yet")
            return self._cpu_direction
        if self._slots is None:
            raise RuntimeError("no level has run yet")
        at = self._slot * self._slot_ints + _DIR_AT
        return {1: "push", 2: "pull"}[int(self._slots[at].item())]

    def step(self, fw: torch.Tensor, vw: torch.Tensor,
             planes: torch.Tensor, d: int, reach: torch.Tensor,
             direction: str = "auto"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Claim level `d`: returns (nfw, n_new (1,) int32 on the
        device) and updates `vw` and `planes` in place.  `direction`
        ("auto", "push", "pull") forces an order for the smoke run and
        the tests; every order gives the same bits."""
        n_planes = self._check(fw, vw, planes, d, reach, direction)
        if fw.device.type == "cpu":
            if direction == "auto":
                out_off, _ = self.out_csr()
                direction = choose_direction(
                    *level_stats(out_off, fw, vw, reach))
            if direction == "push":
                out_off, out_dst = self.out_csr()
                nfw, vw2, planes2, n_new = push_reference(
                    out_off, out_dst, fw, vw, planes, int(d), reach)
            else:
                nfw, vw2, planes2, n_new = step_reference(
                    self.offsets, self.in_src, fw, vw, planes, int(d),
                    reach, self.edge_dst())
            self._cpu_direction = direction
            vw.copy_(vw2)
            planes.copy_(planes2)
            return nfw, n_new
        if fw.device.type != "cuda":
            raise ValueError(f"no step kernel for device {fw.device}")
        return self._launch(fw, vw, planes, int(d), reach, direction,
                            n_planes)

    def _launch(self, fw, vw, planes, d, reach, direction, n_planes):
        if self._slots is None:
            ints = _build.load("mega_step").gt_mega_slot_ints
            ints.argtypes, ints.restype = [], ctypes.c_int
            self._slot_ints = ints() // _SLOTS
            self._slots = torch.zeros(_SLOTS * self._slot_ints,
                                      dtype=torch.int32, device=self.device)
            self._hub_tag = torch.zeros(max(self.n, 1), dtype=torch.int32,
                                        device=self.device)
            out_off, out_dst = self.out_csr()
            # the graph's and the slots' pointers, the same every call
            self._ptrs = (self.offsets.data_ptr(), self.in_src.data_ptr(),
                          out_off.data_ptr(), out_dst.data_ptr())
            self._slot_ptrs = (self._slots.data_ptr(),
                               self._hub_tag.data_ptr())
        stream = _raw_stream(self.device.index)
        # slots rotate: the last launch read slot s - 1 and filled slot s
        # (and cleared the other two)
        s = self._slot
        start, start_cand, stats_slot = -1, 0, -1
        if fw is self._last_nfw and stream == self._stream:
            in_slot, out_slot = s, (s + 1) % _SLOTS
        else:
            in_slot, out_slot = (s + 1) % _SLOTS, (s + 2) % _SLOTS
            first = self._start
            if first is not None and first[0] is fw:
                start, start_cand = first[1], first[2]
            elif direction != "pull":
                stats_slot = in_slot
        if self._next is None or stream != self._stream:
            buf = torch.zeros((self.rows + 1, 128), dtype=torch.int32,
                              device=self.device)
        else:
            buf = self._next
        nxt = torch.empty((self.rows + 1, 128), dtype=torch.int32,
                          device=self.device)
        nfw, n_new = buf[:self.rows], buf[self.rows, :1]
        self._last_nfw = self._next = None
        self._seq += 2
        err = _kernel_fn()(
            *self._ptrs, fw.data_ptr(), vw.data_ptr(), reach.data_ptr(),
            planes.data_ptr(), nfw.data_ptr(), nxt.data_ptr(),
            n_new.data_ptr(), *self._slot_ptrs, self._seq, in_slot,
            out_slot, stats_slot, start, start_cand, self.n, self.n_words,
            n_planes, d, _CODE[direction], stream)
        if err != 0:
            self._slots.zero_()
            raise RuntimeError(f"mega_step kernel launch failed: CUDA "
                               f"error {err}")
        trace.count("launch.mega_step")
        self._slot, self._stream = out_slot, stream
        self._last_nfw, self._next = nfw, nxt
        return nfw, n_new
