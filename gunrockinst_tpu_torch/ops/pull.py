"""Touched sweep: the Hopper kernel `csrc/touch_sweep.cu`, its wrapper,
its plain PyTorch version and its launch counter.

One kernel stands for three TPU sweepers of the JAX package, which
compute one function and differ only in their TPU tile placement:
`ops/pallas_advance.py::PullSweeper` (kernels `_pull_kernel` :144 and
`_pull_kernel_fused` :191), `ops/pallas_advance_v2.py::PullSweeperV2`
(`_hub_kernel` :291, `_packed_kernel` :317) and
`ops/pallas_advance_v3.py::PullSweeperV3` (`_packed_kernel_v3` :372).
On word maps (`ops/words.py`):

    touched = OR over in-edges u->v of fw[u]     (PullSweeper.__call__)
    touched & ~vw                                (PullSweeper.sweep_fused)

The fused form is `_pull_kernel_fused` with the visited words in place
of the reference's unvisited words.

On the card each block of the plain sweep first copies the frontier
words into shared memory, as many as the card lets one block hold
(`staged_words`); `stage_cap` caps those bytes, for tests that make the
kernel read the rest from L2.  A budget the card refuses raises.  The
fused form reads the frontier words of unvisited vertices only, and
stages none.

The wrapper launches the kernel for CUDA tensors and takes the plain
version, `touch_reference`, only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from gunrockinst_tpu_torch.ops import _build
from gunrockinst_tpu_torch.ops.words import (pack_bitmap, unpack_bitmap,
                                             word_rows)
from gunrockinst_tpu_torch.utils import trace

HEAD = 128   # a list's first ids, read by the sweep; the tail walk reads on
TAIL_CHUNK = 512    # ids of a list's tail that one warp of the walk takes
ALIGN = 16   # bytes: fw starts on this boundary
NO_TAIL = 2**31 - 1   # a head that covers every list: no tail walk


def _kernel_fn():
    fn = _build.load("touch_sweep").gt_touch_sweep
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        fn.restype = i32
    return fn


def _smem_limit() -> int:
    """The dynamic shared-memory bytes one block of the kernel may stage
    on the current card: the opt-in limit less its static shared
    memory."""
    got = ctypes.c_int(0)
    err = _build.load("touch_sweep").gt_touch_sweep_smem_limit(
        ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"touch_sweep shared-memory query failed: CUDA "
                           f"error {err}")
    return got.value


def tail_room(offsets: torch.Tensor, head: int, chunk: int) -> int:
    """Pieces the tail walk may be handed in one sweep: the ids of every
    in-list past its first `head`, in pieces of at most `chunk`."""
    past = ((offsets[1:] - offsets[:-1]).long() - head).clamp(min=0)
    return int(((past + chunk - 1) // chunk).sum())


def _check_cap(stage_cap: Optional[int]) -> Optional[int]:
    if stage_cap is None:
        return None
    if isinstance(stage_cap, bool) or not isinstance(stage_cap, int) \
            or stage_cap < 0:
        raise ValueError(f"stage_cap must be a non-negative number of "
                         f"bytes, not {stage_cap!r}")
    return stage_cap


def staged_words(n_words: int, limit_bytes: int) -> int:
    """How many leading frontier words a block stages in `limit_bytes`
    of shared memory: all n_words if they fit, else the most that fit in
    whole 16-byte steps (the bulk copy's unit)."""
    if limit_bytes < 0:
        raise ValueError(f"a shared-memory limit of {limit_bytes} bytes")
    return min(n_words, limit_bytes // 16 * 4)


def touch_reference(offsets: torch.Tensor, in_src: torch.Tensor,
                    fw: torch.Tensor, vw: Optional[torch.Tensor] = None,
                    dst: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: gathers the frontier bit of every
    in-edge's source, ORs them per destination (`index_add_` of the
    hits) and packs the result; with `vw`, ANDs in ~vw.  `dst` is the
    destination of each CSC edge, recomputed from `offsets` when not
    given."""
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
    return touched if vw is None else touched & ~vw


class PullSweeper:
    """Touched sweeps over the in-edges of an n-vertex graph.

    `col_offsets` (n+1,) and `in_src` (m,) are the graph's CSC (the CSR
    of its transpose), on the host; they are put on `device` once.
    `stage_cap` (bytes) caps the frontier words a block of the kernel
    stages in shared memory; None takes the card's whole budget.  `fw`
    must start on an ALIGN (16) byte boundary, the bulk copy's unit, as
    every tensor PyTorch allocates does; a view such as `x[1:]` may
    not."""

    def __init__(self, col_offsets: np.ndarray, in_src: np.ndarray,
                 device: torch.device, stage_cap: Optional[int] = None):
        n = int(col_offsets.shape[0] - 1)
        m = int(in_src.shape[0])
        if m >= 2**31:
            raise ValueError(f"{m} edges do not fit int32 CSC offsets")
        self.n = n
        self.rows = word_rows(n)
        self.n_words = self.rows * 128
        self.offsets = torch.from_numpy(
            np.ascontiguousarray(col_offsets, dtype=np.int32)).to(device)
        self.in_src = torch.from_numpy(
            np.ascontiguousarray(in_src, dtype=np.int32)).to(device)
        self.device = self.offsets.device    # with its index on CUDA
        self.stage_cap = _check_cap(stage_cap)
        self.staged = None      # frontier words staged, set on the card
        self._tails = None      # the tail walk's scratch, on the card
        self._parity = 0        # which tail count the next sweep uses
        self._dst = None

    def edge_dst(self) -> torch.Tensor:
        """Destination of every CSC edge (for the plain version)."""
        if self._dst is None:
            self._dst = torch.repeat_interleave(
                torch.arange(self.n, device=self.device),
                (self.offsets[1:] - self.offsets[:-1]).long())
        return self._dst

    def _check(self, **maps):
        for name, t in maps.items():
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous int32 "
                                 "tensor")
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, the graph on "
                                 f"{self.device}")
            if tuple(t.shape) != (self.rows, 128):
                raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                                 f"expected ({self.rows}, 128)")
        if maps["fw"].data_ptr() % ALIGN:
            raise ValueError(f"fw must start on a {ALIGN}-byte boundary: "
                             "the kernel copies it to shared memory in "
                             "16-byte units")

    def _sweep(self, fw: torch.Tensor,
               vw: Optional[torch.Tensor]) -> torch.Tensor:
        if fw.device.type == "cpu":
            return touch_reference(self.offsets, self.in_src, fw, vw,
                                   self.edge_dst())
        if fw.device.type != "cuda":
            raise ValueError(f"no sweep kernel for device {fw.device}")
        if self.staged is None:
            with torch.cuda.device(fw.device):
                limit = _smem_limit()
            if self.stage_cap is not None:
                limit = min(limit, self.stage_cap)
            self.staged = staged_words(self.n_words, limit)
            room = tail_room(self.offsets, HEAD, TAIL_CHUNK)
            self._tails = (torch.empty(3 * max(room, 1), dtype=torch.int32,
                                       device=self.device),
                           torch.zeros(2, dtype=torch.int32,
                                       device=self.device), room)
        tails, counters, room = self._tails
        staged, head = self.staged, HEAD
        if vw is not None:
            # the fused form reads the frontier words of unvisited vertices
            # only, and its walks are short: staging and the tail walk's
            # grid barrier cost more than they save (PERF.md section 6)
            staged, head, room = 0, NO_TAIL, 0
        out = torch.empty_like(fw)
        err = _kernel_fn()(
            self.offsets.data_ptr(), self.in_src.data_ptr(),
            fw.data_ptr(), None if vw is None else vw.data_ptr(),
            out.data_ptr(), tails.data_ptr(), counters.data_ptr(), self.n,
            self.n_words, staged, head, TAIL_CHUNK, room, self._parity,
            torch.cuda.current_stream(fw.device).cuda_stream)
        if err != 0:
            counters.zero_()
            raise RuntimeError(f"touch_sweep kernel launch failed: CUDA "
                               f"error {err}")
        self._parity ^= 1
        trace.count("launch.touch_sweep")
        return out

    def __call__(self, fw: torch.Tensor) -> torch.Tensor:
        """Touched words of frontier words `fw`.  On the card the tail
        walk's scratch belongs to the sweeper, so one sweeper runs one
        sweep at a time (PyTorch's current stream orders them)."""
        self._check(fw=fw)
        return self._sweep(fw, None)

    def sweep_fused(self, fw: torch.Tensor, vw: torch.Tensor
                    ) -> torch.Tensor:
        """touched & ~vw: the next frontier of a search whose visited
        words are `vw`."""
        self._check(fw=fw, vw=vw)
        return self._sweep(fw, vw)
