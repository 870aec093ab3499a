"""BFS level step: the Hopper kernel `csrc/mega_step.cu`, its wrapper,
its plain PyTorch version and its launch counter.

Counterpart of the JAX package's `ops/pallas_mega.py::MegaStepper`
(kernel `_make_step_kernel`, pallas_mega.py:422).  One call runs one
BFS level on word maps (`ops/words.py`):

    nfw    = (OR over in-edges u->v of fw[u]) & reach & ~vw
    vw'    = vw | nfw
    planes'[b] = planes[b] | nfw   for every bit b set in d
    n_new  = popcount(nfw)

The TPU plan (hub/packed tiles, 32K-vertex regions, SMEM and VMEM
budgets) does not carry over: the kernel reads a CSC of the graph
directly and skips by destination word.  `reach` must be a superset of
what the search can still claim (`graph/relabel.py::reach_words_for`);
for the inputs a search produces the result equals the reference's bit
for bit.

The wrapper launches the kernel for CUDA tensors and takes the plain
version, `step_reference`, only for CPU tensors.  It updates `vw` and
`planes` in place (the kernel owns each word in one warp, so no copy of
the planes is made per level).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.ops import _build
from gunrockinst_tpu_torch.ops.words import (pack_bitmap, unpack_bitmap,
                                             word_rows)

# Launches of the CUDA kernel; the plain version does not count.
launches = 0


def _kernel_fn():
    fn = _build.load("mega_step").gt_mega_step
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        fn.restype = i32
    return fn


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
    """One BFS level per call over the in-edges of an n-vertex graph.

    `col_offsets` (n+1,) and `in_src` (m,) are the graph's CSC (the CSR
    of its transpose), on the host; they are put on `device` once."""

    def __init__(self, col_offsets: np.ndarray, in_src: np.ndarray,
                 device: torch.device):
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
        self._dst = None

    def edge_dst(self) -> torch.Tensor:
        """Destination of every CSC edge (for the plain version)."""
        if self._dst is None:
            self._dst = torch.repeat_interleave(
                torch.arange(self.n, device=self.device),
                (self.offsets[1:] - self.offsets[:-1]).long())
        return self._dst

    def _check(self, fw, vw, planes, d, reach) -> int:
        rows = self.rows
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

    def step(self, fw: torch.Tensor, vw: torch.Tensor,
             planes: torch.Tensor, d: int, reach: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Claim level `d`: returns (nfw, n_new (1,) int32 on the
        device) and updates `vw` and `planes` in place."""
        global launches
        n_planes = self._check(fw, vw, planes, d, reach)
        if fw.device.type == "cpu":
            nfw, vw2, planes2, n_new = step_reference(
                self.offsets, self.in_src, fw, vw, planes, int(d), reach,
                self.edge_dst())
            vw.copy_(vw2)
            planes.copy_(planes2)
            return nfw, n_new
        if fw.device.type != "cuda":
            raise ValueError(f"no step kernel for device {fw.device}")
        nfw = torch.empty_like(fw)
        n_new = torch.empty(1, dtype=torch.int32, device=fw.device)
        err = _kernel_fn()(
            self.offsets.data_ptr(), self.in_src.data_ptr(),
            fw.data_ptr(), vw.data_ptr(), reach.data_ptr(),
            planes.data_ptr(), nfw.data_ptr(), n_new.data_ptr(),
            self.n, self.n_words, n_planes, int(d),
            torch.cuda.current_stream(fw.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"mega_step kernel launch failed: CUDA "
                               f"error {err}")
        launches += 1
        return nfw, n_new
