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

# Launches of the CUDA kernel; the plain version does not count.
launches = 0


def _kernel_fn():
    fn = _build.load("touch_sweep").gt_touch_sweep
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 5 + [i32] * 2 + [ptr]
        fn.restype = i32
    return fn


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

    def _sweep(self, fw: torch.Tensor,
               vw: Optional[torch.Tensor]) -> torch.Tensor:
        global launches
        if fw.device.type == "cpu":
            return touch_reference(self.offsets, self.in_src, fw, vw,
                                   self.edge_dst())
        if fw.device.type != "cuda":
            raise ValueError(f"no sweep kernel for device {fw.device}")
        out = torch.empty_like(fw)
        err = _kernel_fn()(
            self.offsets.data_ptr(), self.in_src.data_ptr(),
            fw.data_ptr(), None if vw is None else vw.data_ptr(),
            out.data_ptr(), self.n, self.n_words,
            torch.cuda.current_stream(fw.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"touch_sweep kernel launch failed: CUDA "
                               f"error {err}")
        launches += 1
        return out

    def __call__(self, fw: torch.Tensor) -> torch.Tensor:
        """Touched words of frontier words `fw`."""
        self._check(fw=fw)
        return self._sweep(fw, None)

    def sweep_fused(self, fw: torch.Tensor, vw: torch.Tensor
                    ) -> torch.Tensor:
        """touched & ~vw: the next frontier of a search whose visited
        words are `vw`."""
        self._check(fw=fw, vw=vw)
        return self._sweep(fw, vw)
