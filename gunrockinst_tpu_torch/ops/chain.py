"""Whole-search BFS: the Hopper kernel `csrc/chain_bfs.cu`, its wrapper
`ChainBfs`, its plain PyTorch version and its launch counter.

Counterpart of the JAX package's `ops/pallas_mega.py::ChainBfs` (kernel
`_make_chain_kernel`, pallas_mega.py:566).  One call runs a whole BFS
from `psrc` (a search-space id) with the level loop inside the kernel,
for searches too deep for the host level loop of `ops/mega.py`:

    fn(psrc) -> (planes (planes*rows, 128) int32, vw (rows, 128) int32,
                 depth (1,) int32)

with frontier = visited = {psrc} at the start, label plane b holding
bit b of each vertex's level, and `depth` counting the last, empty
level, bounded by n + 1 as the reference's loop is.

The kernel pushes along out-edges (the relabeled CSR; for a symmetric
graph that is the step kernel's device CSC, which is reused), while
the plain version, `chain_reference`, pulls along in-edges as a loop of
`ops/mega.py::step_reference` with full planes.  BFS levels do not
depend on the direction, so the two agree bit for bit.  The wrapper
launches the kernel for CUDA tensors and takes the plain version only
for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from gunrockinst_tpu_torch.ops import _build
from gunrockinst_tpu_torch.ops.mega import step_reference
from gunrockinst_tpu_torch.ops.words import start_words

# Launches of the CUDA kernel; the plain version does not count.
launches = 0


def _kernel_fn():
    fn = _build.load("chain_bfs").gt_chain_bfs
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * 10 + [i32] * 4
                       + [ptr, ctypes.POINTER(ctypes.c_int)])
        fn.restype = i32
    return fn


def chain_reference(offsets: torch.Tensor, in_src: torch.Tensor,
                    psrc: int, n_planes: int, rows: int,
                    dst: torch.Tensor = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: levels of `step_reference` over the CSC
    (`offsets`, `in_src`) from `psrc`, with every vertex reachable,
    until a level claims nothing or n + 1 levels ran.  Returns (planes,
    vw, depth (1,) int32)."""
    n = offsets.shape[0] - 1
    device = offsets.device
    fw = start_words(psrc, rows, device)
    vw = fw.clone()
    planes = torch.zeros((n_planes * rows, 128), dtype=torch.int32,
                         device=device)
    reach = torch.full((rows, 128), -1, dtype=torch.int32, device=device)
    depth = 0
    while depth < n + 1:
        depth += 1
        fw, vw, planes, n_new = step_reference(offsets, in_src, fw, vw,
                                               planes, depth, reach, dst)
        if int(n_new) == 0:
            break
    return planes, vw, torch.tensor([depth], dtype=torch.int32,
                                    device=device)


class ChainBfs:
    """Whole searches over one relabeled graph with `planes` label
    planes.  `g` is the graph's `primitives/bfs_pallas.SearchGraph`:
    its step kernel's device CSC (`g.stepper`) serves as the out-edge
    lists when the graph is symmetric; otherwise the relabeled CSR
    (`g.csr_p`) is put on the device once."""

    def __init__(self, g, planes: int):
        st = g.stepper
        self.n, self.rows, self.n_words = st.n, st.rows, st.n_words
        self.device = st.device
        self.planes = int(planes)
        if not 0 < self.planes <= 31:
            raise ValueError(f"{planes} label planes out of range [1, 31]")
        self.grid_blocks = 0   # the last launch's grid
        self._in = (st.offsets, st.in_src, st.edge_dst)
        if self.device.type != "cuda":
            return
        csr, csc = g.csr_p, g.csc
        if (np.array_equal(csr.row_offsets, csc.row_offsets)
                and np.array_equal(csr.col_indices, csc.col_indices)):
            self.out_off, self.out_dst = st.offsets, st.in_src
        else:
            self.out_off = torch.from_numpy(np.ascontiguousarray(
                csr.row_offsets, dtype=np.int32)).to(self.device)
            self.out_dst = torch.from_numpy(np.ascontiguousarray(
                csr.col_indices, dtype=np.int32)).to(self.device)
        i32 = dict(dtype=torch.int32, device=self.device)
        nw = self.n_words
        # scratch: next words, frontier list (word, bits), touched list,
        # list lengths; the kernel initialises what it reads
        self._scratch = (torch.empty(nw, **i32), torch.empty(nw, **i32),
                         torch.empty(nw, **i32), torch.empty(nw, **i32),
                         torch.empty(4, **i32))

    def __call__(self, psrc: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        global launches
        psrc = int(psrc)
        if not 0 <= psrc < self.n:
            raise ValueError(f"source vertex {psrc} out of range "
                             f"[0, {self.n})")
        if self.device.type == "cpu":
            offsets, in_src, edge_dst = self._in
            return chain_reference(offsets, in_src, psrc, self.planes,
                                   self.rows, edge_dst())
        if self.device.type != "cuda":
            raise ValueError(f"no chain kernel for device {self.device}")
        planes = torch.empty((self.planes * self.rows, 128),
                             dtype=torch.int32, device=self.device)
        vw = torch.empty((self.rows, 128), dtype=torch.int32,
                         device=self.device)
        depth = torch.empty(1, dtype=torch.int32, device=self.device)
        grid = ctypes.c_int(0)
        err = _kernel_fn()(
            self.out_off.data_ptr(), self.out_dst.data_ptr(),
            planes.data_ptr(), vw.data_ptr(),
            *(t.data_ptr() for t in self._scratch), depth.data_ptr(),
            psrc, self.n_words, self.planes, self.n + 1,
            torch.cuda.current_stream(self.device).cuda_stream,
            ctypes.byref(grid))
        if err != 0:
            raise RuntimeError(f"chain_bfs kernel launch failed: CUDA "
                               f"error {err}")
        self.grid_blocks = grid.value
        launches += 1
        return planes, vw, depth
