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

The kernel runs the whole search on one thread-block cluster and
pushes along out-edges (`SearchGraph.reverse()`: the relabeled CSR,
which for a symmetric graph is the step kernel's device CSC, so nothing
is uploaded twice).  The cluster and the place of the visited map are
chosen from the level widths a search of the graph is known to have
(`layout`, `widths`): a search with few wide levels (at most one level
in WIDE_SHARE claiming more than NARROW_LEVEL vertices: a road
network's wavefront, or a scale-free core with a long thin tail) runs
on one block with the map in its shared memory, where a thin level
costs least and claims are shared-memory atomics; a search with many
wide levels, or one whose widths are unknown, on GLOBAL_CLUSTER blocks
with the map in global memory, whose eight times the threads take a
wide level of low-degree vertices in fewer dependent passes.  The BFS
route passes the widths its 8-plane host level loop counted before it
sent the graph here.  `map_cap` caps the
shared-memory bytes the map may take, so that the smoke run and the
tests can force the global placement (0).  The plain version,
`chain_reference`, pulls along in-edges as a loop of `ops/mega.py::step_reference` with full
planes.  BFS levels do not depend on the direction, so the two agree
bit for bit.  The wrapper launches the kernel for CUDA tensors and
takes the plain version only for CPU tensors; a cluster size or
shared-memory budget the card refuses raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from gunrockinst_tpu_torch.ops import _build
from gunrockinst_tpu_torch.ops.mega import step_reference
from gunrockinst_tpu_torch.ops.words import start_words
from gunrockinst_tpu_torch.utils import trace

GLOBAL_CLUSTER = 8   # blocks when the map is in global memory (chain_bfs.cu's
                     # kGlobalCluster); one block holds a shared-memory map
NARROW_LEVEL = 2048  # a wider level costs one block more than two passes
WIDE_SHARE = 8       # one block while at most 1 level in 8 is wider
LIST_CAP = 8192      # frontier list entries kept in shared memory, each list
_FAILED = {1: "the shared-memory opt-in", 2: "the cluster occupancy query",
           3: "a cluster of this size and shared memory (none fits the card)",
           4: "the launch"}


def _kernel_fn():
    fn = _build.load("chain_bfs").gt_chain_bfs
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * 7 + [i32] * 7
                       + [ptr, ctypes.POINTER(ctypes.c_int)])
        fn.restype = i32
    return fn


def _smem_limit() -> int:
    """The dynamic shared-memory bytes one block of the kernel may hold
    on the current card: the opt-in limit less its static shared
    memory."""
    fn = _build.load("chain_bfs").gt_chain_bfs_smem_limit
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    got = ctypes.c_int(0)
    err = fn(ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"chain_bfs shared-memory query failed: CUDA "
                           f"error {err}")
    return got.value


def layout(n_words: int, limit_bytes: int, cap: Optional[int] = None,
           widths: Optional[Sequence[int]] = None) -> Tuple[int, int]:
    """(cluster, q) of a search over n_words visited words, with
    `limit_bytes` of shared memory a block: one block with the map in its
    shared memory when the search is narrow (`widths`, the vertices its
    levels claim, are known and at most one level in WIDE_SHARE claims
    more than NARROW_LEVEL) and the map's 4 * n_words bytes fit
    `limit_bytes` (and `cap`, when a cap is given), else GLOBAL_CLUSTER
    blocks and the map in global memory; then the frontier list entries
    q that the rest of a block's shared memory holds, at most LIST_CAP,
    in each of the two lists."""
    if n_words < 0 or limit_bytes < 0 or (widths is not None
                                          and any(w < 0 for w in widths)):
        raise ValueError(f"{n_words} visited words with {limit_bytes} "
                         f"bytes of shared memory a block, level widths "
                         f"{widths}")
    budget = limit_bytes if cap is None else min(limit_bytes, cap)
    narrow = bool(widths) and WIDE_SHARE * sum(
        w > NARROW_LEVEL for w in widths) <= len(widths)
    if narrow and 0 < 4 * n_words <= budget:
        cluster, map_bytes = 1, 4 * n_words
    else:
        cluster, map_bytes = GLOBAL_CLUSTER, 0
    return cluster, max(min(LIST_CAP, (limit_bytes - map_bytes) // 8), 0)


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
    planes.  `g` is the graph's `primitives/bfs_pallas.SearchGraph`;
    the out-edge lists are `g.reverse()`.  `widths` are the vertices
    each level of a search of the graph claimed, where known (None: not
    known); they pick the layout (`layout`).  `map_cap` (bytes, None for
    no cap) caps the shared memory the visited map may take; it is for
    the smoke run and the tests, which force the global-memory placement
    with 0."""

    def __init__(self, g, planes: int, map_cap: Optional[int] = None,
                 widths: Optional[Sequence[int]] = None):
        st = g.stepper
        self.n, self.rows, self.n_words = st.n, st.rows, st.n_words
        self.device = st.device
        self.planes = int(planes)
        if not 0 < self.planes <= 31:
            raise ValueError(f"{planes} label planes out of range [1, 31]")
        if map_cap is not None and (isinstance(map_cap, bool)
                                    or not isinstance(map_cap, int)
                                    or map_cap < 0):
            raise ValueError(f"map_cap must be a non-negative number of "
                             f"bytes, not {map_cap!r}")
        if widths is not None and (
                isinstance(widths, (str, bytes)) or not all(
                    isinstance(w, int) and not isinstance(w, bool)
                    and w >= 0 for w in widths)):
            raise ValueError(f"widths must be non-negative numbers of "
                             f"vertices, not {widths!r}")
        self.map_cap = map_cap
        self.widths = None if widths is None else tuple(widths)
        # the last launch's cluster size (1: the map in shared memory)
        # and frontier list entries in shared memory
        self.cluster, self.q = 0, 0
        self._in = (st.offsets, st.in_src, st.edge_dst)
        if self.device.type != "cuda":
            return
        self.out_off, self.out_dst = g.reverse()
        # scratch: the two frontier lists past their shared-memory part,
        # and the level of each claimed vertex
        self._lists = torch.empty(2 * self.n, dtype=torch.int32,
                                  device=self.device)
        self._level = torch.empty(self.n, dtype=torch.int32,
                                  device=self.device)

    def __call__(self, psrc: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
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
        self.cluster, self.q = layout(self.n_words, _smem_limit(),
                                      self.map_cap, self.widths)
        shared_map = self.cluster == 1
        failed = ctypes.c_int(0)
        err = _kernel_fn()(
            self.out_off.data_ptr(), self.out_dst.data_ptr(),
            planes.data_ptr(), vw.data_ptr(), self._lists.data_ptr(),
            self._level.data_ptr(), depth.data_ptr(), psrc, self.n,
            self.n_words, self.planes, self.n + 1, int(shared_map), self.q,
            torch.cuda.current_stream(self.device).cuda_stream,
            ctypes.byref(failed))
        if err != 0:
            raise RuntimeError(
                f"chain_bfs kernel: {_FAILED.get(failed.value, 'a step')} "
                f"failed (CUDA error {err}; a cluster of {self.cluster} "
                f"blocks, {4 * self.n_words * shared_map + 8 * self.q} "
                f"bytes of shared memory each)")
        trace.count("launch.chain_bfs")
        return planes, vw, depth
