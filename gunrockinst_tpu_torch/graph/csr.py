"""CSR graph containers: the host `CsrGraph` (NumPy) and the padded
`DeviceGraph` (torch tensors on one device).

The counterpart of the JAX package's `graph/csr.py`.  `CsrGraph` has the
same construction (`from_coo` sorts, drops duplicate edges and
self-loops, and builds offsets), the same transpose, degree statistics
and `.npz` cache, so that a graph built here holds the same arrays as
one built there.  `CsrGraph.from_arrays` carries a graph across from the
reference: it wraps the reference graph's NumPy arrays in the port's
container.

`DeviceGraph` is the padded form the operator layer (`ops/advance.py`,
`ops/filter.py`, `ops/segment.py`) and the primitives' default modes
read, field for field the reference's:

  * vertex arrays sized ``n_pad`` (a multiple of 128, ``>= n+1``);
    vertex id ``n`` is the dummy that padding points at;
  * edge arrays sized ``m_pad`` (a multiple of 128); padding edges are
    ``(n -> n)`` with weight 0, and offsets past ``n`` clamp to ``m``;
  * the CSR (edges sorted by source) and, with ``with_csc``, the CSC
    (a stable sort by destination, so each destination's sources stay
    ascending) with the CSR id of each CSC slot (``csc_edge_id``).

Every index is int32 and every weight float32, as in the reference
(JAX without x64).  The kernels' own device forms (the relabeled CSC of
`ops/mega.py`) are separate and are not built from it.

`derived(csr, key, build)` is the port's one cache of what it derives
from a host graph: each object lives exactly as long as its graph.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Hashable, Optional, TypeVar

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.coo import CooGraph
from gunrockinst_tpu_torch.utils import trace

LANE = 128

T = TypeVar("T")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(eq=False)  # identity-hashable: used as cache key
class CsrGraph:
    """Host CSR: ``row_offsets`` (n+1,), ``col_indices`` (m,),
    optional ``edge_values`` (m,) and ``node_values`` (n,)."""

    row_offsets: np.ndarray
    col_indices: np.ndarray
    edge_values: Optional[np.ndarray] = None
    node_values: Optional[np.ndarray] = None

    def __getstate__(self) -> dict:
        """The arrays only: what `derived` built for the graph (device
        tensors, kernel handles) stays with this copy."""
        return {k: v for k, v in self.__dict__.items() if k != "_derived"}

    @property
    def num_nodes(self) -> int:
        return int(self.row_offsets.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.col_indices.shape[0])

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_arrays(row_offsets, col_indices,
                    edge_values=None) -> "CsrGraph":
        """Wrap existing CSR arrays (e.g. another package's graph) after
        checking that they form a CSR: offsets start at 0, never
        decrease and end at the edge count; column ids lie in [0, n)."""
        ro = np.asarray(row_offsets)
        ci = np.asarray(col_indices)
        if ro.ndim != 1 or ro.shape[0] < 1 or ci.ndim != 1:
            raise ValueError("row_offsets must be (n+1,) and "
                             "col_indices (m,)")
        n = ro.shape[0] - 1
        if (int(ro[0]) != 0 or int(ro[-1]) != ci.shape[0]
                or np.any(np.diff(ro) < 0)):
            raise ValueError("row_offsets is not a CSR offset array "
                             f"for {ci.shape[0]} edges")
        if ci.size and (int(ci.min()) < 0 or int(ci.max()) >= n):
            raise ValueError(f"col_indices out of range [0, {n})")
        ev = None if edge_values is None else np.asarray(edge_values)
        if ev is not None and ev.shape != ci.shape:
            raise ValueError("edge_values must match col_indices")
        return CsrGraph(row_offsets=ro.copy(), col_indices=ci.copy(),
                        edge_values=None if ev is None else ev.copy())

    @staticmethod
    def from_coo(coo: CooGraph, undirected: bool = False,
                 dedupe: bool = True,
                 remove_self_loops: bool = True) -> "CsrGraph":
        """Build CSR from an edge list: sort, drop duplicate edges and
        self-loops (the reference's Csr::FromCoo, gunrock/csr.cuh)."""
        if undirected:
            coo = coo.with_reverse_edges()
        if remove_self_loops:
            coo = coo.without_self_loops()
        coo = coo.deduped() if dedupe else coo.row_sorted()
        n, m = coo.num_nodes, coo.num_edges
        counts = np.bincount(coo.rows, minlength=n).astype(np.int64)
        row_offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=row_offsets[1:])
        dtype = np.int32 if m < 2**31 else np.int64
        return CsrGraph(
            row_offsets=row_offsets.astype(dtype),
            col_indices=coo.cols.astype(np.int32),
            edge_values=(None if coo.values is None
                         else coo.values.astype(np.float32)),
        )

    def to_coo(self) -> CooGraph:
        rows = np.repeat(np.arange(self.num_nodes, dtype=np.int32),
                         np.diff(self.row_offsets))
        return CooGraph(self.num_nodes, rows, self.col_indices.copy(),
                        None if self.edge_values is None
                        else self.edge_values.copy())

    def transposed(self) -> "CsrGraph":
        """CSC of this graph, i.e. CSR of the reverse graph."""
        with trace.span("gt.setup.transpose"):
            return CsrGraph.from_coo(self.to_coo().reversed(),
                                     dedupe=False)

    # -- stats -------------------------------------------------------------

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_offsets).astype(np.int32)

    def average_degree(self) -> float:
        return self.num_edges / max(self.num_nodes, 1)

    # -- binary cache (the reference's csr.cuh:140-246 WriteToFile) --------

    def save(self, path: str) -> None:
        arrays = dict(row_offsets=self.row_offsets,
                      col_indices=self.col_indices)
        if self.edge_values is not None:
            arrays["edge_values"] = self.edge_values
        if self.node_values is not None:
            arrays["node_values"] = self.node_values
        np.savez(path, **arrays)

    @staticmethod
    def load(path: str) -> "CsrGraph":
        with np.load(path) as z:
            return CsrGraph(
                row_offsets=z["row_offsets"],
                col_indices=z["col_indices"],
                edge_values=z["edge_values"] if "edge_values" in z else None,
                node_values=z["node_values"] if "node_values" in z else None,
            )

    # -- device form -------------------------------------------------------

    def to_device(self, with_csc: bool = True,
                  with_values: Optional[bool] = None,
                  device: DeviceLike = None) -> "DeviceGraph":
        return DeviceGraph.build(self, with_csc=with_csc,
                                 with_values=with_values, device=device)


def derived(csr: CsrGraph, key: Hashable, build: Callable[[], T]) -> T:
    """`build()` for `csr` under `key` (what the object depends on besides
    the graph: device, branch, keywords), built on the first call and
    kept exactly as long as `csr` lives.  The table is an attribute of
    the graph, so no table elsewhere holds the graph, and an object that
    refers back to it (the relabeling of a graph that is not renumbered
    is the graph itself) goes with it."""
    table = csr.__dict__.setdefault("_derived", {})
    if key not in table:
        table[key] = build()
    return table[key]


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceGraph:
    """The padded graph on one device (see the module docstring)."""

    n: int
    m: int
    n_pad: int
    m_pad: int

    # CSR (edges sorted by source)
    row_offsets: torch.Tensor     # (n_pad,) int32; entries > n clamp to m
    edge_src: torch.Tensor        # (m_pad,) int32 source per edge
    edge_dst: torch.Tensor        # (m_pad,) int32 destination per edge
    edge_w: torch.Tensor          # (m_pad,) float32 (ones if unweighted)
    out_degree: torch.Tensor      # (n_pad,) int32 (0 at dummy/pad)

    # CSC (edges sorted by destination): the pull direction
    col_offsets: Optional[torch.Tensor] = None   # (n_pad,) int32
    csc_src: Optional[torch.Tensor] = None       # (m_pad,) int32
    csc_dst: Optional[torch.Tensor] = None       # (m_pad,) int32
    csc_w: Optional[torch.Tensor] = None         # (m_pad,) float32
    csc_edge_id: Optional[torch.Tensor] = None   # (m_pad,) int32 CSR id
    in_degree: Optional[torch.Tensor] = None     # (n_pad,) int32

    @property
    def dummy(self) -> int:
        """The padding vertex id (== n)."""
        return self.n

    @property
    def has_csc(self) -> bool:
        return self.col_offsets is not None

    @property
    def device(self) -> torch.device:
        return self.edge_src.device

    @staticmethod
    def build(csr: CsrGraph, with_csc: bool = True,
              with_values: Optional[bool] = None,
              device: DeviceLike = None) -> "DeviceGraph":
        """The padded form of `csr` on `device` (None: the CUDA card):
        the reference's arrays, built on the device from the CSR."""
        dev = resolve_device(device)
        n, m = csr.num_nodes, csr.num_edges
        n_pad = _round_up(n + 1, LANE)
        m_pad = _round_up(max(m, 1), LANE)
        if with_values is None:
            with_values = csr.edge_values is not None
        i32 = dict(dtype=torch.int32, device=dev)

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype)

        def pad_edges(a, fill):
            out = torch.full((m_pad,), fill, dtype=a.dtype, device=dev)
            out[:m] = a
            return out

        def pad_offsets(offsets):
            out = torch.full((n_pad,), m, **i32)
            out[: n + 1] = offsets
            return out

        def pad_degree(offsets):
            out = torch.zeros(n_pad, **i32)
            out[:n] = offsets[1:] - offsets[:-1]
            return out

        row_offsets = put(csr.row_offsets, torch.int32)
        dst = put(csr.col_indices, torch.int32)
        src = torch.repeat_interleave(
            torch.arange(n, **i32), (row_offsets[1:] - row_offsets[:-1]),
            output_size=m)
        if with_values and csr.edge_values is not None:
            ev = put(csr.edge_values, torch.float32)
        else:
            ev = torch.ones(m, dtype=torch.float32, device=dev)

        kwargs = dict(
            n=n, m=m, n_pad=n_pad, m_pad=m_pad,
            row_offsets=pad_offsets(row_offsets),
            edge_src=pad_edges(src, n),
            edge_dst=pad_edges(dst, n),
            edge_w=pad_edges(ev, 0.0),
            out_degree=pad_degree(row_offsets),
        )
        if with_csc:
            # stable sort by destination; keep the CSR edge id of each slot
            order = torch.sort(dst, stable=True).indices.to(torch.int32)
            cdst = dst[order]
            col_offsets = torch.zeros(n + 1, **i32)
            col_offsets[1:] = torch.cumsum(
                torch.bincount(cdst, minlength=n), 0)
            kwargs.update(
                col_offsets=pad_offsets(col_offsets),
                csc_src=pad_edges(src[order], n),
                csc_dst=pad_edges(cdst, n),
                csc_w=pad_edges(ev[order], 0.0),
                csc_edge_id=pad_edges(order, m_pad - 1),
                in_degree=pad_degree(col_offsets),
            )
        return DeviceGraph(**kwargs)

    def reverse_view(self) -> "DeviceGraph":
        """A DeviceGraph whose CSR is this graph's CSC, for primitives
        that advance over the reverse graph.  It has no `csc_edge_id`."""
        if not self.has_csc:
            raise ValueError("reverse_view requires with_csc=True")
        return DeviceGraph(
            n=self.n, m=self.m, n_pad=self.n_pad, m_pad=self.m_pad,
            row_offsets=self.col_offsets,
            edge_src=self.csc_dst, edge_dst=self.csc_src, edge_w=self.csc_w,
            out_degree=self.in_degree,
            col_offsets=self.row_offsets,
            csc_src=self.edge_dst, csc_dst=self.edge_src, csc_w=self.edge_w,
            csc_edge_id=None, in_degree=self.out_degree,
        )
