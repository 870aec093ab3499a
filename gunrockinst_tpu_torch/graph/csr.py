"""Host CSR graph container (NumPy), without JAX.

The counterpart of the JAX package's `graph/csr.py::CsrGraph`: the same
construction (`from_coo` sorts, drops duplicate edges and self-loops,
and builds offsets), the same transpose and degree statistics, so that a
graph built here holds the same arrays as one built there.  The device
form lives with each kernel that needs it (for BFS, the CSC that
`ops/mega.py` puts on the card), not in a padded `DeviceGraph`.

`CsrGraph.from_arrays` carries a graph across from the reference: it
wraps the reference graph's NumPy arrays in the port's container.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gunrockinst_tpu_torch.graph.coo import CooGraph


@dataclasses.dataclass(eq=False)  # identity-hashable: used as cache key
class CsrGraph:
    """Host CSR: ``row_offsets`` (n+1,), ``col_indices`` (m,) and
    optional ``edge_values`` (m,)."""

    row_offsets: np.ndarray
    col_indices: np.ndarray
    edge_values: Optional[np.ndarray] = None

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
        return CsrGraph.from_coo(self.to_coo().reversed(), dedupe=False)

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
        np.savez(path, **arrays)

    @staticmethod
    def load(path: str) -> "CsrGraph":
        with np.load(path) as z:
            return CsrGraph(
                row_offsets=z["row_offsets"],
                col_indices=z["col_indices"],
                edge_values=z["edge_values"] if "edge_values" in z else None,
            )
