"""COO edge-list container (host side, NumPy).

Capability parity with the reference's `gunrock/coo.cuh` (edge tuple +
row/column-first sort comparators): here an edge list is three NumPy
arrays and the comparators become `np.lexsort` keys.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CooGraph:
    """Edge list: ``rows[i] -> cols[i]`` with optional ``values[i]``.

    ``num_nodes`` is the vertex-id upper bound (ids are 0-based).
    """

    num_nodes: int
    rows: np.ndarray  # (m,) int32/int64 source vertex ids
    cols: np.ndarray  # (m,) destination vertex ids
    values: Optional[np.ndarray] = None  # (m,) edge values, or None

    @property
    def num_edges(self) -> int:
        return int(self.rows.shape[0])

    def with_reverse_edges(self) -> "CooGraph":
        """Undirected view: append the reverse of every edge.

        Mirrors the reference's undirected .mtx handling
        (gunrock/graphio/market.cuh:118-140 stores both directions).
        """
        rows = np.concatenate([self.rows, self.cols])
        cols = np.concatenate([self.cols, self.rows])
        values = None
        if self.values is not None:
            values = np.concatenate([self.values, self.values])
        return CooGraph(self.num_nodes, rows, cols, values)

    def reversed(self) -> "CooGraph":
        """Swap edge direction (used to build CSC / column offsets)."""
        return CooGraph(self.num_nodes, self.cols.copy(), self.rows.copy(),
                        None if self.values is None else self.values.copy())

    def row_sorted(self) -> "CooGraph":
        """Sort edges row-first then column (RowFirstTupleCompare analog,
        gunrock/coo.cuh:71)."""
        order = np.lexsort((self.cols, self.rows))
        return CooGraph(
            self.num_nodes,
            np.ascontiguousarray(self.rows[order]),
            np.ascontiguousarray(self.cols[order]),
            None if self.values is None else np.ascontiguousarray(self.values[order]),
        )

    def deduped(self) -> "CooGraph":
        """Drop duplicate (row, col) edges, keeping the first occurrence in
        row-major order (Csr::FromCoo dedupe analog, gunrock/csr.cuh:248)."""
        g = self.row_sorted()
        if g.num_edges == 0:
            return g
        keep = np.ones(g.num_edges, dtype=bool)
        keep[1:] = (g.rows[1:] != g.rows[:-1]) | (g.cols[1:] != g.cols[:-1])
        return CooGraph(
            g.num_nodes, g.rows[keep], g.cols[keep],
            None if g.values is None else g.values[keep],
        )

    def without_self_loops(self) -> "CooGraph":
        keep = self.rows != self.cols
        return CooGraph(
            self.num_nodes, self.rows[keep], self.cols[keep],
            None if self.values is None else self.values[keep],
        )
