"""2-D grid (lattice) graph generator: the road-network graph class.

A copy of the JAX package's `graph/lattice.py` (NumPy only): the same
(side, diagonal, with_values, seed) give the same edges and weights.

Road networks (the reference's roadNet-CA, belgium_osm, road_usa) have
bounded degree (<= 4 here, <= 8 with `diagonal`) and a diameter of about
2 * side, so their searches are thousands of levels deep with tiny
frontiers: the graph class that the whole-search kernel
(`ops/chain.py`) is for.  The generator stands in for those downloaded
datasets offline.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from gunrockinst_tpu_torch.graph.coo import CooGraph
from gunrockinst_tpu_torch.graph.csr import CsrGraph


def grid_coo(side: int, diagonal: bool = False,
             with_values: bool = False, seed: int = 0) -> CooGraph:
    """side x side 4-neighbour lattice as a directed COO edge list (both
    directions of every lattice edge, like an undirected road segment).
    ``diagonal=True`` adds the 8-neighbourhood edges.  The vertex id of
    cell (r, c) is r*side + c."""
    if side < 2:
        raise ValueError("grid side must be >= 2")
    n = side * side
    idx = np.arange(n, dtype=np.int64)
    r, c = idx // side, idx % side

    srcs, dsts = [], []

    def link(mask, dst):
        srcs.append(idx[mask])
        dsts.append(dst[mask])

    link(c + 1 < side, idx + 1)          # east
    link(c > 0, idx - 1)                 # west
    link(r + 1 < side, idx + side)       # south
    link(r > 0, idx - side)              # north
    if diagonal:
        link((r + 1 < side) & (c + 1 < side), idx + side + 1)
        link((r + 1 < side) & (c > 0), idx + side - 1)
        link((r > 0) & (c + 1 < side), idx - side + 1)
        link((r > 0) & (c > 0), idx - side - 1)

    rows = np.concatenate(srcs)
    cols = np.concatenate(dsts)
    values = None
    if with_values:
        # symmetric weights: both directions of a road segment get the
        # same length (keyed on the unordered vertex pair)
        rng = np.random.default_rng(seed)
        lo = np.minimum(rows, cols)
        hi = np.maximum(rows, cols)
        seg_w = rng.integers(1, 64, size=2 * n).astype(np.float32)
        values = seg_w[(lo * 4 + (hi - lo == 1)) % (2 * n)]
    return CooGraph(n, rows, cols, values)


def grid_graph(side: int, diagonal: bool = False,
               with_values: bool = False, seed: int = 0,
               cache_dir: Optional[str] = None) -> CsrGraph:
    """The CSR of a side x side grid, built, or loaded from
    ``cache_dir`` when an earlier call saved it there."""
    tag = (f"grid_s{side}_d{int(diagonal)}_v{int(with_values)}"
           f"_seed{seed}.npz")
    if cache_dir:
        path = os.path.join(cache_dir, tag)
        if os.path.exists(path):
            return CsrGraph.load(path)
    csr = CsrGraph.from_coo(grid_coo(side, diagonal=diagonal,
                                     with_values=with_values, seed=seed))
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        csr.save(os.path.join(cache_dir, tag))
    return csr
