"""MatrixMarket (.mtx) reader with a binary cache.

Counterpart of the JAX package's `graph/market.py`, after the
reference's `gunrock/graphio/market.cuh` (`ReadMarketStream` :57,
`BuildMarketGraph` :250/301, the binary `.csr` cache :222): parses
coordinate .mtx files (pattern or real, general or symmetric, with or
without the banner line), 1-based ids, and caches the built CSR next to
the file as `<path>[.ud].csr.npz`, re-read only while it is at least as
new as the file.

The native parser (`_native_io.py`, native/graphio.cpp) runs when it
builds and accepts the file; the NumPy parser otherwise, as in the
reference.  `parse_market` says which one ran.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from gunrockinst_tpu_torch.graph import _native_io
from gunrockinst_tpu_torch.graph.coo import CooGraph
from gunrockinst_tpu_torch.graph.csr import CsrGraph


def _parse_mtx_numpy(path: str):
    """Parse .mtx into (n, rows, cols, values|None, symmetric)."""
    symmetric = False
    pattern = True
    header_seen = False
    with open(path, "r") as f:
        first = f.readline()
        if first.startswith("%%MatrixMarket"):
            tokens = first.lower().split()
            symmetric = "symmetric" in tokens or "skew-symmetric" in tokens
            pattern = "pattern" in tokens
            header_seen = True
        else:
            f.seek(0)
        # skip comments, read the size line
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        parts = line.split()
        nrows, ncols, nnz = int(parts[0]), int(parts[1]), int(parts[2])
        n = max(nrows, ncols)
        data = np.loadtxt(f, ndmin=2, dtype=np.float64, max_rows=nnz)
    if data.size == 0:
        data = data.reshape(0, 2)
    # Direction: the reference reads each line as "col row [value]"
    # (market.cuh:150 sscanf reads ll_col first): a line "a b" is the
    # edge (b-1) -> (a-1).
    rows = data[:, 1].astype(np.int64) - 1
    cols = data[:, 0].astype(np.int64) - 1
    values: Optional[np.ndarray] = None
    if data.shape[1] >= 3 and not (header_seen and pattern):
        values = data[:, 2].astype(np.float32)
    return n, rows, cols, values, symmetric


def parse_market(path: str) -> Tuple[tuple, str]:
    """((n, rows, cols, values|None, symmetric), parser): the native
    parser's result, or the NumPy parser's ("numpy") when the native
    library does not build or rejects the file."""
    try:
        return _native_io.parse_mtx(path), "native"
    except (_native_io.NativeBuildError, OSError, ValueError):
        return _parse_mtx_numpy(path), "numpy"


def read_market(path: str) -> CooGraph:
    """Read a .mtx file into a COO edge list (symmetric files get both
    edge directions, like ReadMarketStream's undirected branch)."""
    (n, rows, cols, values, symmetric), _ = parse_market(path)
    coo = CooGraph(int(n), rows.astype(np.int64), cols.astype(np.int64),
                   values)
    if symmetric:
        coo = coo.with_reverse_edges()
    return coo


def load_market(path: str, undirected: bool = False,
                use_cache: bool = True, dedupe: bool = True) -> CsrGraph:
    """Build (or load from the cache) a CSR graph from a .mtx file.

    `undirected=True` adds reverse edges even for `general` files (the
    reference's --undirected flag)."""
    cache = path + (".ud" if undirected else "") + ".csr.npz"
    if use_cache and os.path.exists(cache) and (
            os.path.getmtime(cache) >= os.path.getmtime(path)):
        return CsrGraph.load(cache)
    coo = read_market(path)
    csr = CsrGraph.from_coo(coo, undirected=undirected, dedupe=dedupe)
    if use_cache:
        try:
            csr.save(cache)
        except OSError:
            pass
    return csr
