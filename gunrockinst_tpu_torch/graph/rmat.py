"""R-MAT (Kronecker) random graph generator.

A copy of the JAX package's `graph/rmat.py` (NumPy only): the same
(scale, edge_factor, seed, undirected) give the same edges.

Capability parity with the reference's `gunrock/graphio/rmat.cuh`
(`BuildRmatGraph` :27 with a/b/c/d quadrant probabilities and per-level
parameter noise, `VaryParams` utils :84), vectorized over NumPy instead
of a per-edge host loop.
"""

from __future__ import annotations

import numpy as np

from gunrockinst_tpu_torch.graph.coo import CooGraph
from gunrockinst_tpu_torch.graph.csr import CsrGraph


def rmat_coo(scale: int, edge_factor: int = 16,
             a: float = 0.57, b: float = 0.19, c: float = 0.19,
             vary: bool = True, seed: int = 0,
             with_values: bool = False) -> CooGraph:
    """Generate a 2^scale-vertex R-MAT edge list with m = n * edge_factor."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    for level in range(scale):
        aa, bb, cc = a, b, c
        if vary:
            # multiplicative noise per level, renormalized (VaryParams analog)
            noise = 0.05
            aa *= 1.0 + noise * (rng.random() * 2 - 1)
            bb *= 1.0 + noise * (rng.random() * 2 - 1)
            cc *= 1.0 + noise * (rng.random() * 2 - 1)
            dd = (1 - a - b - c) * (1.0 + noise * (rng.random() * 2 - 1))
            s = aa + bb + cc + dd
            aa, bb, cc = aa / s, bb / s, cc / s
        # quadrants: a=(0,0), b=(0,1), c=(1,0), d=(1,1)
        u = rng.random(m)
        down = u >= aa + bb                                       # c or d
        right = ((u >= aa) & (u < aa + bb)) | (u >= aa + bb + cc)  # b or d
        bit = np.int64(1) << (scale - 1 - level)
        rows += down * bit
        cols += right * bit
    values = rng.integers(1, 64, size=m).astype(np.float32) if with_values else None
    return CooGraph(n, rows, cols, values)


def rmat_graph(scale: int, edge_factor: int = 16, undirected: bool = False,
               seed: int = 0, with_values: bool = False) -> CsrGraph:
    coo = rmat_coo(scale, edge_factor, seed=seed, with_values=with_values)
    return CsrGraph.from_coo(coo, undirected=undirected)
