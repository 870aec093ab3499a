"""The benchmark's own graph: an undirected CSR built in plain torch.

Generators hand their edge tuples to `undirected_csr`, which drops
self-loops, merges duplicate edges (keeping the least weight), adds
both directions with the same weight and sorts each row by neighbour
id.  The result lives on the host (`BenchGraph`): the port gets NumPy
copies of it, and the reference and the byte counts upload it again
after the measured window.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class BenchGraph:
    """Host CSR: offsets (n+1,) int64, cols (m,) int32, weights (m,)
    float32 or None.  Symmetric: every edge is stored both ways."""

    n: int
    offsets: torch.Tensor
    cols: torch.Tensor
    weights: Optional[torch.Tensor]

    @property
    def m(self) -> int:
        return int(self.cols.shape[0])

    def degrees(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def port_arrays(self, weighted: bool):
        """(row_offsets int32, col_indices int32, edge_values float32 or
        None) as fresh NumPy arrays for the program's `CsrGraph`."""
        vals = None
        if weighted:
            if self.weights is None:
                raise ValueError("this configuration has no weights")
            vals = self.weights.numpy().copy()
        return (self.offsets.to(torch.int32).numpy().copy(),
                self.cols.numpy().copy(), vals)

    def to(self, device) -> "DeviceCsr":
        return DeviceCsr(self.n, self.offsets.to(device),
                         self.cols.to(device).long(),
                         None if self.weights is None
                         else self.weights.to(device))


@dataclasses.dataclass
class DeviceCsr:
    """The same CSR on a device, int64 ids, for the reference."""

    n: int
    offsets: torch.Tensor
    cols: torch.Tensor
    weights: Optional[torch.Tensor]

    def degrees(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def sources(self) -> torch.Tensor:
        """(m,) int64: the source of each stored edge."""
        return torch.repeat_interleave(
            torch.arange(self.n, device=self.cols.device), self.degrees(),
            output_size=self.cols.shape[0])


def undirected_csr(n: int, u: torch.Tensor, v: torch.Tensor,
                   w: Optional[torch.Tensor]) -> BenchGraph:
    """The simple undirected graph of the tuples (u[i], v[i]) with
    weight w[i]: self-loops dropped, duplicates merged to their least
    weight, both directions stored, rows sorted.  Built on the tuples'
    device, returned on the host."""
    keep = u != v
    u, v = u[keep].long(), v[keep].long()
    lo, hi = torch.minimum(u, v), torch.maximum(u, v)
    del u, v
    keys, inverse = torch.unique(lo * n + hi, sorted=True,
                                 return_inverse=True)
    del lo, hi
    wmin = None
    if w is not None:
        wmin = torch.full(keys.shape, float("inf"), dtype=torch.float32,
                          device=keys.device).scatter_reduce_(
            0, inverse, w[keep].float(), "amin")
    del inverse
    lo, hi = keys // n, keys % n
    del keys
    src, dst = torch.cat((lo, hi)), torch.cat((hi, lo))
    del lo, hi
    order = torch.argsort(src * n + dst)
    src, dst = src[order], dst[order]
    weights = None if wmin is None else torch.cat((wmin, wmin))[order]
    del order
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    offsets[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    return BenchGraph(n, offsets.cpu(), dst.to(torch.int32).cpu(),
                      None if weights is None else weights.cpu())


def from_neighbour_lists(indptr: np.ndarray, indices: np.ndarray,
                         device) -> BenchGraph:
    """The undirected graph of host neighbour lists (one list per
    vertex, each edge listed from either end or both)."""
    n = int(indptr.shape[0] - 1)
    u = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64),
        torch.from_numpy(np.diff(indptr).astype(np.int64)))
    v = torch.from_numpy(np.asarray(indices, dtype=np.int64))
    return undirected_csr(n, u.to(device), v.to(device), None)
