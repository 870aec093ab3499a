"""1-D edge partitioning across the edge mesh.

Counterpart of the JAX package's `parallel/partition.py`: each rank
holds an equal contiguous slice of the (CSR-ordered, re-padded) edge
list; vertex state is replicated.  An advance is a local gather and a
local scatter-combine into a full-length vertex vector, then one
collective (min/max/sum) merges the ranks' partials.
"""

from __future__ import annotations

import dataclasses

import torch

from gunrockinst_tpu_torch.graph.csr import LANE, DeviceGraph, _round_up
from gunrockinst_tpu_torch.parallel.mesh import EdgeMesh


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedGraph:
    """One rank's shard: its `m_loc` = m_pad / size edges (the JAX
    package's P('e') arrays, rank r's slice [r*m_loc, (r+1)*m_loc));
    the degree and offset arrays replicated."""

    n: int
    m: int
    n_pad: int
    m_pad: int

    edge_src: torch.Tensor     # (m_loc,) int32, this rank's slice
    edge_dst: torch.Tensor     # (m_loc,) int32
    edge_w: torch.Tensor       # (m_loc,) float32
    out_degree: torch.Tensor   # (n_pad,) int32, replicated
    row_offsets: torch.Tensor  # (n_pad,) int32, replicated

    @property
    def dummy(self) -> int:
        return self.n

    @property
    def m_loc(self) -> int:
        return self.edge_src.shape[0]


def shard_graph(graph: DeviceGraph, mesh: EdgeMesh) -> ShardedGraph:
    """Re-pad the edge arrays so that every rank's slice is lane-aligned
    (padding edges (n -> n), weight 0) and keep this rank's slice on the
    mesh's device."""
    d = mesh.size
    m_pad = _round_up(graph.m_pad, LANE * d)
    m_loc = m_pad // d
    lo, hi = mesh.rank * m_loc, (mesh.rank + 1) * m_loc

    def mine(a, fill):
        out = torch.full((m_loc,), fill, dtype=a.dtype, device=mesh.device)
        real = a[lo: min(hi, graph.m_pad)]
        out[: real.shape[0]] = real.to(mesh.device)
        return out

    return ShardedGraph(
        n=graph.n, m=graph.m, n_pad=graph.n_pad, m_pad=m_pad,
        edge_src=mine(graph.edge_src, graph.n),
        edge_dst=mine(graph.edge_dst, graph.n),
        edge_w=mine(graph.edge_w, 0.0),
        out_degree=graph.out_degree.to(mesh.device),
        row_offsets=graph.row_offsets.to(mesh.device),
    )
