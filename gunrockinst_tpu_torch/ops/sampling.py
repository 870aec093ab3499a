"""Neighbour sampling.

Counterpart of the JAX package's `ops/sampling.py`: every vertex of a
batch draws exactly `k` neighbours (uniform, with replacement) through
random offsets into its CSR segment; isolated vertices and the dummy id
yield the dummy vertex with a validity mask.  All shapes are fixed.

The reference draws its uniforms with `jax.random.uniform`, whose bits
PyTorch cannot reproduce, so here the draws are an input: `u=`, a
(B, k) float32 tensor in [0, 1) on the graph's device, or, when `u` is
None, drawn from the caller's `torch.Generator` (on that device).  Fed
the reference's draws, the functions give its neighbours, edge ids and
masks bit for bit: the offset arithmetic is the same float32
`floor(u * max(deg, 1))`, clamped to `deg - 1`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from gunrockinst_tpu_torch.graph.csr import DeviceGraph


def _draws(graph: DeviceGraph, shape, u: Optional[torch.Tensor],
           generator: Optional[torch.Generator]) -> torch.Tensor:
    if u is None:
        if generator is None:
            raise ValueError("give the uniform draws u= or a "
                             "torch.Generator to draw them from")
        return torch.rand(shape, generator=generator, dtype=torch.float32,
                          device=graph.device)
    if tuple(u.shape) != tuple(shape) or u.dtype != torch.float32:
        raise ValueError(f"u must be a float32 tensor of shape {shape}")
    return u


def sample_neighbors(graph: DeviceGraph, vertex_ids: torch.Tensor, k: int,
                     u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uniform-with-replacement k-neighbour sampling.

    vertex_ids: (B,) int32 (the dummy id graph.n allowed: masked out).
    Returns (neighbours (B, k) int32, edge ids (B, k) int32, valid
    (B, k) bool)."""
    vid = vertex_ids.to(torch.int32)
    b = vid.shape[0]
    u = _draws(graph, (b, k), u, generator)
    deg = graph.out_degree[vid]
    start = graph.row_offsets[vid]
    off = torch.floor(u * torch.clamp(deg, min=1)[:, None].to(
        torch.float32)).to(torch.int32)
    off = torch.minimum(off, torch.clamp(deg - 1, min=0)[:, None])
    eid = start[:, None] + off
    valid = ((deg > 0) & (vid != graph.n))[:, None].expand(b, k)
    eid = torch.where(valid, eid, graph.m_pad - 1)
    nbrs = torch.where(valid, graph.edge_dst[eid], graph.n)
    return nbrs, eid, valid


def sample_khop(graph: DeviceGraph, seeds: torch.Tensor, k: int, hops: int,
                generator: Optional[torch.Generator] = None,
                u: Optional[Sequence[torch.Tensor]] = None
                ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Multi-hop fanout sampling (GraphSAGE-style): a list of per-hop
    (vertices, neighbours, valid) layers; layer i expands every vertex
    of layer i-1 by k samples, so its width is |seeds| * k^i.  The draws
    come from `generator`, or from `u`, one (|seeds| * k^i, k) tensor a
    hop."""
    if u is not None and len(u) != hops:
        raise ValueError(f"u must hold {hops} draws, one a hop")
    layers = []
    frontier = seeds.to(torch.int32)
    for h in range(hops):
        nbrs, _, valid = sample_neighbors(
            graph, frontier, k, u=None if u is None else u[h],
            generator=generator)
        layers.append((frontier, nbrs, valid))
        frontier = nbrs.reshape(-1)
    return layers
