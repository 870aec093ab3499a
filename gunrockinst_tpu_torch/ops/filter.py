"""The filter operator: frontier cull.

Counterpart of the JAX package's `ops/filter.py`, after
oprtr/filter/kernel.cuh.  On a bitmap frontier dedup is exact and free,
so the reference's cull stages reduce to elementwise masking:

    out = frontier & vertex_cond & ~visited

with the dummy and padding vertices (ids >= n) always culled.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gunrockinst_tpu_torch.graph.csr import DeviceGraph


def filter_frontier(
    graph: DeviceGraph,
    frontier: torch.Tensor,                   # (n_pad,) bool
    vertex_fn: Optional[Callable] = None,     # (vids, state) -> keep mask
    state=None,
    visited: Optional[torch.Tensor] = None,   # (n_pad,) bool, or None
) -> torch.Tensor:
    """Returns the culled frontier bitmap."""
    mask = frontier
    vids = torch.arange(graph.n_pad, dtype=torch.int32,
                        device=frontier.device)
    if visited is not None:
        mask = mask & ~visited
    if vertex_fn is not None:
        mask = mask & vertex_fn(vids, state)
    return mask & (vids < graph.n)
