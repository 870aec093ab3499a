"""Bytes an exact SSSP query must move at least: every edge of the
root's component read once (8 B: its id and its weight), every offset
of the component (4 B), and the answer written once (8 B a vertex of
the graph: distance and parent)."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.graphs._csr import DeviceCsr


def bytes_of(g: DeviceCsr, expected: Dict[str, torch.Tensor]) -> int:
    reached = torch.isfinite(expected["dist"])
    comp_edges = int(g.degrees()[reached].sum())
    return 8 * comp_edges + 4 * int(reached.sum()) + 8 * g.n
