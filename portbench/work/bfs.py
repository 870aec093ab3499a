"""Bytes a BFS query must move at least, whatever kernel does it.

The answer is written once: 8 B a vertex of the graph (label and
parent).  Each level expands a frontier F into the vertices R it
reaches and pays the lesser of two orders:

  * push: 4 B for each vertex of F and each of its out-edges;
  * pull: 4 B for each vertex of the root's component still unvisited
    before the level, for every in-edge of those the level does not
    reach, and for one in-edge of each vertex it does reach.

The last level, whose frontier reaches nothing, pays its push or
nothing.  Neither count depends on the order of a vertex's edges, so an
early-exit pull cannot read below it.  The graph is undirected, so a
vertex's in-edges are its out-edges.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.graphs._csr import DeviceCsr
from portbench.reference.bfs import UNREACHED


def bytes_of(g: DeviceCsr, expected: Dict[str, torch.Tensor]) -> int:
    labels = expected["labels"]
    reached = labels != UNREACHED
    level = labels[reached]
    deg = g.degrees()[reached]
    depth = int(level.max())
    width = torch.bincount(level, minlength=depth + 2)          # |level d|
    degsum = torch.zeros(depth + 2, dtype=torch.int64,
                         device=labels.device).scatter_add_(0, level, deg)
    comp_n, comp_deg = int(width.sum()), int(degsum.sum())
    done_n = torch.cumsum(width, 0)        # vertices at levels <= d
    done_deg = torch.cumsum(degsum, 0)
    d = torch.arange(depth + 1, device=labels.device)
    push = 4 * (width[d] + degsum[d])
    unvisited = comp_n - done_n[d]                   # levels > d
    missed_deg = comp_deg - done_deg[d + 1]          # levels > d + 1
    pull = 4 * (unvisited + missed_deg + width[d + 1])
    return 8 * g.n + int(torch.minimum(push, pull).sum())
