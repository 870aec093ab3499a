"""The count of traversed edges behind `card_gteps` and `caller.gteps`:
the simple undirected edges of the root's component, each counted once
(half the stored edge slots of the component).

This is not Graph500's TEPS count, which counts the generator's input
tuples in the component, self-loops and duplicate tuples included: at
scale 21 that is 2^25 tuples against about 31.77 M edges here, 5.6%
more.  The mesh has no tuples beyond its edges, so one count serves
both graphs."""

from __future__ import annotations

import numpy as np
import torch

from portbench.graphs._csr import DeviceCsr
from portbench.reference.components import components


def edges_per_vertex(g: DeviceCsr) -> np.ndarray:
    """(n,) int64 on the host: the count for a query from each vertex."""
    comp = components(g)
    slots = torch.zeros(g.n, dtype=torch.int64,
                        device=comp.device).scatter_add_(0, comp,
                                                         g.degrees())
    return (slots[comp] // 2).cpu().numpy()
