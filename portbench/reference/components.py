"""Connected components of the benchmark's undirected graph, in plain
torch: roots hooked onto the least neighbouring root, then pointers
jumped to their roots, until no edge joins two trees."""

from __future__ import annotations

import torch

from portbench.graphs._csr import DeviceCsr


def components(g: DeviceCsr) -> torch.Tensor:
    """(n,) int64: the least vertex id of each vertex's component."""
    src, dst = g.sources(), g.cols
    parent = torch.arange(g.n, device=g.cols.device)
    while True:
        ps, pd = parent[src], parent[dst]
        cross = ps != pd
        if not bool(cross.any()):
            return parent
        # every parent is a root here: hook each root onto the least
        # root across its edges (a forest, since ids only fall)
        parent.scatter_reduce_(0, ps[cross], pd[cross], "amin")
        while True:
            up = parent[parent]
            if torch.equal(up, parent):
                break
            parent = up
