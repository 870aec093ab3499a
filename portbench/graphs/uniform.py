"""GAP's uniform random graph, Urand (the GAP Benchmark Suite,
arXiv:1508.03619; gapbs `generator.h`, `MakeUniformEL`), made on the
device from the seed.

`degree * 2^scale` tuples, both endpoints of each drawn uniformly from
[0, 2^scale): no locality and no skew.  No weights.  `undirected_csr`
makes the simple undirected graph, as gapbs does when it builds one
(`SquishGraph`): self-loops dropped, duplicates merged, both directions
stored.
"""

from __future__ import annotations

import torch

from portbench.graphs._csr import BenchGraph, undirected_csr


def make(config: dict, seed: int, device) -> BenchGraph:
    scale, degree = int(config["scale"]), int(config["degree"])
    n, m = 1 << scale, degree << scale
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.randint(0, n, (m,), generator=gen, device=device)
    v = torch.randint(0, n, (m,), generator=gen, device=device)
    return undirected_csr(n, u, v, None)
