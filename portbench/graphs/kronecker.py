"""The Graph500 Kronecker generator (Graph500 specification, section 3,
and its octave reference `kronecker_generator.m`), made on the device
from the seed.

`edgefactor * 2^scale` tuples; each of the `scale` bits of a tuple's
two endpoints picks a quadrant with probabilities A, B, C and
1 - A - B - C.  Vertex ids are then permuted at random, as the spec
does, and each tuple gets a float32 weight uniform in [0, 1) (kernel
3's weights).  `undirected_csr` makes the simple undirected graph:
self-loops dropped, duplicates merged to their least weight, the same
weight both ways.
"""

from __future__ import annotations

import torch

from portbench.graphs._csr import BenchGraph, undirected_csr


def make(config: dict, seed: int, device) -> BenchGraph:
    scale, edgefactor = int(config["scale"]), int(config["edgefactor"])
    a, b, c = float(config["A"]), float(config["B"]), float(config["C"])
    n, m = 1 << scale, edgefactor << scale
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ab = a + b
    c_norm, a_norm = c / (1.0 - ab), a / ab
    u = torch.zeros(m, dtype=torch.int64, device=device)
    v = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        thresh = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(m, generator=gen, device=device) > thresh
        u |= ii.long() << bit
        v |= jj.long() << bit
    perm = torch.randperm(n, generator=gen, device=device)
    u, v = perm[u], perm[v]
    w = torch.rand(m, generator=gen, device=device)
    return undirected_csr(n, u, v, w)
