"""Primitive scaffolding: result stats, timing.

Counterpart of the JAX package's `primitives/base.py`.  `Stats` holds
the reference's per-search numbers (tests/bfs/test_bfs.cu:210-235):
elapsed ms, search depth, nodes and edges visited.  `Stats.route`
names the route a search took, so that a fallback cannot hide.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

INF32 = np.iinfo(np.int32).max


@dataclasses.dataclass
class Stats:
    elapsed_ms: float = 0.0
    search_depth: int = 0
    nodes_visited: int = 0
    edges_visited: int = 0
    # search route: "step8" (the step kernel with 8 label planes),
    # "chain" (the whole search again in one launch of the chain kernel
    # with bit_length(n+1) planes, after the 8-plane pass reached depth
    # 255 with a frontier left, or at once once a search of the graph
    # has), or "sweep" (the grid-stepped touched sweeps)
    route: str = ""


def sync(device: torch.device) -> None:
    """Wait for the work queued on `device` (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """GpuTimer analog (test_utils.cuh:156): host clock around work that
    the caller ends with `sync`."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_ms = (time.perf_counter() - self.t0) * 1e3
        return False
