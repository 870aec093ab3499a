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
    # search route: "step8" (8 label planes) or "step_full" (rerun with
    # bit_length(n+1) planes after the 8-plane cap overflowed)
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
