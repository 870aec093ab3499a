"""Primitive scaffolding: graph coercion, result stats, timing.

Counterpart of the JAX package's `primitives/base.py`.  `Stats` holds
the reference's per-search numbers and prints its metric block
(tests/bfs/test_bfs.cu:210-235, app/bfs/bfs_app.cu:93-120): elapsed ms,
M-Edges/s, search depth, avg duty, nodes and edges visited,
total_queued, redundant work %.  `Stats.route` names the route a search
took, so that a fallback cannot hide; it is not printed.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Union

import numpy as np
import torch

from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph

INF32 = np.iinfo(np.int32).max

GraphLike = Union[CsrGraph, DeviceGraph]

_device_graphs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def device_graph(graph: GraphLike, device: torch.device,
                 **kw) -> DeviceGraph:
    """`graph` itself when it is a DeviceGraph on `device`; else the
    padded form of the host graph on `device`, built once per graph,
    device and keywords (`DeviceGraph.build`'s) and cached by identity
    as the planes routes cache theirs."""
    if isinstance(graph, DeviceGraph):
        if graph.device != torch.device(device):
            raise ValueError(f"the DeviceGraph lives on {graph.device}, "
                             f"not on {device}")
        return graph
    if not isinstance(graph, CsrGraph):
        raise TypeError(f"expected a CsrGraph or a DeviceGraph, got "
                        f"{type(graph).__name__}")
    key = (torch.device(device), tuple(sorted(kw.items())))
    per_graph = _device_graphs.setdefault(graph, {})
    hit = per_graph.get(key)
    if hit is None:
        hit = per_graph[key] = DeviceGraph.build(graph, device=device, **kw)
    return hit


@dataclasses.dataclass
class Stats:
    elapsed_ms: float = 0.0
    search_depth: int = 0
    nodes_visited: int = 0
    edges_visited: int = 0
    total_queued: int = 0
    # device-time share of wall time, 0..1 (the reference's avg CTA
    # duty, kernel_runtime_stats.cuh:226-290); < 0 = not measured
    avg_duty: float = -1.0
    # search route: "step8" (the step kernel with 8 label planes),
    # "chain" (the whole search again in one launch of the chain kernel
    # with bit_length(n+1) planes, after the 8-plane pass reached depth
    # 255 with a frontier left, or at once once a search of the graph
    # has), "sweep" (the grid-stepped touched sweeps), or the operator
    # layer's mode ("dense", "sparse", "auto"; SSSP's "sparse",
    # "delta", "bellman")
    route: str = ""

    @property
    def m_teps(self) -> float:
        """Millions of traversed edges per second (test_bfs.cu:215)."""
        if self.elapsed_ms <= 0:
            return 0.0
        return self.edges_visited / (self.elapsed_ms * 1000.0)

    @property
    def redundant_pct(self) -> float:
        """Redundant work % (app/bfs/bfs_app.cu:115): queued minus
        useful, over useful; 0 when total_queued was not tracked, and
        never below 0 (a vertex-granular queue of the stepped searches
        can be smaller than the edge count)."""
        if self.edges_visited == 0 or self.total_queued == 0:
            return 0.0
        return max(0.0, 100.0 * (self.total_queued - self.edges_visited)
                   / self.edges_visited)

    def display(self, name: str) -> str:
        """Print, and return, the reference's metric block
        (app/bfs/bfs_app.cu:93-120), as the JAX package prints it."""
        out = (f"[{name}] elapsed: {self.elapsed_ms:.4f} ms, rate: "
               f"{self.m_teps:.4f} MiEdges/s, search_depth: "
               f"{self.search_depth}")
        if self.avg_duty >= 0:
            out += f", avg_duty: {100.0 * self.avg_duty:.2f}%"
        out += (f", nodes_visited: {self.nodes_visited}, "
                f"edges_visited: {self.edges_visited}, "
                f"total_queued: "
                f"{self.total_queued or self.edges_visited}, "
                f"redundant_work: {self.redundant_pct:.2f}%")
        print(out)
        return out


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
