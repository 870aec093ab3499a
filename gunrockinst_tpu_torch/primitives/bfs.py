"""Breadth-first search: the host entry `run`.

Counterpart of the JAX package's `primitives/bfs.py::run` and
`BfsResult`.  The port carries the Pallas routes:
`traversal_mode="mega"`, and `"auto"`, which resolves to it for a host
`CsrGraph` when no depth cap is asked for (the step kernel, and the
chain kernel for searches deeper than 255 levels); and `"pallas"`, the
grid-stepped touched sweeps.  The XLA-path modes ("dense", "sparse",
"auto" with `max_depth`) are not ported yet and raise
`NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.primitives import bfs_pallas
from gunrockinst_tpu_torch.primitives.base import INF32, Stats


@dataclasses.dataclass
class BfsResult:
    labels: np.ndarray
    preds: Optional[np.ndarray]
    stats: Stats


def run(graph: CsrGraph, src: int, mark_preds: bool = True,
        traversal_mode: str = "auto",
        max_depth: Optional[int] = None,
        device: DeviceLike = None) -> BfsResult:
    """Host entry (run_bfs analog, app/bfs/bfs_app.cu:241): labels,
    optional predecessors (min-id tie-break) and the stats block.

    `device=None` runs on the CUDA card and raises without one;
    `device="cpu"` runs the kernels' plain versions."""
    dev = resolve_device(device)
    if (traversal_mode == "auto" and max_depth is None
            and isinstance(graph, CsrGraph)):
        traversal_mode = "mega"
    if traversal_mode not in ("mega", "pallas"):
        raise NotImplementedError(
            f"traversal_mode={traversal_mode!r}"
            f"{'' if max_depth is None else ' with max_depth'} is not "
            f"ported yet: ROADMAP.md queue 1, item 6")
    if not isinstance(graph, CsrGraph):
        raise TypeError(f"traversal_mode={traversal_mode!r} needs a host "
                        "CsrGraph")
    # "mega": step kernel, chain kernel for deep searches; "pallas":
    # grid-stepped touched sweeps
    variant = "mega" if traversal_mode == "mega" else "fused"
    # warm-up: the first call builds and loads the kernels
    bfs_pallas.bfs_pallas_fused(graph, src, mark_preds=False,
                                variant=variant, device=dev)
    # timed: device traversal only (reference times Enact(); Extract
    # runs outside the GpuTimer, tests/bfs/test_bfs.cu:402-431)
    labels_np, preds_np, _, device_ms = bfs_pallas.bfs_pallas_fused(
        graph, src, mark_preds=mark_preds, variant=variant, device=dev)
    visited = labels_np != INF32
    deg = np.diff(graph.row_offsets)
    stats = Stats(
        elapsed_ms=device_ms,
        search_depth=(int(labels_np[visited].max())
                      if visited.any() else 0),
        nodes_visited=int(visited.sum()),
        edges_visited=int(deg[visited].sum()),
        route=bfs_pallas.get_fused_bfs(graph, variant == "mega",
                                       dev).route,
    )
    return BfsResult(labels=labels_np, preds=preds_np, stats=stats)
