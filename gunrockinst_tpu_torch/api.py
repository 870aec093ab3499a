"""Stable flat-array API.

Counterpart of the JAX package's `api.py`, after the reference's public
C API (gunrock/gunrock.h:51-152, `gunrock_{bfs,bc,cc,sssp,pr,topk}_func`):
each function takes raw CSR arrays (row_offsets, col_indices[, values])
and returns plain NumPy arrays, with the JAX function's defaults.
`device=None` runs on the CUDA card and raises without one;
`device="cpu"` runs there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gunrockinst_tpu_torch.device import DeviceLike
from gunrockinst_tpu_torch.graph.csr import CsrGraph


def _graph(row_offsets, col_indices, edge_values=None) -> CsrGraph:
    return CsrGraph(
        row_offsets=np.asarray(row_offsets),
        col_indices=np.asarray(col_indices, dtype=np.int32),
        edge_values=(None if edge_values is None
                     else np.asarray(edge_values, dtype=np.float32)))


def bfs(row_offsets, col_indices, src: int, mark_preds: bool = False,
        traversal_mode: str = "dense", device: DeviceLike = None
        ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """gunrock_bfs_func analog. Returns (labels, preds|None)."""
    from gunrockinst_tpu_torch.primitives import bfs as m
    res = m.run(_graph(row_offsets, col_indices), src,
                mark_preds=mark_preds, traversal_mode=traversal_mode,
                device=device)
    return res.labels, res.preds


def sssp(row_offsets, col_indices, edge_values, src: int,
         mark_preds: bool = False, device: DeviceLike = None
         ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """gunrock_sssp_func analog. Returns (distances, preds|None)."""
    from gunrockinst_tpu_torch.primitives import sssp as m
    res = m.run(_graph(row_offsets, col_indices, edge_values), src,
                mark_preds=mark_preds, device=device)
    return res.dist, res.preds


def cc(row_offsets, col_indices,
       device: DeviceLike = None) -> Tuple[np.ndarray, int]:
    """gunrock_cc_func analog. Returns (component_ids, num_components)."""
    from gunrockinst_tpu_torch.primitives import cc as m
    res = m.run(_graph(row_offsets, col_indices), device=device)
    return res.component_ids, res.num_components


def bc(row_offsets, col_indices, src: int = -1,
       device: DeviceLike = None) -> np.ndarray:
    """gunrock_bc_func analog. Returns bc values."""
    from gunrockinst_tpu_torch.primitives import bc as m
    return m.run(_graph(row_offsets, col_indices), src=src,
                 device=device).bc_values


def pagerank(row_offsets, col_indices, delta: float = 0.85,
             threshold: float = 0.01, max_iter: int = 50, src: int = -1,
             device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """gunrock_pr_func analog. Returns (node_ids desc-by-rank, ranks)."""
    from gunrockinst_tpu_torch.primitives import pr as m
    res = m.run(_graph(row_offsets, col_indices), delta=delta,
                threshold=threshold, max_iter=max_iter, src=src,
                device=device)
    return res.node_ids, res.sorted_ranks


def topk(row_offsets, col_indices, k: int, device: DeviceLike = None):
    """gunrock_topk_func analog. Returns (node_ids, centralities,
    in_degrees, out_degrees)."""
    from gunrockinst_tpu_torch.primitives import topk as m
    res = m.run(_graph(row_offsets, col_indices), k, device=device)
    return (res.node_ids, res.centralities, res.in_degrees,
            res.out_degrees)
