"""SSSP as the benchmark holds it: float32 Bellman-Ford on the device
(every edge relaxed each round, until a round changes nothing), each
vertex's parent the least id u with dist[u] + w(u, v) == dist[v] in
one float32 add.

Every relaxation order reaches the same float32 fixpoint (the least sum
along a path, added left to right, over all paths), so the distances
are compared bit for bit, and the parents vertex for vertex.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.graphs._csr import DeviceCsr

NONE = -1
LIMITS = {"dist_mismatch": 0, "pred_mismatch": 0}


def _bellman_ford(g: DeviceCsr, root: int, dtype) -> Dict[str, torch.Tensor]:
    dev = g.cols.device
    src, dst = g.sources(), g.cols
    w = g.weights.to(dtype)
    dist = torch.full((g.n,), float("inf"), dtype=dtype, device=dev)
    dist[root] = 0
    while True:
        new = dist.scatter_reduce(0, dst, dist[src] + w, "amin")
        if torch.equal(new, dist):
            break
        dist = new
    ds = dist[src]
    achieves = torch.isfinite(ds) & (ds + w == dist[dst])
    big = torch.iinfo(torch.int64).max
    preds = torch.full((g.n,), big, dtype=torch.int64, device=dev)
    preds.scatter_reduce_(0, dst, torch.where(achieves, src, big), "amin")
    preds = torch.where(preds == big, NONE, preds)
    preds[root] = NONE
    return {"dist": dist.float(), "preds": preds}


def solve(g: DeviceCsr, root: int) -> Dict[str, torch.Tensor]:
    return _bellman_ford(g, int(root), torch.float32)


def control(g: DeviceCsr, root: int) -> Dict[str, torch.Tensor]:
    """The reference one precision down: weights and sums in bfloat16."""
    return _bellman_ford(g, int(root), torch.bfloat16)


def compare(answer: Dict[str, np.ndarray],
            expected: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Vertices whose distance differs from the reference's in any bit,
    and vertices whose parent differs.  A missing or misshapen array
    counts every vertex."""
    out = {}
    exp_d, exp_p = expected["dist"], expected["preds"]
    got = answer.get("dist")
    if got is None or tuple(np.shape(got)) != tuple(exp_d.shape):
        out["dist_mismatch"] = int(exp_d.shape[0])
    else:
        got = torch.as_tensor(np.asarray(got, dtype=np.float32),
                              device=exp_d.device)
        out["dist_mismatch"] = int((got.view(torch.int32)
                                    != exp_d.view(torch.int32)).sum())
    got = answer.get("preds")
    if got is None or tuple(np.shape(got)) != tuple(exp_p.shape):
        out["pred_mismatch"] = int(exp_p.shape[0])
    else:
        got = torch.as_tensor(np.asarray(got, dtype=np.int64),
                              device=exp_p.device)
        out["pred_mismatch"] = int((got != exp_p).sum())
    return out
