"""BFS as the benchmark holds it: a level-synchronous frontier expansion
on the device, each vertex's parent the least id one level up.

The answer a call returns is compared whole: `labels` (the level of
every vertex, INT32_MAX where unreached) and `preds` (the least-id
parent, -1 at the root and where unreached), vertex for vertex.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.graphs._csr import DeviceCsr

UNREACHED = int(np.iinfo(np.int32).max)
NONE = -1
LIMITS = {"label_mismatch": 0, "pred_mismatch": 0}


def _levels(g: DeviceCsr, root: int, combine: str):
    """(labels, preds) int64, with each new vertex's parent combined over
    the frontier by `combine` ("amin": the least id)."""
    dev = g.cols.device
    labels = torch.full((g.n,), UNREACHED, dtype=torch.int64, device=dev)
    preds = torch.full((g.n,), NONE, dtype=torch.int64, device=dev)
    labels[root] = 0
    frontier = torch.tensor([root], dtype=torch.int64, device=dev)
    depth = 0
    while frontier.numel():
        start = g.offsets[frontier]
        count = g.offsets[frontier + 1] - start
        total = int(count.sum())
        if total == 0:
            break
        which = torch.repeat_interleave(
            torch.arange(frontier.numel(), device=dev), count,
            output_size=total)
        first = torch.cumsum(count, 0) - count
        edge = start[which] + torch.arange(total, device=dev) - first[which]
        nbr = g.cols[edge]
        fresh = labels[nbr] == UNREACHED
        nbr, parent = nbr[fresh], frontier[which[fresh]]
        if nbr.numel() == 0:
            break
        depth += 1
        new, slot = torch.unique(nbr, return_inverse=True)
        fill = torch.iinfo(torch.int64).max if combine == "amin" else -1
        best = torch.full(new.shape, fill, dtype=torch.int64,
                          device=dev).scatter_reduce_(0, slot, parent,
                                                      combine)
        labels[new] = depth
        preds[new] = best
        frontier = new
    return labels, preds


def solve(g: DeviceCsr, root: int) -> Dict[str, torch.Tensor]:
    labels, preds = _levels(g, int(root), "amin")
    return {"labels": labels, "preds": preds}


def control(g: DeviceCsr, root: int) -> Dict[str, torch.Tensor]:
    """The reference with the least-id parent rule broken: the greatest
    id one level up, a parent as valid as any other, as an early-exit or
    first-claim search would leave it."""
    labels, preds = _levels(g, int(root), "amax")
    return {"labels": labels, "preds": preds}


def compare(answer: Dict[str, np.ndarray],
            expected: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Vertices whose label, and whose parent, differ from the
    reference's.  A missing or misshapen array counts every vertex."""
    out = {}
    for key, name in (("labels", "label_mismatch"),
                      ("preds", "pred_mismatch")):
        exp = expected[key]
        got = answer.get(key)
        if got is None or tuple(np.shape(got)) != tuple(exp.shape):
            out[name] = int(exp.shape[0])
            continue
        got = torch.as_tensor(np.asarray(got, dtype=np.int64),
                              device=exp.device)
        out[name] = int((got != exp).sum())
    return out
