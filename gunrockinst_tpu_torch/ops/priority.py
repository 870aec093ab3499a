"""Near-far priority frontier (delta-stepping buckets).

Counterpart of the JAX package's `ops/priority.py`, after
gunrock/priority_queue/{near_far_pile,kernel}.cuh: the MarkValid +
Compact + host Bisect pipeline (kernel.cuh:161-405) becomes two masks
on the pending bitmap.  Bounds and keys are float32 and levels int32,
as in the reference, so that both packages split at the same keys.
"""

from __future__ import annotations

from typing import Tuple

import torch


def near_far_split(pending: torch.Tensor, keys: torch.Tensor, level: int,
                   delta: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a pending bitmap by priority bucket: near = pending entries
    with keys < (level+1)*delta (the current bucket), far = the rest
    (PriorityQueue::Bisect).  `delta` is a float32 scalar tensor."""
    bound = (torch.tensor(level, dtype=torch.float32,
                          device=keys.device) + 1.0) * delta
    near = pending & (keys < bound)
    return near, pending & ~near


def next_nonempty_level(pending: torch.Tensor, keys: torch.Tensor,
                        level: int, delta: torch.Tensor) -> int:
    """The bucket index of the smallest pending key, at least level+1:
    the re-Bisect loop of the reference (sssp_enactor.cuh:399-420) in
    one step.  Reads one scalar on the host."""
    minkey = torch.where(pending, keys, float("inf")).min()
    if not bool(torch.isfinite(minkey)):
        return level + 1
    new_level = int(torch.floor(minkey / delta).to(torch.int32))
    return max(new_level, level + 1)
