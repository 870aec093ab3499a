"""Frontier representations and conversions.

Counterpart of the JAX package's `ops/frontier.py`.  A frontier is a
(n_pad,) bool bitmap (dedup is free, set operations are elementwise),
or an id list: a (cap,) int32 tensor padded with `fill`, plus a count,
made by mask compaction (the filter kernel's scan + scatter,
oprtr/filter/kernel.cuh:740).
"""

from __future__ import annotations

from typing import Tuple

import torch


def empty_bitmap(n_pad: int, device: torch.device) -> torch.Tensor:
    return torch.zeros((n_pad,), dtype=torch.bool, device=device)


def bitmap_from_ids(ids: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Set bits for the given vertex ids (out-of-range ids dropped)."""
    out = empty_bitmap(n_pad, ids.device)
    out[ids[(ids >= 0) & (ids < n_pad)].long()] = True
    return out


def singleton_bitmap(src: int, n_pad: int,
                     device: torch.device) -> torch.Tensor:
    out = empty_bitmap(n_pad, device)
    out[int(src)] = True
    return out


def compact(mask: torch.Tensor, cap: int,
            fill: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bitmap -> (ids (cap,) int32, count int32): the first `cap` set
    positions in ascending order, `fill` past them; the count is that
    of every set bit, also when it exceeds `cap`."""
    ids = torch.full((cap,), fill, dtype=torch.int32, device=mask.device)
    found = torch.nonzero(mask).reshape(-1)[:cap]
    ids[: found.shape[0]] = found.to(torch.int32)
    return ids, frontier_size(mask)


def frontier_size(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)
