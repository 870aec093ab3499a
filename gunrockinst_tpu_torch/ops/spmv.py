"""Pull-SpMV: PageRank's f32 sum per destination of `contrib[src]` over
the in-edges, on the value kernel's ungated add sweep
(`csrc/value_step.cu`), with its own wrapper and launch counter.

Counterpart of the JAX package's `ops/pallas_spmv.py::SpmvSweeper`
(kernels `_hub_kernel`, pallas_spmv.py:273, and `_packed_kernel`,
:296), the push of PR `mode="pallas"`:

    sums[v] = sum over in-edges u->v of contrib[u]       f32

This is the value kernel's add mode with no accumulator: the sweep
starts from 0 and sums every in-edge, in one fixed order per
destination, so two calls give the same bits.  The graph is the one
the caller gives, unrelabeled (`primitives/pr.py::get_spmv_sweeper`
passes the CSC of the input graph, as the reference does).

The TPU layout does not carry over and is not ported: `SpmvPlan` and
`build_spmv_plan` (hub and packed subtiles in 4096-vertex source
regions), `stage_contrib` (contrib as hi/lo 16-bit planes) and
`spmv_fits` (the SMEM scalar-prefetch budget that stops the reference
from planning rmat-s20).  The sweep reads the CSC directly at any size.

The wrapper launches the kernel for CUDA tensors and takes the plain
version, `sweep_reference`, only for CPU tensors; on the card a build
or launch failure raises.  One launch of this wrapper is one launch of
the value kernel, counted as `launch.spmv` here and as
`launch.value_step.dense` in `ops/value.py` (`utils/trace.py`).
"""

from __future__ import annotations

from typing import Optional

import torch

from gunrockinst_tpu_torch.ops import value
from gunrockinst_tpu_torch.utils import trace


def sweep_reference(offsets: torch.Tensor, in_src: torch.Tensor,
                    contrib: torch.Tensor,
                    dst: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: (n_pad,) f32 sums of `contrib` (n_pad,)
    f32 over the in-edges of the CSC (offsets, in_src), 0 in the
    padding.  `dst` is the destination of each CSC edge, recomputed
    when not given."""
    out, _, _ = value.sweep_reference(
        offsets, in_src, contrib.view(torch.int32), None, mode="add",
        f32=True, use_active=False, dst=dst)
    return out.view(torch.float32)


class SpmvSweeper:
    """fn(contrib (n_pad,) f32) -> sums (n_pad,) f32 over the in-edges of
    the CSC (`offsets` (n+1,), `in_src` (m,), contiguous int32 on the
    device the sweeps run on; shared, not copied).  n_pad is
    `self.n_pad` (32 * the word count of n vertices); contrib must be
    0 in the padding."""

    def __init__(self, offsets: torch.Tensor, in_src: torch.Tensor):
        self.stepper = value.ValueStepper(offsets, in_src, mode="add",
                                          f32=True, use_active=False)
        self.n, self.n_pad = self.stepper.n, self.stepper.n_pad
        self.offsets, self.in_src = offsets, in_src
        self.device = self.stepper.device

    def reference(self, contrib: torch.Tensor) -> torch.Tensor:
        """The plain version of `__call__` on the same input."""
        return sweep_reference(self.offsets, self.in_src, contrib,
                               self.stepper.edge_dst())

    def __call__(self, contrib: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sums (n_pad,) f32; `out`, when given, receives them and must
        not alias `contrib`."""
        if contrib.dtype != torch.float32:
            raise ValueError("contrib must be an f32 tensor")
        sums, _, _ = self.stepper.sweep(
            contrib.view(torch.int32), None,
            None if out is None else out.view(torch.int32))
        if contrib.device.type == "cuda":
            trace.count("launch.spmv")
        return sums.view(torch.float32)
