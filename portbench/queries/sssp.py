"""`gunrockinst_tpu_torch.primitives.sssp.run` on a host `CsrGraph`
with float32 weights."""

from __future__ import annotations

from gunrockinst_tpu_torch.primitives import sssp

WEIGHTED = True


def call(csr, root: int, args: dict, device):
    res = sssp.run(csr, int(root), device=device, **args)
    return {"dist": res.dist, "preds": res.preds}, res.stats
