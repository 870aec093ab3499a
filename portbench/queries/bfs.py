"""`gunrockinst_tpu_torch.primitives.bfs.run` on a host `CsrGraph`."""

from __future__ import annotations

from gunrockinst_tpu_torch.primitives import bfs

WEIGHTED = False


def call(csr, root: int, args: dict, device):
    res = bfs.run(csr, int(root), device=device, **args)
    return {"labels": res.labels, "preds": res.preds}, res.stats
