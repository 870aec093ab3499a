"""How far the threshold-gated PageRank's answers drift apart with depth.

Runs three implementations of the same PageRank semantics on one graph:
the multi-device tier's `pagerank_dist_words` on a 1-rank mesh, the
single-device `pr.run` (default mode) and the NumPy float64 oracle, each
for the same number of iterations (the tier's `max_iter` counts them,
`pr.run`'s and the oracle's count one more), and prints the largest
absolute and relative difference between each pair.  A vertex leaves
the active set when its rank moves by no more than `threshold`, so a
last-bit difference between two orders of summation can flip it, and a
flip changes its neighbours' sums from then on.

    python scripts/torch_pr_gate.py                  # rmat-s16, the CPU
    python scripts/torch_pr_gate.py --scale 20 --device cuda
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gunrockinst_tpu_torch.graph.rmat import rmat_graph  # noqa: E402
from gunrockinst_tpu_torch.oracles.ranking import (  # noqa: E402
    pagerank_reference)
from gunrockinst_tpu_torch.parallel import dist_words as dw  # noqa: E402
from gunrockinst_tpu_torch.parallel.mesh import edge_mesh  # noqa: E402
from gunrockinst_tpu_torch.primitives import pr  # noqa: E402


def diff(a: np.ndarray, b: np.ndarray) -> str:
    d = np.abs(a.astype(np.float64) - b)
    rel = d / np.maximum(np.abs(b.astype(np.float64)), 1e-30)
    close = np.allclose(a, b, rtol=1e-4, atol=1e-6)
    return (f"max |diff| {d.max():.6g}, max relative {rel.max():.6g}, "
            f"allclose(rtol 1e-4, atol 1e-6) {close}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=16)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--iterations", type=int, nargs="+", default=[6, 50])
    args = ap.parse_args()
    csr = rmat_graph(args.scale, 16, undirected=True, seed=42)
    n = csr.num_nodes
    mesh = edge_mesh(device=args.device)
    try:
        g = dw.shard_graph_by_dst(csr, mesh)
        for it in args.iterations:
            tier = dw.pagerank_dist_words(g, mesh, max_iter=it)[0]
            tier = tier.cpu().numpy()[:n]
            run = pr.run(csr, max_iter=it - 1, device=args.device)
            oracle = pagerank_reference(csr, max_iter=it - 1)
            print(f"rmat-s{args.scale} ef16 undirected, {it} iterations "
                  f"(pr.run took {run.stats.search_depth}):")
            print(f"  tier vs pr.run: {diff(tier, run.ranks)}")
            print(f"  tier vs oracle: {diff(tier, oracle)}")
            print(f"  pr.run vs oracle: {diff(run.ranks, oracle)}")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
