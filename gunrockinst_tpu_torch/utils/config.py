"""Command-line flag system.

Counterpart of the JAX package's `utils/config.py`, after the
reference's `CommandLineArgs` (util/test_utils.h:50-110) and the shared
driver flags (tests/bfs/test_bfs.cu:58-88), with the same flags and
defaults.  `--device` takes a card index or `cpu`, which runs the
kernels' plain PyTorch versions on the host.
"""

from __future__ import annotations

import argparse
from typing import Union

import numpy as np


def device_flag(value: str) -> Union[int, str]:
    """--device: a CUDA card index, or "cpu"."""
    if value == "cpu":
        return value
    try:
        index = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--device takes a card index or 'cpu', not {value!r}")
    if index < 0:
        raise argparse.ArgumentTypeError("a card index is >= 0")
    return index


def torch_device(flag: Union[int, str]) -> str:
    """The torch device string of a --device value."""
    return "cpu" if flag == "cpu" else f"cuda:{flag}"


def standard_parser(prim: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"gunrockinst_tpu_torch {prim}",
        description=f"{prim} driver (reference tests/{prim}/test_{prim}.cu "
                    "analog)")
    p.add_argument("graph_type", choices=["market", "rmat", "grid"],
                   help="graph source ('grid' = road-network-class "
                        "2-D lattice)")
    p.add_argument("graph_file", nargs="?", default=None,
                   help=".mtx path (market)")
    p.add_argument("--undirected", action="store_true",
                   help="add reverse edges")
    p.add_argument("--src", default="0",
                   help="source vertex id | randomize | largestdegree")
    p.add_argument("--quick", action="store_true",
                   help="skip CPU reference validation")
    p.add_argument("--iteration-num", type=int, default=1,
                   help="timed repetitions")
    p.add_argument("--traversal-mode", default="dense",
                   choices=["dense", "sparse", "auto", "pallas", "mega",
                            "planes"],
                   help="advance strategy (LB/TWC analog); 'pallas' = "
                        "grid-stepped touched sweeps (bfs) or the "
                        "pull-SpMV (pr), 'mega' = the step and chain "
                        "kernels (bfs), 'planes' = the value kernel "
                        "(sssp/cc/pr/bc/hits/salsa/wtf)")
    p.add_argument("--mark-pred", action="store_true")
    p.add_argument("--instrumented", action="store_true",
                   help="sliced execution with per-iteration trace lines "
                        "(INST layer analog)")
    p.add_argument("--idempotence", action="store_true",
                   help="accepted for flag parity (bitmaps are always "
                        "idempotent)")
    p.add_argument("--queue-sizing", type=float, default=1.0,
                   help="accepted for flag parity (capacities are static)")
    p.add_argument("--device", type=device_flag, default=0,
                   help="CUDA card index, or 'cpu'")
    p.add_argument("--quiet", action="store_true")
    # rmat generator knobs
    p.add_argument("--rmat-scale", type=int, default=10)
    p.add_argument("--rmat-edgefactor", type=int, default=16)
    p.add_argument("--rmat-seed", type=int, default=0)
    # grid (road-network analog) knobs
    p.add_argument("--grid-side", type=int, default=256,
                   help="grid graph side length (n = side^2)")
    p.add_argument("--grid-diagonal", action="store_true",
                   help="8-neighborhood grid edges")
    # per-primitive knobs (harmless if unused)
    p.add_argument("--delta", type=float, default=0.85,
                   help="PR damping / HITS mixing")
    p.add_argument("--delta-factor", type=float, default=None,
                   help="SSSP near-far bucket width")
    p.add_argument("--error", type=float, default=0.01,
                   help="PR convergence threshold")
    p.add_argument("--max-iter", type=int, default=50)
    p.add_argument("--top-nodes", type=int, default=10)
    p.add_argument("--alpha", type=float, default=6.0,
                   help="DOBFS push->pull switch / WTF salsa mixing")
    p.add_argument("--beta", type=float, default=2.0,
                   help="DOBFS pull->push switch")
    p.add_argument("--salsa-alpha", type=float, default=0.2)
    return p


def resolve_source(src_flag: str, csr, seed: int = 0) -> int:
    """--src semantics of the reference drivers."""
    if src_flag == "randomize":
        return int(np.random.default_rng(seed).integers(0, csr.num_nodes))
    if src_flag == "largestdegree":
        return int(np.argmax(csr.degrees))
    return int(src_flag)


def load_graph(args) -> "CsrGraph":
    from gunrockinst_tpu_torch.graph.market import load_market
    from gunrockinst_tpu_torch.graph.rmat import rmat_graph
    if args.graph_type == "market":
        if not args.graph_file:
            raise SystemExit("market graph requires a .mtx path")
        return load_market(args.graph_file, undirected=args.undirected)
    if args.graph_type == "grid":
        from gunrockinst_tpu_torch.graph.lattice import grid_graph
        return grid_graph(args.grid_side, diagonal=args.grid_diagonal)
    return rmat_graph(args.rmat_scale, args.rmat_edgefactor,
                      undirected=args.undirected, seed=args.rmat_seed)
