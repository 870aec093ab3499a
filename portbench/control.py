#!/usr/bin/env python3
"""The control of a cell's `correct`: the plain reference with one stated
guarantee broken (`reference/<primitive>.py::control`: BFS parents by the
greatest id one level up; SSSP in bfloat16) put in the program's place,
on the roots a run's window takes first, held to the same comparison
and limits as a run.  A control that does not come out as not correct
means the comparison cannot see that fault.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--queries K]

Run from the root of a checkout on a CUDA card, at the cell's own size.
The benchmark's runs do not run it; the tests run it at a small size.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def readings(cell, seed: int, queries: int, device) -> dict:
    """The control's summed numbers over the first `queries` window roots
    of `seed`, each beside its limit."""
    import importlib

    import torch

    from portbench import harness

    dev = torch.device(device)
    primitive = cell.traffic["primitive"]
    ref = importlib.import_module(f"portbench.reference.{primitive}")
    gen = importlib.import_module(
        f"portbench.graphs.{cell.config['generator']}")
    graph = gen.make(cell.config, harness.seed_key(seed), dev)
    roots, _ = harness.draw_roots(graph, seed,
                                  int(cell.traffic["warmup_queries"]))
    on_dev = graph.to(dev)
    totals = {k: 0 for k in ref.LIMITS}
    for root in roots[:queries]:
        expected = ref.solve(on_dev, int(root))
        answer = {k: v.cpu().numpy()
                  for k, v in ref.control(on_dev, int(root)).items()}
        for k, v in ref.compare(answer, expected).items():
            totals[k] += v
    return {k: {"value": v, "limit": ref.LIMITS[k]}
            for k, v in totals.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, type=int, nargs="+")
    p.add_argument("--queries", type=int, default=None,
                   help="roots a seed (default: the traffic's checked "
                        "sample)")
    args = p.parse_args(argv)
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    import torch
    from portbench import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    k = args.queries or int(cell.traffic["checked_queries"])
    failed_all = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(cell, seed, k, "cuda")
        caught = any(v["value"] > v["limit"] for v in out.values())
        failed_all &= caught
        print(json.dumps({"workload": cell.name, "seed": seed, "roots": k,
                          "control_not_correct": caught,
                          "seconds": time.perf_counter() - t0,
                          "readings": out}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
