#!/usr/bin/env python3
"""The benchmark of gunrockinst_tpu_torch, one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with as many CUDA cards as
the cell asks for; without them it exits with code 2 and prints no
result.  It makes the cell's graph from the seed, hands it to the
program, warms up, drives queries in a closed loop for the window, then
checks a sample of the window's answers against the plain reference.
Earlier lines of standard output give detail; the last is one JSON
object (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` also `breakdown`, and `checks` last).  The last lines of
standard error give each number compared beside its limit.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({exc})"


def readings(rec, spec, trace=None) -> list:
    """The cell's metrics that its readers find (with `trace` None, the
    end-to-end and the per-layer ones): name, value and unit each."""
    from portbench import harness
    modes = (False, True) if trace is None else (trace,)
    out = []
    for mode in modes:
        for entry in harness.metrics_for(spec, rec.cell, mode):
            value = harness.reader(entry["name"])(rec)
            if value is not None:
                out.append({"name": entry["name"], "value": float(value),
                            "unit": entry["unit"]})
    return out


def result_line(rec, spec, trace: bool, chips: int) -> dict:
    metrics = {m["name"]: {"value": m["value"], "unit": m["unit"]}
               for m in readings(rec, spec, trace)}
    device = {"platform": "gpu", "kind": rec.device_kind, "count": chips,
              "memory_peak_bytes": rec.memory_peak_bytes}
    line = {"correct": rec.correct, "attempted": len(rec.queries),
            "failed": rec.failed, "metrics": metrics, "device": device}
    if trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        line["breakdown"] = {
            "device_ops": [list(kv) for kv in rec.trace.device_ops],
            "idle_gaps": [list(kv) for kv in rec.trace.idle_gaps]}
    line["checks"] = checks(rec)
    return line


def checks(rec) -> dict:
    """Each number compared, with its limit (the most it may read)."""
    out = {"failed_queries": {"value": rec.failed, "limit": 0},
           "unchecked": {"value": int(not rec.checked), "limit": 0}}
    for name, value in rec.check_totals().items():
        out[name] = {"value": value, "limit": rec.limits[name]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    # import from the checkout's root, not from this folder
    sys.path[0] = str(CHECKOUT)
    import torch
    from portbench import harness

    spec = harness.bench_spec()
    cell = harness.load_cell(args.workload, spec)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    found = harness.forbidden_modules(list(sys.modules))
    if found:
        print(f"portbench: loaded at start-up: {found}", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", flush=True)
    rec = harness.run_cell(cell, args.seed, args.seconds, "cuda", T0,
                           log=lambda s: print(s, flush=True))
    # every metric's reading on an earlier line, whichever the mode
    print("readings " + json.dumps(
        {m["name"]: m["value"] for m in readings(rec, spec)}), flush=True)
    line = result_line(rec, spec, bool(args.trace), cell.chips)
    # last, after the metric readers have been loaded too
    found = harness.forbidden_modules(list(sys.modules))
    if found:
        print(f"portbench: loaded by the end of the run: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for name, item in line["checks"].items():
        print(f"{name} {item['value']} limit {item['limit']}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
