#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gunrockinst_tpu_torch) on one card.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each of which raises on failure:

  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - compile every kernel of the BFS main path from
               gunrockinst_tpu_torch/csrc/ (one nvcc per source, all
               started together, into gunrockinst_tpu_torch/_build/);
  3. kernel  - at rmat-s14 and rmat-s20 (ef16, undirected, seed 42), for
               every level of one search from the top-degree vertex and
               one from a random vertex, the step kernel's nfw, vw',
               planes' and n_new equal its plain PyTorch version's bit
               for bit; then each level of the s20 top-degree search is
               timed (CUDA events, median of repeats) for the kernel and
               the plain version, beside the level's bound;
  4. bfs.run - bfs.run(csr, src, traversal_mode="auto") at rmat-s20:
               labels and preds equal the NumPy oracle exactly;
  5. multi   - get_fused_bfs_multi(csr, reps=64) at rmat-s20 over the 64
               top-degree sources (bench.py's choice): every visited set
               equals the oracle's; ms per search and GTEPS.

Launch counts are zeroed just before phase 4 and read just after phase 5;
a kernel of the path with no launch there fails the run.  The last lines
are the kernels line, the nvidia-smi line and {"ok": true, ...}.  Without
CUDA the script exits nonzero and prints no result; a watchdog ends a
hung run with a traceback and a nonzero exit.

A level's bound is the larger of its bytes over 3.35 TB/s and its
operations over 67 T/s (H100 SXM data sheet: HBM rate and the non-tensor
32-bit rate).  Bytes: vw and reach read whole and nfw written whole;
one CSC offset per candidate vertex (reachable and unvisited); the
in-edge ids a candidate must read up to its first frontier hit (all of
them when there is none) and the frontier words those ids point to;
and, for each word that gains a vertex, the vw' word and the label
plane word of each set bit of d written.  Operations: three per in-edge
read.

Phase 5 also replays its 64 searches to their known depths with no host
sync between levels, queued behind a device sleep, so that CUDA events
time the card's work alone; the card's idle share of the call is one
minus that time over the call's wall time.
"""

from __future__ import annotations

import faulthandler
import json
import subprocess
import sys
import time

import numpy as np
import torch

from gunrockinst_tpu_torch.device import resolve_device
from gunrockinst_tpu_torch.graph.relabel import is_symmetric
from gunrockinst_tpu_torch.graph.rmat import rmat_graph
from gunrockinst_tpu_torch.ops import _build, mega
from gunrockinst_tpu_torch.ops.words import unpack_bitmap
from gunrockinst_tpu_torch.oracles import bfs_reference
from gunrockinst_tpu_torch.primitives import bfs, bfs_pallas

WATCHDOG_S = 1100          # under the 1200 s limit of a smoke run
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
SEED = 42
MULTI_K = 64
KERNELS = {   # every kernel of the BFS main path
    "mega_step": dict(
        route="cuda", source="gunrockinst_tpu_torch/csrc/mega_step.cu",
        replaces="gunrockinst_tpu/ops/pallas_mega.py:422"),
}
INF32 = np.iinfo(np.int32).max


def phase(name):
    print(f"[{name}]", flush=True)
    return time.perf_counter()


def done(t0, msg=""):
    print(f"  {msg}{' ' if msg else ''}({time.perf_counter() - t0:.1f} s)",
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph(scale):
    t0 = time.perf_counter()
    csr = rmat_graph(scale, 16, undirected=True, seed=SEED)
    print(f"  rmat-s{scale} ef16: {csr.num_nodes} vertices, "
          f"{csr.num_edges} directed edges "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return csr


def sources(csr):
    """The top-degree vertex and a random vertex with an edge."""
    rng = np.random.default_rng(SEED)
    return (int(np.argmax(csr.degrees)),
            int(rng.choice(np.flatnonzero(csr.degrees > 0))))


def level_work(g, fw, vw, reach, d, n_planes):
    """(bytes, operations) one level needs on these inputs."""
    st = g.stepper
    n, m = st.n, st.in_src.numel()
    cand = unpack_bitmap(reach & ~vw, n)
    dst = st.edge_dst()
    hit = unpack_bitmap(fw, g.n_words * 32)[st.in_src.long()]
    pos = torch.arange(m, device=fw.device)
    first = torch.full((n,), m, dtype=torch.int64, device=fw.device)
    first.scatter_reduce_(0, dst, torch.where(hit, pos, m), "amin")
    # a candidate reads its in-edges up to its first frontier hit, or
    # all of them when there is none
    scanned = cand[dst] & (pos <= first[dst])
    edges = int(scanned.sum())
    fw_words = int(torch.unique(st.in_src[scanned] >> 5).numel())
    new = torch.nonzero(cand & (first < m)).squeeze(1)
    changed = int(torch.unique(new >> 5).numel())
    planes_hit = bin(d & ((1 << n_planes) - 1)).count("1")
    nbytes = 4 * (3 * g.n_words + fw_words + int(cand.sum()) + edges
                  + changed * (1 + planes_hit))
    return nbytes, 3 * edges


def bound_ms(nbytes, ops):
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3


def event_ms(run, restore, reps):
    """Median device ms of run(), from CUDA events around each of `reps`
    calls; restore() runs between calls, outside the events.  A device
    sleep first lets the host queue the calls ahead of the card."""
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    for start, end in pairs:
        restore()
        start.record()
        run()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def replay_ms(g, srcs, depths, vws):
    """Device ms of each search of `srcs` run again to its known depth
    with no host sync between levels; the launches are queued behind a
    device sleep, so the events time the card alone.  The visited words
    must equal `vws`, the main run's."""
    st = g.stepper
    runs = []
    for s, depth in zip(srcs, depths):
        psrc = g.internal(int(s))
        fw = g.start(psrc)
        runs.append(dict(fw=fw, vw=fw.clone(), reach=g.reach(psrc),
                         depth=int(depth),
                         planes=torch.zeros((8 * g.rows, 128),
                                            dtype=torch.int32,
                                            device=fw.device),
                         start=torch.cuda.Event(enable_timing=True),
                         end=torch.cuda.Event(enable_timing=True)))
    asleep = torch.cuda.Event()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    asleep.record()
    for r in runs:
        fw = r["fw"]
        r["start"].record()
        for d in range(1, r["depth"] + 1):
            fw, _ = st.step(fw, r["vw"], r["planes"], d, r["reach"])
        r["end"].record()
    if asleep.query():
        raise AssertionError("the card woke before the replay was queued; "
                             "its events would hold host gaps")
    torch.cuda.synchronize()
    for i, r in enumerate(runs):
        if not np.array_equal(r["vw"].cpu().numpy(), vws[i]):
            raise AssertionError(f"replay of search {i} differs from the "
                                 "main run")
    return [r["start"].elapsed_time(r["end"]) for r in runs]


def compare_search(g, psrc, label):
    """Every level of the search from psrc through the kernel and the
    plain version on the same inputs; raises on the first difference.
    Returns the per-level inputs and the largest |kernel - plain|."""
    st = g.stepper
    reach = g.reach(psrc)
    fw = g.start(psrc)
    vw = fw.clone()
    planes = torch.zeros((8 * g.rows, 128), dtype=torch.int32,
                         device=fw.device)
    levels, max_err = [], 0
    for d in range(1, g.n + 1):
        want = mega.step_reference(st.offsets, st.in_src, fw, vw, planes,
                                   d, reach, st.edge_dst())
        vw_k, planes_k = vw.clone(), planes.clone()
        nfw_k, new_k = st.step(fw, vw_k, planes_k, d, reach)
        torch.cuda.synchronize()
        for name, got, exp in zip(("nfw", "vw'", "planes'", "n_new"),
                                  (nfw_k, vw_k, planes_k, new_k), want):
            err = int((got.long() - exp.long()).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(got, exp):
                raise AssertionError(f"{label} level {d}: kernel {name} "
                                     f"differs from the plain version "
                                     f"(max |diff| {err})")
        levels.append(dict(d=d, fw=fw, vw=vw, planes=planes,
                           n_new=int(new_k)))
        fw, vw, planes = want[0], want[1], want[2]
        if int(new_k) == 0:
            break
    print(f"  {label}: {len(levels)} levels equal to the plain version "
          f"(tolerance: bitwise; new per level "
          f"{[lv['n_new'] for lv in levels]})", flush=True)
    return levels, reach, max_err


def time_levels(g, levels, reach):
    """Per-level kernel ms, plain ms and bound ms of one search."""
    st = g.stepper
    rows = []
    for lv in levels:
        d, fw, vw, planes = lv["d"], lv["fw"], lv["vw"], lv["planes"]
        vw_k, planes_k = vw.clone(), planes.clone()

        def restore():
            vw_k.copy_(vw)
            planes_k.copy_(planes)

        k_ms = event_ms(lambda: st.step(fw, vw_k, planes_k, d, reach),
                        restore, 20)
        p_ms = event_ms(lambda: mega.step_reference(
            st.offsets, st.in_src, fw, vw, planes, d, reach,
            st.edge_dst()), lambda: None, 5)
        nbytes, ops = level_work(g, fw, vw, reach, d,
                                 planes.shape[0] // g.rows)
        rows.append(dict(d=d, n_new=lv["n_new"], bytes=nbytes, ops=ops,
                         ms=k_ms, plain_ms=p_ms,
                         bound_ms=bound_ms(nbytes, ops)))
        print(f"  level {d}: new {lv['n_new']}, {nbytes} B, kernel "
              f"{k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, bound "
              f"{rows[-1]['bound_ms'] * 1e3:.2f} us", flush=True)
    return rows


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    dev = resolve_device(None)

    t0 = phase("1 device")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{kind}; nvidia-smi: {card}", flush=True)
    done(t0)

    t0 = phase("2 build")
    reports = _build.build(KERNELS)
    for name, report in reports.items():
        print(f"  {name}: {report.strip() or 'cached'}", flush=True)
    done(t0, "built")

    t0 = phase("3 kernel vs plain version")
    max_err, timing = 0, None
    csr20 = None
    for scale in (14, 20):
        csr = graph(scale)
        g = bfs_pallas.search_graph(csr, dev)
        for which, src in zip(("top-degree", "random"), sources(csr)):
            levels, reach, err = compare_search(
                g, g.internal(src), f"s{scale} {which} src {src}")
            max_err = max(max_err, err)
            if scale == 20 and which == "top-degree":
                timing = time_levels(g, levels, reach)
        if scale == 20:
            csr20 = csr
    done(t0)

    # ---- the main path: counts from here on --------------------------
    mega.launches = 0
    t0 = phase("4 bfs.run auto, rmat-s20")
    src = sources(csr20)[0]
    res = bfs.run(csr20, src, traversal_mode="auto")
    print(f"  route {res.stats.route}, depth {res.stats.search_depth}, "
          f"{res.stats.nodes_visited} vertices, {res.stats.elapsed_ms:.3f}"
          f" ms", flush=True)
    t1 = time.perf_counter()
    ref_labels, ref_preds = bfs_reference(csr20, src)
    print(f"  oracle {time.perf_counter() - t1:.1f} s", flush=True)
    if not np.array_equal(res.labels, ref_labels):
        raise AssertionError("bfs.run labels differ from the oracle")
    if not np.array_equal(res.preds, ref_preds):
        raise AssertionError("bfs.run preds differ from the oracle")
    done(t0, "labels and preds exact")

    t0 = phase(f"5 get_fused_bfs_multi reps={MULTI_K}, rmat-s20")
    fn = bfs_pallas.get_fused_bfs_multi(csr20, reps=MULTI_K)
    srcs = np.argsort(-csr20.degrees, kind="stable")[:MULTI_K].astype(
        np.int32)
    fn(srcs)                                   # warm-up
    walls, timed_from = [], mega.launches
    for _ in range(3):
        deps, vws, wall = fn(srcs)
        walls.append(wall)
    launches = {"mega_step": mega.launches}
    per_search = (mega.launches - timed_from) / (3 * MULTI_K)
    # ---- end of the main path ----------------------------------------
    ref_vis = ref_labels != INF32
    symmetric = is_symmetric(bfs_pallas.search_graph(csr20, dev).csr_p)
    edges = 0
    for i, s in enumerate(srcs):
        visited = fn.visited_of(vws[i])
        if symmetric and ref_vis[s]:   # same component as `src`
            want = ref_vis
        else:
            want = bfs_reference(csr20, int(s))[0] != INF32
        if not np.array_equal(visited, want):
            raise AssertionError(f"multi search {i} (src {s}): visited "
                                 "set differs from the oracle")
        edges += int(csr20.degrees[visited].sum())
    walls.sort()
    best, med = walls[0], walls[len(walls) // 2]
    print(f"  {MULTI_K} searches exact; depths {sorted(set(deps.tolist()))};"
          f" best {best:.3f} ms ({best / MULTI_K:.4f} ms/search), median "
          f"{med:.3f} ms; {edges / (best * 1e-3) / 1e9:.4f} GTEPS; "
          f"{per_search:.3f} launches per search [{card}]", flush=True)
    card_ms = replay_ms(bfs_pallas.search_graph(csr20, dev), srcs, deps,
                        vws)
    busy = sum(card_ms)
    print(f"  replay, no host sync between levels: step kernels "
          f"{busy:.4f} ms for {MULTI_K} searches ({busy / MULTI_K:.5f} "
          f"ms/search; per search min {min(card_ms):.5f}, max "
          f"{max(card_ms):.5f}); card idle {100 * (1 - busy / best):.2f}%"
          f" of the best call, {100 * (1 - busy / med):.2f}% of the "
          f"median [{card}]", flush=True)
    done(t0)

    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    line = []
    for name, info in KERNELS.items():
        line.append(dict(
            name=name, **info, launches=launches[name],
            max_abs_err=max_err,
            ms=sum(r["ms"] for r in timing),
            plain_ms=sum(r["plain_ms"] for r in timing),
            bound_ms=sum(r["bound_ms"] for r in timing),
            bound_by=("bytes" if sum(r["bytes"] for r in timing)
                      / HBM_BYTES_PER_S >= sum(r["ops"] for r in timing)
                      / OPS_PER_S else "operations"),
            library_ms=None, matches_plain=True,
            work="all levels of one rmat-s20 search from the top-degree "
                 "vertex"))
    print(json.dumps({"kernels": line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
