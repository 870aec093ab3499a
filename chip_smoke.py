#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gunrockinst_tpu_torch) on one card.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card
    python3 chip_smoke.py --variants DIR [bfs|sweeps|walls]   # only
                                    # the timings of the BFS kernels (not
                                    # with `sweeps`) and the sweep
                                    # variants below (not with `bfs`), or
                                    # (`walls`) the wall times of the
                                    # value-sweep entry points, on the
                                    # kernels of checkout DIR

Phases, each of which raises on failure:

  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - compile the five kernel sources (mega_step, value_step,
               chain_bfs, touch_sweep, min_preds; the spmv wrapper
               launches value_step's) from gunrockinst_tpu_torch/csrc/
               (one nvcc per source, all started together, into
               gunrockinst_tpu_torch/_build/);
  3. kernel  - at rmat-s14 and rmat-s20 (ef16, undirected, seed 42), for
               every level of one search from the top-degree vertex and
               one from a random vertex, the step kernel's nfw, vw',
               planes' and n_new equal its plain PyTorch version's bit
               for bit, with the direction left to the kernel, forced to
               push and forced to pull, and the direction the kernel
               wrote beside n_new equals `last_direction()` (and the
               forced order); then the whole search as the
               main path runs it (each level's input the kernel's own
               output) equals the plain version's last state.  The same
               on the edge-case graphs: the star of `edge_graphs` both
               ways (every edge into its centre; every edge out of it, a
               push hub), the random graph (n not a multiple of 32) and
               rmat-s14 directed.  Then level 2 of the rmat-s14
               random-source search on a frontier edited through a raw
               pointer after level 1 (a hub that level did not list put
               in, one it listed taken out), so that the wrapper still
               trusts its stale slot: equal to the plain version in
               every direction.  Each level of the four rmat searches
               is timed (CUDA events between levels, the search run as
               the main path runs it, median of repeats; also forced to
               push and to pull) with the direction it took, beside the
               plain version and the level's bound;
  4. bfs.run - bfs.run(csr, src, traversal_mode="auto") at rmat-s20:
               labels and preds equal the NumPy oracle exactly; the
               preds again, as the port's earlier `SearchGraph.min_preds`
               made them (an int64 destination per edge, cached) and as
               the call made them (decoded from its planes), both
               equal to the oracle, with the
               card memory each took (peak above the call's start, and
               held after it, from torch.cuda.max_memory_allocated);
  5. multi   - get_fused_bfs_multi(csr, reps=64) at rmat-s20 over the 64
               top-degree sources (bench.py's choice): every visited set
               equals the oracle's; ms per search and GTEPS.

  6. value   - at rmat-s14 and rmat-s20, one sweep of the value kernel
               in each of its five configurations (sssp_w, sssp_c, cc,
               pr, bc_fwd) on seeded inputs, with the route left to the
               sweep, equals its plain PyTorch version: the min
               configurations bit for bit, changed map and count
               included; the add configurations (pr ungated, bc_fwd
               gated on half the sources) allclose (rtol 1e-5, atol
               1e-6) and bitwise equal between two kernel runs.  At s20
               each configuration's dense route is timed (CUDA events,
               median of repeats) for the kernel and the plain version,
               beside its bound; for pr also one library call for the
               same sums, a CSR SpMV.  Then each configuration on the
               edge-case graphs (`edge_graphs`: a star whose centre holds
               every in-edge, a random graph, both with n not a multiple
               of 32): equal to the plain version.  Then, at s20, each
               configuration's dense route again at every long-list
               threshold of LONG_DEGREES: equal to the plain version, and
               its kernel timed.  Then, at s20, each gated configuration
               (ROUTED) with one active vertex (the top out-degree, as
               SSSP's first round) and ACTIVE_SHARES of its vertices
               active, through each route it may take (dense, push for
               a min, touched), forced: equal to that route's plain
               version (bitwise for min; allclose and two calls bitwise
               equal for add) and bitwise equal to the dense kernel;
               each timed beside its route's bound and the sweep's, with
               the route the rule would take;
  7. sssp    - sssp.run(csr, top-degree src, mode="planes") at rmat-s20,
               unweighted and with integer weights 1..63: distances
               equal scipy's Dijkstra cast to f32, bit for bit; preds
               of one run at rmat-s14 equal the NumPy oracle's; the
               unweighted run's rounds are replayed with no host sync
               for the card's busy time; then each run's rounds are
               recorded in one more call and replayed through every
               route, forced, and with the route left to the card
               (`replay_routes`): every route's bits equal the dense
               route's, and each round is timed per route beside the
               route the run took;
 7b. preds   - the min-id preds kernel against its plain version and
               the chain it replaced, bit for bit, at rmat-s20 for phase
               4's labels and phase 7's distances, timed at each chunk
               plan; the decode kernel (`plane_labels`) of the planes
               of a step-8 and of a chain search from phase 4's source
               against its plain version and the oracle's labels, timed
               beside its byte bound; the preds kernel timed on the same
               labels decoded, uploaded, and decoded with L2 written
               over; one preds launch per bfs.run/sssp.run that marks
               preds, one decode launch per such bfs.run, none without;
  8. cc      - cc.run(csr, mode="planes") at rmat-s20: component ids equal
               the minimum vertex id of each scipy component; its rounds
               replayed through every route as in phase 7;
  9. pr      - pr.run(csr, max_iter=5, mode="planes") at rmat-s20 is
               allclose (rtol 1e-4, atol 1e-6) to the NumPy oracle, and
               two calls give the same bits.
 10. chain   - one search of the chain kernel (whole BFS in one launch
               on one thread-block cluster) equals its plain version bit
               for bit (planes, visited words, depth), on one block with
               the visited map in shared memory (widths [1]) and on a
               cluster with the map in global memory (map_cap 0): paths
               of 600 and 2045 vertices from vertex 0,
               grid-64^2 and grid-256^2 from argmax(degrees), rmat-s14
               undirected and directed from the top-degree and a random
               vertex, and grid-1024^2 from argmax(degrees), with the
               layout the route takes from the level widths its
               8-plane loop counts, and forced to global memory.  At
               grid-1024^2 the kernel (CUDA events, median of 10; both
               placements) and the plain version are timed beside the
               bound, and so are (host clock, median of 3) the step_full
               baseline (SearchGraph.search with full planes, one launch
               and one host read per level) and the old route (the
               8-plane pass, then step_full);
 11. deep    - bfs.run(csr, src, traversal_mode="auto") at grid-1024^2
               from argmax(degrees): route "chain", labels and preds
               equal the NumPy oracle; one more call once went_deep is
               set takes exactly one chain launch and no warm-up search;
               the decode of that call's planes equals its plain
               version and the oracle's labels, timed as in phase 7b;
 12. touch   - the touched sweep and its fused form (& ~vw) equal the
               plain version at every level of a top-degree and a random
               search at rmat-s14 and rmat-s20 (no relabeling), at every
               level of the s20 search again with the staged frontier
               capped at TOUCH_CAP bytes, and on the edge-case graphs
               (empty, one-source and 30% frontiers, staged whole and not
               at all); at s20 both are timed on the frontier of the
               top-degree search's level-2 vertices, beside the bound, the
               plain version and one library call for the same hits, a
               CSR SpMV of the frontier indicator;
 13. swept   - at rmat-s20 from the top-degree vertex:
               bfs.run(traversal_mode="pallas"), bfs_pallas() with no
               depth cap and with max_depth=2 give the oracle's labels
               and preds (cut at depth 2), and get_pull_sweeper_v2's
               sweep from the source gives the oracle's level 1.

Phases 14-18 run on the undirected rmat-s20 above and on the directed
rmat-s20 ef16, seed 42, whose reverse CSC is a second upload:

 14. spmv    - the pull-SpMV (ops/spmv.py, the value kernel's ungated
               add sweep over the unrelabeled CSC) on a seeded contrib
               is allclose (rtol 1e-5, atol 1e-6) to its plain version,
               two kernel calls bitwise equal, on both s20 graphs and on
               the edge-case graphs; timed on the undirected graph
               beside its bound, the plain version and one library call
               for the same sums, a CSR SpMV;
 15. pr pallas - pr.run(csr, max_iter=5, mode="pallas") on the
               undirected graph, twice: allclose (rtol 1e-4, atol 1e-6)
               to the NumPy oracle and to phase 9's planes ranks, the
               two calls bitwise equal;
 16. hits, salsa - hits.run(src=top-degree, max_iter=10) and
               salsa.run(max_iter=10), mode="planes", allclose (rtol
               1e-4, atol 1e-6) to the NumPy oracles;
 17. wtf     - wtf.run(src=top-degree, cot_size=1000, mode="planes"):
               PPR allclose (rtol 1e-3, atol 1e-6) to the oracle's, the
               circle of trust score-equivalent per position, the ranks
               allclose to the oracle pinned to the port's circle;
 18. bc      - bc.run(src=top-degree, mode="planes"): labels equal
               bc_reference_fast's, values allclose (rtol 1e-4, atol
               1e-6), sigma equal below 2^24 and allclose (rtol 1e-6)
               above, two calls bitwise equal; the forward and reverse
               sweeps of one more call replayed through every route as
               in phase 7 (the BC rounds: phase 23 runs BC's default
               mode, which launches no kernel).

Phases 19-23 drive the default modes, the operator layer on a padded
DeviceGraph (ops/advance.py, segment.py, frontier.py, priority.py), on
the same graphs; in each entry-point call no hand-written kernel may
launch (every launch counter is zeroed before it and must read 0
after it):

 19. bfs xla - bfs.run(csr, top-degree src) at rmat-s20 undirected with
               traversal_mode "dense", "sparse" and "auto" with
               max_depth=3: labels and preds equal the NumPy oracle's
               (cut at depth 3 for the last) and phase 4's; one
               bfs_dense search profiled for the card's idle share;
 20. sssp xla - sssp.run with mode "sparse" (the default), "delta" and
               "bellman" at rmat-s20, unweighted and with phase 7's
               weights 1..63: distances equal scipy's Dijkstra and phase
               7's planes distances bit for bit; preds of each mode at
               rmat-s14 equal the oracle's; one unweighted sparse search
               profiled for the card's idle share;
 21. cc xla  - cc.run(csr) at rmat-s20: ids equal each scipy component's
               minimum id;
 22. rank xla - pr.run(max_iter=5) on the undirected graph, hits.run and
               salsa.run (max_iter=10) and wtf.run(cot_size=1000) on
               both s20 graphs: held to their oracles with phases 9 and
               15-17's tolerances; PR, HITS and SALSA bitwise equal on
               two calls;
 23. bc xla  - bc.run(src=top-degree) on both s20 graphs, held as phase
               18 holds it, two calls bitwise equal; bc.run(csr14) with
               every source (the default) allclose (rtol 1e-4, atol
               1e-6) to the all-sources Brandes oracle `bc_all_dense`
               (bc_reference's arithmetic in float64, every source at
               once as dense matrix products on the card).

Each entry point of phases 19-23 reports the host clock of its timed
call, after a warm-up call and ended by torch.cuda.synchronize(); these
windows are not in the kernels line.

Phases 24-28 run the last primitives and sampling at rmat-s20
undirected, seed 42, each call inside the same no-kernel window:

 24. topk    - topk.run(k=1000) equals topk_degree_reference exactly;
 25. dobfs   - dobfs.run from phase 4's source: labels and preds equal
               phase 4's oracle's; pull_levels printed;
 26. mis     - mis.run(seed=0), checked by one vectorized NumPy pass
               over the edges (`check_mis`, independent of the port's
               code): every vertex beats each neighbour decided in its
               round or later, one decided in round r > 0 was beaten in
               round r-1, and in_set is independent and maximal;
 27. mst     - mst.run on phase 7's weights 1..63: total weight allclose
               (rtol 1e-6) to scipy's minimum_spanning_tree summed in
               float64; n - components edges, whose scipy components
               equal the input's; the host canonical_edges time;
 28. sample  - sample_khop from the 1024 top-degree seeds, k=10, 2 hops,
               from a CUDA generator: every valid (v, nbr, eid) an edge
               of v's CSR segment, the dummies masked, one seed the same
               bits twice (and the same as explicit draws of it);
 29. host    - cli.main at rmat-s16 undirected, validation on, for sssp
               (default), cc planes, pr pallas, bfs mega, topk, dobfs,
               mis and mst: each prints CORRECTNESS: PASSED, the first
               four launch value_step, value_step, the pull-SpMV and
               mega_step (their counts join the kernels line's
               launches_by_path) and nothing else, the last four
               nothing; api.bfs/sssp/cc/bc/pagerank/topk at rmat-s16
               equal the primitives' own calls; SteppedBfs
               (slice_depth=2) at rmat-s20 gives phase 4's labels, with
               its tracer's summary (avg_duty).

Phases 30-32 run the multi-device tier (gunrockinst_tpu_torch.parallel)
at rmat-s20 undirected (and directed for HITS, SALSA and WTF), weights
1..63 for SSSP, grid-1024^2 from vertex 0 for the deep BFS and phase
27's canonical MST edges; every call is timed (`parallel.mesh.timed`:
a warm-up with each collective bracketed by syncs, then the timed call
ended by a device sync) and prints its wall ms, levels or rounds,
modelled bytes a rank and the warm-up's ms inside collectives:

 30. words   - the 12 word-exchange entry points (`*_dist_words`) on one
               rank, nccl, in this process, each call inside a
               no-kernel window, held to the oracles of earlier phases
               (BFS and DOBFS to phase 4's, the grid to Manhattan
               distance, SSSP to scipy's Dijkstra, CC to scipy's
               components, BC, HITS, SALSA and WTF to phases 16-18's
               oracles, MIS independent and maximal, TopK to its
               oracle, MST to scipy's weight; PR, at phase 9's 6
               iterations, to phase 9's oracle and pr.run planes ranks,
               rtol 1e-4, atol 1e-6);
               the two partition builders' host and device memory peaks
               at rmat-s20 are printed;
 31. ranks   - the same calls on 4 ranks sharing the card through gloo
               (a RankPool; the exchange path printed): integer outputs
               equal phase 30's bit for bit, float outputs allclose
               (rtol 1e-4, atol 1e-6); each rank's partition memory
               peaks and peak RSS printed;
 32. replica - the 12 replicated fallbacks (`parallel/dist.py`,
               `dist_more.py`) on one rank (nccl) and on the 4 ranks,
               held the same ways.

Launch counts come from the trace's totals (`utils/trace.py`'s
`launch.*` counters; the value kernel's summed over its routes).
Launch counts of the BFS kernel are zeroed just before phase 4 and read
just after phase 5; those of the value kernel are zeroed just before
and read just after each entry-point call of phases 7-9 (sssp, sssp
weighted, cc, pr), so the replays and the rmat-s14 check do not count,
and with them the card's tally of the value kernel's launches per route
(`value.route_launches`, printed per path for phases 7-9 and 15-18; the
sum must equal the launches, and sssp, sssp weighted, cc and both bc
paths must have pushed or touched at least once);
the preds kernel's and the decode's around each entry-point call of
phase 7b, the chain kernel's around phase 11's bfs.run, the touched
sweep's around each entry-point call of phase 13, the pull-SpMV's
around phase 15's pr.run calls, and the value kernel's again around each
entry-point call of phases 16-18, and every count around each CLI
subcommand of phase 29.  Phases 3, 6, 10, 12 and 14, which
hold kernels against their plain versions and time them, count for no
path.  A path with no launch in its window fails the run.  The
last lines are the kernels line, the nvidia-smi line and {"ok": true,
...}.  Without CUDA the script exits nonzero and prints no result; a
watchdog ends a hung run with a traceback and a nonzero exit.

A level's bound is the lesser of the bounds of its two orders (pull and
push), each the larger of its bytes over 3.35 TB/s and its operations
over 67 T/s (H100 SXM data sheet: HBM rate and the non-tensor 32-bit
rate).  Pull bytes: vw and reach read whole and nfw written whole; one
CSC offset per candidate vertex (reachable and unvisited); the in-edge
ids a candidate must read up to its first frontier hit (all of them
when there is none) and the frontier words those ids point to.  Push
bytes: fw read whole and nfw written whole; one out-offset per frontier
vertex and its out-edge ids; the reach and visited words of the
destinations.  Both: for each word that gains a vertex, the vw' word and
the label plane word of each set bit of d written.  Operations: three
per edge read.

A value sweep's bound is the least of the bounds of the routes it may
take (`route_work`), as a level's is.  Dense (the pull): the CSC offsets
and in-edge ids read whole, the weights of the edges whose source is
active (sssp_w), the values read and written once, the ch map read
(gated configurations) and the changed map written; operations: one
gate test per in-edge and two per active in-edge (add, combine).  Push
(a min): one out-offset per active source and its out-edge ids, their
weights (sssp_w), the values read and written once, ch read and the
changed map written; two operations per active out-edge.  Touched: the
push's bytes plus the in-edge ids and offsets of the touched words; the
push's operations plus a gate test per in-edge of a touched word and
two per active in-edge.

A chain search's bound counts the offset and out-edge ids of each
visited vertex read once and the planes, visited words and depth
written once; operations: three per out-edge read.  A touched sweep's
bound counts, as a level's does, one offset per candidate vertex (every
vertex; the unvisited ones for the fused form), the in-edge ids read up
to the first frontier hit and the frontier words they point to, and the
output written (and vw read) whole.  The pull-SpMV's bound counts the
CSC offsets and in-edge ids read whole, contrib read and the sums
written once; operations: one add per in-edge.

Phases 6, 12 and 14 also time each sweep on inputs that isolate where
its time goes: the value sweeps and the pull-SpMV with every in-edge id
replaced by 0 (the same walks and id loads, every gather one word), the
touched sweep with every frontier bit set (the least walk) and with none
(every id of the CSC).  `--variants DIR` runs only timings on the
kernels of the checkout at DIR (this one, or an unpacked earlier commit,
so that two versions are timed on one card in one call), through the
wrappers' calls that every version of the port has (the value sweeps by
their dense route where the wrapper has routes, each printed with a
digest of its output bits, which must match across checkouts): the step kernel per
level of the four rmat searches of phase 3 (and forced to push and to
pull, where the wrapper has a direction) and on a level with no
candidate; at grid-1024^2 the 8-plane host level loop (wall time, and
per level the host time in the step wrapper, of it the wrapper's C
call, and the time between CUDA events around the step; then its
Python functions by cProfile); the chain kernel on the 2045-vertex path,
at grid-1024^2, on the 112^3 lattice (wide levels) and on rmat-s18 with
a 400-vertex tail (a wide core, then a thin tail), in each layout where
the wrapper has a choice, with the layout the route would take (unless
`sweeps` is given); then, unless `bfs` is given, the s20 sweeps as they
are and on those inputs.  `walls` times only the entry points that the
value kernel carries (`walls`).  It prints lines, no result.

Phases 5 and 7 also replay their searches (levels, rounds) with no host
sync in between, queued behind a device sleep, so that CUDA events time
the card's work alone; the card's idle share of the call is one minus
that time over the call's wall time.
"""

from __future__ import annotations

import contextlib
import faulthandler
import inspect
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

if __name__ == "__main__" and sys.argv[1:2] == ["--variants"]:
    sys.path.insert(0, str(Path(sys.argv[2]).resolve()))   # DIR's package

import numpy as np
import torch

from gunrockinst_tpu_torch.device import resolve_device, upload
from gunrockinst_tpu_torch.graph.coo import CooGraph
from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.graph.lattice import grid_graph
from gunrockinst_tpu_torch.graph.relabel import is_symmetric
from gunrockinst_tpu_torch.graph.rmat import rmat_graph
from gunrockinst_tpu_torch.ops import _build, chain, mega, pull, spmv, value
from gunrockinst_tpu_torch.ops.words import (mask_from_words, pack_bitmap,
                                             start_words, unpack_bitmap,
                                             word_rows, words_from_mask)
from gunrockinst_tpu_torch.oracles import (bc_reference_fast,
                                           bfs_reference, hits_reference,
                                           pagerank_reference,
                                           salsa_reference, sssp_reference,
                                           wtf_reference)
from gunrockinst_tpu_torch.primitives import (bc, bfs, bfs_pallas, cc, hits,
                                              pr, salsa, sssp, wtf)
from gunrockinst_tpu_torch.primitives.base import device_graph
from gunrockinst_tpu_torch.primitives.search_graph import search_graph

WATCHDOG_S = 1100          # under the 1200 s limit of a smoke run
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
SEED = 42
MULTI_K = 64
KERNELS = {   # every kernel of the BFS and value-plane paths
    "mega_step": dict(
        route="cuda", source="gunrockinst_tpu_torch/csrc/mega_step.cu",
        replaces="gunrockinst_tpu/ops/pallas_mega.py:422"),
    "value_step": dict(
        route="cuda", source="gunrockinst_tpu_torch/csrc/value_step.cu",
        replaces="gunrockinst_tpu/ops/pallas_value.py:608"),
    "chain_bfs": dict(
        route="cuda", source="gunrockinst_tpu_torch/csrc/chain_bfs.cu",
        replaces="gunrockinst_tpu/ops/pallas_mega.py:566"),
    # one kernel for the three TPU touched sweeps (K4, K5, K6)
    "touch_sweep": dict(
        route="cuda", source="gunrockinst_tpu_torch/csrc/touch_sweep.cu",
        replaces="gunrockinst_tpu/ops/pallas_advance_v3.py:372",
        also_replaces=["gunrockinst_tpu/ops/pallas_advance_v2.py:291",
                       "gunrockinst_tpu/ops/pallas_advance_v2.py:317",
                       "gunrockinst_tpu/ops/pallas_advance.py:144",
                       "gunrockinst_tpu/ops/pallas_advance.py:191"]),
    # the value kernel's ungated add sweep over the unrelabeled CSC (K7)
    "spmv": dict(
        route="cuda", source="gunrockinst_tpu_torch/csrc/value_step.cu",
        replaces="gunrockinst_tpu/ops/pallas_spmv.py:273",
        also_replaces=["gunrockinst_tpu/ops/pallas_spmv.py:296"]),
    # the min-id preds of BFS and SSSP: the JAX package's are XLA's
    # scatter-min, so no TPU kernel stands behind it
    "min_preds": dict(
        route="cuda", source="gunrockinst_tpu_torch/csrc/min_preds.cu",
        replaces=None),
    # the decode of a search's label planes into the labels the preds
    # kernel reads: the JAX package assembles its labels on the host, so
    # no TPU kernel stands behind it
    "plane_labels": dict(
        route="cuda", source="gunrockinst_tpu_torch/csrc/min_preds.cu",
        replaces=None),
}
HUB_IDS = 256          # mega_step.cu's kHub: longer out-lists are listed
CHAIN_PATH = 600       # phase 10's first graph: a path, depth 600
CHAIN_DEEP = 2045      # a path as deep as grid-1024^2's search: one vertex
                       # a level, the fixed cost of a chain level
# the value kernel's configurations on the path (ops/value.py keywords)
VALUE_CONFIGS = {
    "sssp_w": dict(mode="min", f32=True),          # weights per edge
    "sssp_c": dict(mode="min", f32=True, const_w=1.0),
    "cc": dict(mode="min", f32=False),
    "pr": dict(mode="add", f32=True, use_active=False),
    "bc_fwd": dict(mode="add", f32=True, use_active=True),   # BC's sweeps
}
LONG_DEGREES = (32, 64, 128, 256, 512)   # phase 6's threshold sweep, s20
# phase 7b's preds plans (long_degree, chunk); ops/preds.py's default first
PREDS_PLANS = ((32, 1024), (32, 128), (32, 256), (32, 512), (64, 1024),
               (128, 128))
ROUTED = ("sssp_w", "sssp_c", "cc", "bc_fwd")   # gated: a route to choose
ACTIVE_SHARES = (0.0001, 0.001, 0.01, 0.1, 0.5, 1.0)   # phase 6's
TOUCH_CAP = 16384      # bytes: a frontier staging budget below n_words,
                       # so the touched sweep's L2 path runs too
STAR_N = 100_003       # the edge-case graphs (edge_graphs): n % 32 != 0
RAGGED_N = 50_001
# kernel times of earlier runs (PERF.md section 6; NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside this run's: the value sweeps' and the
# pull-SpMV's of this kernel, the touched sweep's of its previous design
EARLIER_US = {"sssp_w": "228.5-228.8", "sssp_c": "172.5-176.3",
              "cc": "169.3-173.5", "pr": "177.3-178.3",
              "bc_fwd": "167.0-167.2", "touch": "282.3-284.0",
              "touch fused": "9.4-9.8", "spmv": "218.7-218.8"}
# the BFS kernels' earlier designs (PRs 4-8), in ms: the step kernel per
# rmat-s20 top-degree search, the chain kernel per grid-1024^2 search
EARLIER_MS = {"step": "0.1231-0.1262", "chain": "17.25-18.09"}
PR_ITERS = 5
RANK_ITERS = 10        # phase 16: HITS and SALSA iterations
COT_SIZE = 1000        # phase 17
INF32 = np.iinfo(np.int32).max


_launch_base: dict = {}


def _launch_total(kernel: str) -> int:
    """The trace's total launches of `kernel` (a key of KERNELS; the
    value kernel's summed over its routes).  Imported here, not at the
    top: `--variants DIR` may load a package without `utils/trace.py`,
    and counts no launch."""
    from gunrockinst_tpu_torch.utils import trace
    totals = trace.totals()
    if kernel == "value_step":
        return sum(v for k, v in totals.items()
                   if k.startswith("launch.value_step."))
    return totals.get(f"launch.{kernel}", 0)


def zero_launches(*kernels: str) -> None:
    """Count the launches of `kernels` from here on; with none named,
    reset every trace total (`trace.reset_totals`)."""
    if not kernels:
        from gunrockinst_tpu_torch.utils import trace
        trace.reset_totals()
        _launch_base.clear()
    for k in kernels:
        _launch_base[k] = _launch_total(k)


def launches_of(kernel: str) -> int:
    """Launches of `kernel` since `zero_launches` last named it (or
    reset every total)."""
    return _launch_total(kernel) - _launch_base.get(kernel, 0)


def warm_ups() -> int:
    """The entry points' warm-up searches so far (`warmup.search`): one
    on a cached search object's first call and one on a route switch."""
    from gunrockinst_tpu_torch.utils import trace
    return trace.totals().get("warmup.search", 0)


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


def graph(scale, undirected=True):
    t0 = time.perf_counter()
    csr = rmat_graph(scale, 16, undirected=undirected, seed=SEED)
    print(f"  rmat-s{scale} ef16 {'un' if undirected else ''}directed: "
          f"{csr.num_nodes} vertices, {csr.num_edges} directed edges "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return csr


def sources(csr):
    """The top-degree vertex and a random vertex with an edge."""
    rng = np.random.default_rng(SEED)
    return (int(np.argmax(csr.degrees)),
            int(rng.choice(np.flatnonzero(csr.degrees > 0))))


def pull_work(offsets, in_src, dst, fw, cand):
    """What a pull over the CSC (offsets, in_src; dst per edge) from
    frontier words fw must read for the candidate vertices `cand` ((n,)
    bool): a candidate reads its in-edges up to its first frontier hit,
    or all of them when there is none.  Returns (in-edge ids read,
    distinct frontier words they point to, candidates, the candidates
    with a hit)."""
    n, m = offsets.numel() - 1, in_src.numel()
    hit = unpack_bitmap(fw, fw.numel() * 32)[in_src.long()]
    pos = torch.arange(m, device=fw.device)
    first = torch.full((n,), m, dtype=torch.int64, device=fw.device)
    first.scatter_reduce_(0, dst, torch.where(hit, pos, m), "amin")
    scanned = cand[dst] & (pos <= first[dst])
    fw_words = int(torch.unique(in_src[scanned] >> 5).numel())
    return (int(scanned.sum()), fw_words, int(cand.sum()),
            torch.nonzero(cand & (first < m)).squeeze(1))


def level_work(g, fw, vw, reach, d, n_planes):
    """(bytes, operations, direction) of the cheaper of the two orders
    of one level on these inputs, by its bound.  Pull: vw and reach read
    whole and nfw written whole; one CSC offset per candidate vertex
    (reachable and unvisited); the in-edge ids a candidate must read up
    to its first frontier hit (all of them when there is none) and the
    frontier words those ids point to.  Push: fw read whole and nfw
    written whole; one out-offset per frontier vertex and its out-edge
    ids; the reach and visited words of the destinations.  Both: for
    each word that gains a vertex, the vw' word and the label plane word
    of each set bit of d written.  Operations: three per edge read."""
    st = g.stepper
    cand = unpack_bitmap(reach & ~vw, st.n)
    edges, fw_words, cands, new = pull_work(st.offsets, st.in_src,
                                            st.edge_dst(), fw, cand)
    changed = int(torch.unique(new >> 5).numel())
    planes_hit = bin(d & ((1 << n_planes) - 1)).count("1")
    written = changed * (1 + planes_hit)
    pull = (4 * (3 * g.n_words + fw_words + cands + edges + written),
            3 * edges, "pull")
    out_off, out_dst = st.out_csr()
    front = torch.nonzero(unpack_bitmap(fw, st.n)).squeeze(1)
    beg, end = out_off[front].long(), out_off[front + 1].long()
    out_edges = int((end - beg).sum())
    span = end - beg
    first = torch.repeat_interleave(beg - torch.cumsum(span, 0) + span, span)
    dst = out_dst[first + torch.arange(first.numel(), device=fw.device)]
    dst_words = int(torch.unique(dst.long() >> 5).numel())
    push = (4 * (2 * g.n_words + front.numel() + out_edges + 2 * dst_words
                 + written), 3 * out_edges, "push")
    return min(pull, push, key=lambda w: bound_ms(w[0], w[1]))


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
    """Every level of the search from psrc through the kernel (in every
    direction it can be forced to) and the plain version on the same
    inputs; raises on the first difference.  Then the whole search as
    the main path runs it (`SearchGraph.search`: each level's input the
    kernel's own output, the direction chosen on the card) against the
    plain version's final visited words, planes and depth.  Returns the
    per-level inputs and the largest |kernel - plain|."""
    st = g.stepper
    reach = g.reach(psrc)
    fw = g.start(psrc)
    vw = fw.clone()
    planes = torch.zeros((8 * g.rows, 128), dtype=torch.int32,
                         device=fw.device)
    levels, max_err = [], 0
    hows = step_directions(st)
    for d in range(1, g.n + 1):
        want = mega.step_reference(st.offsets, st.in_src, fw, vw, planes,
                                   d, reach, st.edge_dst())
        for how in hows:
            kw = {} if how == "as is" else dict(direction=how)
            vw_k, planes_k = vw.clone(), planes.clone()
            nfw_k, new_k = st.step(fw, vw_k, planes_k, d, reach, **kw)
            torch.cuda.synchronize()
            check_level_word(st, new_k, int(want[3]), how,
                             f"{label} level {d}")
            for name, got, exp in zip(("nfw", "vw'", "planes'", "n_new"),
                                      (nfw_k, vw_k, planes_k, new_k), want):
                err = int((got.long() - exp.long()).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(got, exp):
                    raise AssertionError(
                        f"{label} level {d} ({how}): kernel {name} differs "
                        f"from the plain version (max |diff| {err})")
        levels.append(dict(d=d, fw=fw, vw=vw, planes=planes,
                           n_new=int(want[3])))
        fw, vw, planes = want[0], want[1], want[2]
        if int(want[3]) == 0:
            break
    planes_c, vw_c, depth_c, _ = g.search(psrc, reach, 8, g.n)
    if depth_c != len(levels) or not (torch.equal(vw_c, vw)
                                      and torch.equal(planes_c, planes)):
        raise AssertionError(f"{label}: the chained search differs from "
                             f"the plain version (depth {depth_c}, "
                             f"expected {len(levels)})")
    print(f"  {label}: {len(levels)} levels equal to the plain version, "
          f"{' and '.join(hows)} (tolerance: bitwise; new per level "
          f"{[lv['n_new'] for lv in levels]}; the direction read beside "
          f"n_new equal to last_direction()); the chained search too",
          flush=True)
    return levels, reach, max_err


def check_level_word(st, n_new, want_new, how, label):
    """The direction the kernel wrote beside `n_new` (read with the
    count in the level loop's one read) against the slot's
    `last_direction()` and, where forced, the order asked for; the
    count read with it equals the plain version's."""
    count, way = st.read_level(n_new)
    slot = st.last_direction()
    if count != want_new or way != slot or how not in ("auto", way):
        raise AssertionError(
            f"{label} ({how}): read beside n_new {count} and {way!r}, "
            f"expected {want_new} and the slot's {slot!r}")


def raw_alias(t):
    """A tensor on t's memory with a version counter of its own: a write
    through it is what a raw kernel's write is to t (t._version stays)."""
    class Raw:
        __cuda_array_interface__ = dict(
            shape=tuple(t.shape), typestr="<i4", strides=None,
            data=(t.data_ptr(), False), version=2)
    return torch.as_tensor(Raw(), device=t.device)


def compare_stale_slot(g, psrc, label):
    """Level 2 of the search from psrc on a frontier edited after the
    launch that made it, through a raw pointer: a hub (more than
    HUB_IDS out-ids) that launch did not claim goes in and one it
    claimed (and listed) comes out, so the slot the wrapper still
    trusts lists the wrong hubs.  Each direction must still equal the
    plain version on the edited input; raises otherwise."""
    st = g.stepper
    reach = g.reach(psrc)
    out_off = st.out_csr()[0]
    hub = (out_off[1:] - out_off[:-1]) > HUB_IDS
    hows = step_directions(st)
    for how in hows:
        kw = {} if how == "as is" else dict(direction=how)
        fw = g.start(psrc)
        vw = fw.clone()
        planes = torch.zeros((8 * g.rows, 128), dtype=torch.int32,
                             device=fw.device)
        nfw, _ = st.step(fw, vw, planes, 1, reach)
        front = unpack_bitmap(nfw, g.n)
        gone = torch.nonzero(hub & front).flatten()
        added = torch.nonzero(hub & ~front).flatten()
        if gone.numel() == 0 or added.numel() == 0:
            raise AssertionError(f"{label}: no listed hub to take out or "
                                 "no other hub to put in")
        version = nfw._version
        words = raw_alias(nfw).view(-1)
        u, v = int(added[0]), int(gone[0])
        words[u >> 5] |= int(np.int32(np.uint32(1 << (u & 31))))
        words[v >> 5] &= int(np.int32(np.uint32(~(1 << (v & 31)) &
                                                0xffffffff)))
        if nfw._version != version or st._last_nfw is not nfw:
            raise AssertionError(f"{label}: the wrapper would not trust "
                                 "its slot; the case tests nothing")
        want = mega.step_reference(st.offsets, st.in_src, nfw, vw, planes,
                                   2, reach, st.edge_dst())
        got = st.step(nfw, vw, planes, 2, reach, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("nfw", "vw'", "planes'", "n_new"),
                              (got[0], vw, planes, got[1]), want):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{label} ({how}): on a frontier edited behind the "
                    f"wrapper's back, kernel {name} differs from the "
                    "plain version")
    print(f"  {label}: level 2 on a frontier edited through a raw pointer "
          f"after level 1 (hub {u} put in, listed hub {v} taken out; the "
          f"wrapper trusted its stale slot) equal to the plain version, "
          f"{' and '.join(hows)} (tolerance: bitwise)", flush=True)


def chained_directions(g, psrc, depth):
    """The direction each level of the search from psrc took on the
    card, run as the main path runs it (one host read per level)."""
    st = g.stepper
    reach = g.reach(psrc)
    fw = g.start(psrc)
    vw = fw.clone()
    planes = torch.zeros((8 * g.rows, 128), dtype=torch.int32,
                         device=fw.device)
    taken = []
    for d in range(1, depth + 1):
        fw, _ = st.step(fw, vw, planes, d, reach)
        taken.append(st.last_direction())
    return taken


def time_levels(g, levels, reach, psrc, label, card):
    """Per-level kernel ms (chained, as the main path runs the search;
    also forced to push and to pull), the direction each level took,
    plain ms and bound ms of one search."""
    st = g.stepper
    depth = len(levels)
    chained, whole = chained_levels_ms(g, psrc, depth, 20)
    forced = {how: chained_levels_ms(g, psrc, depth, 20, direction=how)[0]
              for how in ("push", "pull")}
    taken = chained_directions(g, psrc, depth)
    rows = []
    for i, lv in enumerate(levels):
        d, fw, vw, planes = lv["d"], lv["fw"], lv["vw"], lv["planes"]
        p_ms = event_ms(lambda: mega.step_reference(
            st.offsets, st.in_src, fw, vw, planes, d, reach,
            st.edge_dst()), lambda: None, 5)
        nbytes, ops, order = level_work(g, fw, vw, reach, d,
                                        planes.shape[0] // g.rows)
        rows.append(dict(d=d, n_new=lv["n_new"], bytes=nbytes, ops=ops,
                         ms=chained[i], plain_ms=p_ms, direction=taken[i],
                         bound_ms=bound_ms(nbytes, ops), bound_order=order))
        print(f"  {label} level {d}: new {lv['n_new']}, took {taken[i]}, "
              f"kernel {chained[i] * 1e3:.1f} us (push "
              f"{forced['push'][i] * 1e3:.1f}, pull "
              f"{forced['pull'][i] * 1e3:.1f}), plain {p_ms * 1e3:.1f} us, "
              f"bound {rows[-1]['bound_ms'] * 1e3:.2f} us ({order}, "
              f"{nbytes} B) [{card}]", flush=True)
    print(f"  {label}: search {whole * 1e3:.1f} us chained (sum of levels "
          f"{sum(r['ms'] for r in rows) * 1e3:.1f} us; earlier design "
          f"{EARLIER_MS['step']} ms at s20 top-degree), bound "
          f"{sum(r['bound_ms'] for r in rows) * 1e3:.2f} us [{card}]",
          flush=True)
    return rows


def value_case(g, name, rng, **kw):
    """(stepper, vals, ch) of one configuration on g's device CSC, with
    seeded inputs (`value_inputs`); `kw` goes to the stepper.  A gated
    stepper without per-edge weights walks g's out-edge CSR, as the
    main path's do."""
    st = g.stepper
    cfg = VALUE_CONFIGS[name]
    if name != "sssp_w" and cfg.get("use_active", True):
        kw.setdefault("out_edges", g.reverse)
    return value_inputs(st.offsets, st.in_src, g.n, name, rng, **kw)


def value_inputs(offsets, in_src, n, name, rng, **kw):
    """(stepper, vals, ch) of one configuration on the device CSC
    (offsets, in_src) of n vertices, with seeded inputs: f32 values in
    [0, 100) with 30% inf, or i32 labels in [0, n), or f32 contributions
    in [0, 1) (pr, bc_fwd); half the ch bits set (all of them for pr);
    integer weights 1..63 for sssp_w.  `kw` goes to the stepper."""
    n_words = word_rows(n) * 128
    n_pad, m = n_words * 32, in_src.numel()
    kw = dict(VALUE_CONFIGS[name], **kw)
    if name == "sssp_w":
        kw["weights"] = torch.from_numpy(
            rng.integers(1, 64, m).astype(np.float32)).to(in_src.device)
    stepper = value.ValueStepper(offsets, in_src, **kw)
    if name == "cc":
        vals = rng.integers(0, n, n_pad).astype(np.int32)
    elif name in ("pr", "bc_fwd"):
        vals = rng.random(n_pad, dtype=np.float32).view(np.int32)
    else:
        f = (rng.random(n_pad, dtype=np.float32) * 100).astype(np.float32)
        f[rng.random(n_pad) < 0.3] = np.inf
        vals = f.view(np.int32)
    active = rng.random(n_pad) < (1.0 if name == "pr" else 0.5)
    ch = torch.from_numpy(words_from_mask(active, n_words)).to(in_src.device)
    return stepper, torch.from_numpy(vals).to(in_src.device), ch


def edge_graphs():
    """Two small graphs for the kernels' edge cases, as host CSCs
    {name: (col_offsets, in_src, n)}, both with n not a multiple of 32:
    a star whose centre (mid-word) holds every in-edge, and a seeded
    random graph with 16 in-edges a vertex on average."""
    n = STAR_N
    centre = n // 2 + 5
    star_off = np.zeros(n + 1, np.int64)
    star_off[centre + 1:] = n - 1
    star_src = np.delete(np.arange(n), centre)
    n_r = RAGGED_N
    rng = np.random.default_rng(SEED)
    src = rng.integers(0, n_r, 16 * n_r)
    dst = rng.integers(0, n_r, 16 * n_r)
    order = np.argsort(dst, kind="stable")
    r_off = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n_r))])
    return {f"star-{n}": (star_off, star_src, n),
            f"random-{n_r}": (r_off, src[order], n_r)}


def step_edge_graphs():
    """The step kernel's edge-case graphs as CsrGraphs: `edge_graphs`'
    star (every edge into its centre), the same star reversed (every
    edge out of it: a push hub), the random graph (n not a multiple of
    32, directed), and rmat-s14 directed."""
    out = {}
    for name, (col_offsets, in_src, n) in edge_graphs().items():
        into = CsrGraph.from_arrays(col_offsets, in_src)   # the transpose
        if name.startswith("star"):
            out[f"{name} out"] = into
            out[f"{name} in"] = into.transposed()
        else:
            out[name] = into.transposed()
    out["s14 directed"] = graph(14, undirected=False)
    return out


def on_device(col_offsets, in_src, dev):
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
                 .to(dev) for a in (col_offsets, in_src))


def compare_value(stepper, vals, ch, label, route=None):
    """One sweep through the kernel (by `route`, or the one it picks)
    and the plain version of that route (dense when picked); raises on
    a difference.  Returns the largest |kernel - plain| of the values."""
    got = stepper.sweep(vals, ch, route=route)
    torch.cuda.synchronize()
    want = stepper.reference(vals, ch, route or "dense")
    dtype = torch.float32 if stepper.f32 else torch.int32
    x, y = got[0].view(dtype), want[0].view(dtype)
    both = torch.isfinite(x) & torch.isfinite(y) if stepper.f32 else \
        torch.ones_like(x, dtype=torch.bool)
    err = float((x[both].double() - y[both].double()).abs().max())
    if stepper.mode == "min":
        for what, a, b in zip(("out", "changed", "n_changed"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: kernel {what} differs from "
                                     f"the plain version (max |diff| "
                                     f"{err})")
        tol = "bitwise"
    else:
        if not torch.allclose(x, y, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"{label}: kernel sums differ from the "
                                 f"plain version beyond rtol 1e-5, atol "
                                 f"1e-6 (max |diff| {err})")
        again = stepper.sweep(vals, ch, route=route)[0]
        if not torch.equal(again, got[0]):
            raise AssertionError(f"{label}: two kernel runs differ")
        tol = "allclose rtol 1e-5 atol 1e-6, two runs bitwise"
    print(f"  {label}: equal to the plain version ({tol}; max |diff| "
          f"{err:.3g}, changed {int(got[2])})", flush=True)
    return err


def routes_of(stepper):
    """The routes a stepper may take."""
    if not stepper.use_active:
        return ("dense",)
    return tuple(r for r in value.ROUTES if r != "push" or stepper.push_ok)


def route_work(stepper, vals, ch):
    """{route: (bytes, operations)} one sweep needs on these inputs, for
    each route the stepper may take.  Dense (the pull): the CSC offsets
    and in-edge ids read whole, the weights of the in-edges whose
    source is active (per-edge weights), the values read and written
    once, the ch map read (gated) and the changed map written; one gate
    test per in-edge (gated) and two operations per active in-edge.
    Push: one out-offset per active source and its out-edge ids, their
    weights (per-edge), the values read and written once, ch read and
    the changed map written; two operations per active out-edge.
    Touched: the push's bytes plus the in-edge ids and the offsets of
    the touched words; the push's operations plus one gate test per
    in-edge of a touched word and two per active in-edge (every active
    in-edge lands in a touched word)."""
    n, m = stepper.n, stepper.m
    n_pad, n_words = stepper.n_pad, stepper.n_words
    gated = stepper.use_active
    active_in = (int(unpack_bitmap(ch, n_pad)[stepper.in_src.long()].sum())
                 if gated else m)
    pull = 4 * ((n + 1) + m + 2 * n_pad + n_words + 1
                + (n_words if gated else 0))
    if stepper.weights is not None:
        pull += 4 * active_in
    work = {"dense": (pull, (m if gated else 0) + 2 * active_in)}
    if not gated:
        return work
    out_off, out_dst, _ = stepper.out_csr()
    count, edges = value.active_stats(out_off, ch)
    push = 4 * (count + edges + 2 * n_pad + 2 * n_words + 2)
    if stepper.weights is not None:
        push += 4 * edges
    if stepper.push_ok:
        work["push"] = (push, 2 * edges)
    words = torch.nonzero(value.touched_words(out_off, out_dst, ch)).squeeze(1)
    off = stepper.offsets
    t_edges = int((off[torch.clamp(32 * words + 32, max=n)]
                   - off[torch.clamp(32 * words, max=n)]).sum())
    work["touched"] = (push + 4 * (t_edges + 33 * words.numel()),
                       2 * edges + t_edges + 2 * active_in)
    return work


def value_work(stepper, vals, ch):
    """(bytes, operations) of one sweep on these inputs: those of the
    route whose bound is least (`route_work`)."""
    return min(route_work(stepper, vals, ch).values(),
               key=lambda w: bound_ms(*w))


def time_value(stepper, vals, ch, name, card):
    """Kernel, plain and (pr) library ms of one sweep, and its bound."""
    out = torch.empty_like(vals)
    k_ms = event_ms(lambda: stepper.sweep(vals, ch, out=out, route="dense"),
                    lambda: None, 20)
    p_ms = event_ms(lambda: stepper.reference(vals, ch), lambda: None, 5)
    lib_ms = None
    if name == "pr":
        # yardstick only: the same sums by one library call, a CSR SpMV
        # of the CSC with unit values; never used by the port
        st = stepper
        with warnings.catch_warnings():    # sparse CSR is "beta"
            warnings.simplefilter("ignore")
            a = torch.sparse_csr_tensor(
                st.offsets, st.in_src,
                torch.ones(st.in_src.numel(), dtype=torch.float32,
                           device=vals.device), size=(st.n, st.n))
        x = vals[: st.n].view(torch.float32).clone()
        lib = a @ x
        err = float((lib - out[: st.n].view(torch.float32)).abs().max())
        lib_ms = event_ms(lambda: a @ x, lambda: None, 20)
        print(f"  pr library SpMV: max |diff| to the kernel {err:.3g}",
              flush=True)
    nbytes, ops = value_work(stepper, vals, ch)
    row = dict(name=name, bytes=nbytes, ops=ops, ms=k_ms, plain_ms=p_ms,
               library_ms=lib_ms, bound_ms=bound_ms(nbytes, ops))
    print(f"  {name}: {nbytes} B, dense kernel {k_ms * 1e3:.1f} us (earlier "
          f"runs: {EARLIER_US[name]} us; one source "
          f"{one_source_ms(stepper, vals, ch, name) * 1e3:.1f} us), plain "
          f"{p_ms * 1e3:.1f} us, bound {row['bound_ms'] * 1e3:.2f} us, "
          "library "
          + ("null" if lib_ms is None else f"{lib_ms * 1e3:.1f} us")
          + f" [{card}]", flush=True)
    return row


def one_source_ms(stepper, vals, ch, name):
    """Kernel ms of the sweep with every in-edge id replaced by 0 (and
    source 0 active): the same offsets, id loads and walks, but every
    value and gate gather reads one word, so the gap to the real sweep
    is what the scattered gathers cost."""
    one = value.ValueStepper(stepper.offsets,
                             torch.zeros_like(stepper.in_src),
                             weights=stepper.weights, **VALUE_CONFIGS[name])
    ch1 = ch.clone()
    ch1.view(-1)[0] |= 1
    out = torch.empty_like(vals)
    return event_ms(lambda: one.sweep(vals, ch1, out=out, **dense_kw(one)),
                    lambda: None, 20)


def replay_rounds_ms(stepper, vals, ch, rounds, want):
    """Device ms of `rounds` sweeps from (vals, ch) with no host sync in
    between, queued behind a device sleep; the final values must equal
    `want` (the main run's, in search ids)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    asleep = torch.cuda.Event()
    spare = torch.empty_like(vals)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    asleep.record()
    start.record()
    for _ in range(rounds):
        out, ch, _ = stepper.sweep(vals, ch, out=spare)
        vals, spare = out, vals
    end.record()
    if asleep.query():
        raise AssertionError("the card woke before the replay was queued; "
                             "its events would hold host gaps")
    torch.cuda.synchronize()
    if not torch.equal(vals, want):
        raise AssertionError("the replayed rounds differ from the main run")
    return start.elapsed_time(end)


def scipy_dist(csr, src):
    """Dijkstra distances from scipy, cast to f32 (exact for the integer
    weights used here: every distance is an integer below 2^24)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    w = (np.ones(csr.num_edges) if csr.edge_values is None
         else csr.edge_values.astype(np.float64))
    a = csr_matrix((w, csr.col_indices, csr.row_offsets),
                   shape=(csr.num_nodes, csr.num_nodes))
    return dijkstra(a, indices=src).astype(np.float32)


def scipy_components(csr):
    """Minimum vertex id of each scipy (weak) component, per vertex."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    n = csr.num_nodes
    a = csr_matrix((np.ones(csr.num_edges, np.int8), csr.col_indices,
                    csr.row_offsets), shape=(n, n))
    k, labels = connected_components(a, directed=True, connection="weak")
    first = np.full(k, n, np.int64)
    np.minimum.at(first, labels, np.arange(n))
    return first[labels].astype(np.int32)


def long_degree_sweep(cases, card):
    """Each s20 case again at every threshold of LONG_DEGREES: equal
    to the plain version, and the kernel's median ms.  Returns the
    largest |kernel - plain| and {name: {threshold: ms}}."""
    err, table = 0.0, {}
    for name, (base, vals, ch) in cases.items():
        out = torch.empty_like(vals)
        table[name] = {}
        for t in LONG_DEGREES:
            st = value.ValueStepper(base.offsets, base.in_src,
                                    weights=base.weights, long_degree=t,
                                    **VALUE_CONFIGS[name])
            err = max(err, compare_value(
                st, vals, ch, f"s20 {name} long_degree {t}", route="dense"))
            table[name][t] = event_ms(
                lambda: st.sweep(vals, ch, out=out, route="dense"),
                lambda: None, 20)
        print(f"  {name} kernel us by long-list threshold: " + ", ".join(
            f"{t}: {ms * 1e3:.1f}" for t, ms in table[name].items())
            + f" [{card}]", flush=True)
    return err, table


def dense_kw(stepper):
    """{"route": "dense"} where the stepper's sweep takes a route (an
    earlier checkout's does not: its one route is the dense pull)."""
    if "route" in inspect.signature(stepper.sweep).parameters:
        return {"route": "dense"}
    return {}


def share_label(share):
    return "1 vertex" if share is None else f"{100 * share:g}%"


def route_phase(g, card):
    """Phase 6, routes: each gated configuration at rmat-s20 with one
    active vertex (the top out-degree, as SSSP's first round) and
    ACTIVE_SHARES of the vertices active, through each route it may
    take, forced: equal to the route's plain version (bitwise for min;
    allclose and two calls bitwise equal for add) and bitwise equal to
    the dense kernel's result; each timed beside its route's bound and
    the sweep's (the least of its routes').  Returns (largest |kernel -
    plain|, {configuration and share: row})."""
    dev = g.device
    rng = np.random.default_rng(SEED + 6)
    out_off = g.reverse()[0]
    hub = int(torch.argmax(out_off[1:] - out_off[:-1]))
    err, table = 0.0, {}
    for name in ROUTED:
        st, vals, _ = value_case(g, name, rng)
        out = torch.empty_like(vals)
        for share in (None, *ACTIVE_SHARES):
            mask = np.zeros(g.n, bool)
            if share is None:
                mask[hub] = True
            else:
                mask = rng.random(g.n) < share
            ch = torch.from_numpy(words_from_mask(mask, g.n_words)).to(dev)
            label = f"s20 {name} {share_label(share)} active"
            count, edges = st.stats(ch)
            work = route_work(st, vals, ch)
            row = dict(active=count, edges=edges, rule=st.choose_route(edges),
                       bound_ms=min(bound_ms(*w) for w in work.values()),
                       ms={}, route_bound_ms={})
            dense = st.sweep(vals, ch, route="dense")
            for r in routes_of(st):
                err = max(err, compare_value(st, vals, ch, f"{label}, {r}",
                                             route=r))
                got = st.sweep(vals, ch, route=r)
                if not all(torch.equal(a, b) for a, b in zip(got, dense)):
                    raise AssertionError(f"{label}: the {r} kernel's bits "
                                         "differ from the dense kernel's")
                row["ms"][r] = event_ms(
                    lambda: st.sweep(vals, ch, out=out, route=r),
                    lambda: None, 20)
                row["route_bound_ms"][r] = bound_ms(*work[r])
            table[f"{name} {share_label(share)}"] = row
            best = min(row["ms"], key=row["ms"].get)
            print(f"  {label}: {count} sources, {edges} out-edges "
                  f"({100 * edges / st.m:.4f}% of m); "
                  + ", ".join(f"{r} {ms * 1e3:.1f} us (bound "
                              f"{row['route_bound_ms'][r] * 1e3:.2f})"
                              for r, ms in row["ms"].items())
                  + f"; fastest {best}, the rule takes {row['rule']}; "
                  f"sweep bound {row['bound_ms'] * 1e3:.2f} us [{card}]",
                  flush=True)
    return err, table


@contextlib.contextmanager
def recording(stepper, log):
    """While the block runs, every sweep that `stepper` launches appends
    (its values, its ch, the route it took) to `log`; reading the route
    is a host sync, so a recorded call is not a timed one."""
    inner = stepper._launch

    def rec(vals, ch, *args):
        kept = (vals.clone(), None if ch is None else ch.clone())
        res = inner(vals, ch, *args)
        log.append((*kept, stepper.last_route()))
        return res

    stepper._launch = rec
    try:
        yield log
    finally:
        del stepper._launch


def replay_routes(stepper, log, label, card):
    """Each recorded sweep again through every route the stepper may
    take, forced, and with the route left to the sweep (decided on the
    card, a stats kernel first): every route's bits equal the dense
    kernel's; per round the median ms of each (CUDA events, 10 calls).
    Returns {"rounds": [...], totals of the route taken, the dense route
    and the best route per round}."""
    rows = []
    out = torch.empty_like(log[0][0])
    for i, (vals, ch, taken) in enumerate(log):
        dense = stepper.sweep(vals, ch, route="dense")
        ms = {}
        for r in (*routes_of(stepper), None):
            got = stepper.sweep(vals, ch, route=r)
            if not all(torch.equal(a, b) for a, b in zip(got, dense)):
                raise AssertionError(f"{label} round {i}: route {r} "
                                     "differs from the dense route")
            ms[r or "auto"] = event_ms(
                lambda: stepper.sweep(vals, ch, out=out, route=r),
                lambda: None, 10)
        count, edges = stepper.stats(ch)
        rows.append(dict(active=count, edges=edges, taken=taken, ms=ms))
        print(f"  {label} round {i + 1}: {count} active, {edges} out-edges "
              f"({100 * edges / stepper.m:.4f}% of m), took {taken}: "
              + ", ".join(f"{r} {t * 1e3:.1f} us" for r, t in ms.items())
              + f" [{card}]", flush=True)
    totals = dict(
        taken_ms=sum(r["ms"][r["taken"]] for r in rows),
        dense_ms=sum(r["ms"]["dense"] for r in rows),
        best_ms=sum(min(t for k, t in r["ms"].items() if k != "auto")
                    for r in rows))
    print(f"  {label}: {len(rows)} sweeps, the routes taken "
          f"{totals['taken_ms']:.4f} ms, dense only {totals['dense_ms']:.4f}"
          f" ms, the best route per round {totals['best_ms']:.4f} ms "
          f"[{card}]", flush=True)
    return dict(rounds=rows, **totals)


class RouteWindow:
    """The value kernel's launches of one entry-point call, in all and
    per route (the card's tally): zeroed when entered, read when left,
    into launches[path] and routes[path]; every launch has one route."""

    def __init__(self, path, launches, routes):
        self.path, self.launches, self.routes = path, launches, routes

    def __enter__(self):
        zero_launches("value_step")
        value.reset_route_launches()
        return self

    def __exit__(self, *exc):
        if exc[0] is not None:
            return False
        n = launches_of("value_step")
        self.launches[self.path] = n
        by_route = value.route_launches()
        self.routes[self.path] = by_route
        if sum(by_route.values()) != n:
            raise AssertionError(f"{self.path}: {n} sweeps launched, the "
                                 f"card tallied {by_route}")
        return False


def value_phase(csrs, dev, card):
    """Phase 6: returns (largest |kernel - plain|, s20 timing rows,
    the s20 threshold sweep)."""
    t0 = phase("6 value kernel vs plain version")
    value_err, value_rows, cases = 0.0, [], {}
    for scale in (14, 20):
        g = search_graph(csrs[scale], dev)
        rng = np.random.default_rng(SEED + scale)
        for name in VALUE_CONFIGS:
            stepper, vals, ch = value_case(g, name, rng)
            value_err = max(value_err, compare_value(
                stepper, vals, ch, f"s{scale} {name}"))
            if scale == 20:
                value_rows.append(time_value(stepper, vals, ch, name,
                                             card))
                cases[name] = (stepper, vals, ch)
    rng = np.random.default_rng(SEED)
    for gname, (col_offsets, in_src, n) in edge_graphs().items():
        offsets, src = on_device(col_offsets, in_src, dev)
        for name in VALUE_CONFIGS:
            stepper, vals, ch = value_inputs(offsets, src, n, name, rng)
            value_err = max(value_err, compare_value(
                stepper, vals, ch, f"{gname} {name}"))
    err, sweep = long_degree_sweep(cases, card)
    r_err, routes = route_phase(search_graph(csrs[20], dev), card)
    print(f"  [{card}]", flush=True)
    done(t0)
    return max(value_err, err, r_err), value_rows, sweep, routes


def replay_path(steppers, call, label, card):
    """One more call of an entry point (`call()`), outside its count
    window, with every sweep of `steppers` ({name: stepper}) recorded,
    then each recorded sweep replayed through every route
    (`replay_routes`).  Returns {name: replay totals}."""
    logs = {k: [] for k in steppers}
    with contextlib.ExitStack() as stack:
        for k, st in steppers.items():
            stack.enter_context(recording(st, logs[k]))
        call()
    return {k: replay_routes(steppers[k], logs[k], f"{label} {k}", card)
            for k in steppers if logs[k]}


def sssp_phase(csr20, csr14, dev, card, counts, routes, replays):
    """Phase 7: SSSP at rmat-s20, unweighted and weighted, against
    scipy; preds at rmat-s14 against the oracle.  Puts the value
    kernel's launches of each s20 sssp.run into `counts`, by route into
    `routes`, and each run's rounds replayed through every route into
    `replays`.  Returns {graph kind: (graph, planes distances, scipy's)}
    for phase 20."""
    t0 = phase("7 sssp.run planes, rmat-s20")
    src = sources(csr20)[0]
    m = csr20.num_edges
    with RouteWindow("sssp", counts, routes):
        res = sssp.run(csr20, src, mode="planes", mark_preds=False)
    want = scipy_dist(csr20, src)
    planes = {"unweighted": (csr20, res.dist, want)}
    if not np.array_equal(res.dist, want):
        raise AssertionError("sssp distances differ from scipy's Dijkstra")
    ms = res.stats.elapsed_ms
    fn = sssp.get_sssp_planes(csr20, dev)
    vals, ch = fn.start(src)
    want = fn.g.to_internal(torch.from_numpy(res.dist).to(dev)).view(
        torch.int32)
    want[csr20.num_nodes:] = vals[csr20.num_nodes:]
    busy = replay_rounds_ms(fn.stepper, vals, ch, res.stats.search_depth,
                            want)
    print(f"  unweighted: exact vs scipy; {res.stats.search_depth} rounds, "
          f"{ms:.3f} ms, {m / (ms * 1e6):.4f} G edges/s; launches by "
          f"route {routes['sssp']}; replay, no host sync (routes decided "
          f"on the card): sweeps {busy:.4f} ms, card idle "
          f"{100 * (1 - busy / ms):.2f}% of the call [{card}]", flush=True)
    replays["sssp"] = replay_path({"min": fn.stepper}, lambda: fn(src),
                                  "sssp", card)
    weights = np.random.default_rng(SEED).integers(1, 64, m).astype(
        np.float32)
    wcsr = CsrGraph.from_arrays(csr20.row_offsets, csr20.col_indices,
                                weights)
    with RouteWindow("sssp weighted", counts, routes):
        res = sssp.run(wcsr, src, mode="planes", mark_preds=False)
    want = scipy_dist(wcsr, src)
    planes["weights 1..63"] = (wcsr, res.dist, want)
    if not np.array_equal(res.dist, want):
        raise AssertionError("weighted sssp distances differ from scipy's "
                             "Dijkstra")
    ms = res.stats.elapsed_ms
    print(f"  weights 1..63: exact vs scipy; {res.stats.search_depth} "
          f"rounds, {ms:.3f} ms, {m / (ms * 1e6):.4f} G edges/s; launches "
          f"by route {routes['sssp weighted']} [{card}]", flush=True)
    wfn = sssp.get_sssp_planes(wcsr, dev)
    replays["sssp weighted"] = replay_path(
        {"min": wfn.stepper}, lambda: wfn(src), "sssp weighted", card)
    src14 = sources(csr14)[0]
    res = sssp.run(csr14, src14, mode="planes", mark_preds=True)
    ref_dist, ref_preds = sssp_reference(csr14, src14)
    if not (np.array_equal(res.dist, ref_dist)
            and np.array_equal(res.preds, ref_preds)):
        raise AssertionError("rmat-s14 sssp distances or preds differ from "
                             "the oracle")
    print("  rmat-s14 with preds: distances and preds equal the oracle",
          flush=True)
    done(t0)
    return planes


def old_preds_chain(g, vals, achieves):
    """The preds as `SearchGraph.min_preds` made them before the kernel
    (the library call's yardstick): an int32 destination per CSC edge,
    the per-edge test `achieves(u, v)`, `index_reduce_` "amin" over the
    search-id map of input ids, then the map back to input ids."""
    st = g.stepper
    u = st.in_src
    v = torch.repeat_interleave(st.offsets[1:] - st.offsets[:-1],
                                output_size=u.shape[0])
    ids = g.to_internal(torch.arange(g.n, dtype=torch.int32,
                                     device=g.device), INF32)
    preds = torch.full((g.n_words * 32,), INF32, dtype=torch.int32,
                       device=g.device)
    preds.index_reduce_(0, v, torch.where(achieves(vals, u, v), ids[u],
                                          INF32), "amin")
    return g.to_input(torch.where(preds == INF32, -1, preds))


def preds_work(st, vals, weights):
    """Bytes the pass must move: the in-lists of the vertices that can
    have a parent (and their weights), offsets, values, ids, out."""
    n = st.n
    x = vals[:n]
    if x.dtype == torch.int32:
        live = (x != INF32) & (x != 0)
    else:
        live = torch.isfinite(x)
    deg = (st.offsets[1:] - st.offsets[:-1]).long()
    edges = int(deg[live].sum())
    per_edge = 8 if weights is not None else 4
    return per_edge * edges + 4 * (n + 1) + 12 * n, edges


def decode_work(n_words, n_bits):
    """Bytes the decode must move: the planes it reads and the visited
    words (4 B a word each), and the labels it writes (4 B a vertex)."""
    return 4 * n_words * (n_bits + 1) + 4 * 32 * n_words


def decode_row(g, planes, vw, depth, psrc, want, label, card):
    """The decode kernel (`preds_op.plane_labels`) of one search's label
    planes and visited words against its plain version, bit for bit,
    and both against `want` (the oracle's labels in search ids); timed
    (CUDA events, median) beside its byte bound and the plain
    version."""
    from gunrockinst_tpu_torch.ops import preds as preds_op
    n_planes = planes.shape[0] // g.rows
    n_bits = min(max(depth, 1).bit_length(), n_planes)
    call = lambda: preds_op.plane_labels(planes, vw, g.n, depth, psrc)
    got = call()
    plain = preds_op.plane_labels_reference(planes, vw, g.n, n_bits, psrc)
    torch.cuda.synchronize()
    if not (torch.equal(got, plain) and torch.equal(got, want)):
        raise AssertionError(f"{label}: the decode kernel differs from its "
                             "plain version or the oracle's labels")
    nbytes = decode_work(g.n_words, n_bits)
    row = dict(name=label, depth=depth, planes_read=n_bits,
               ms=event_ms(call, lambda: None, 21),
               plain_ms=event_ms(lambda: preds_op.plane_labels_reference(
                   planes, vw, g.n, n_bits, psrc), lambda: None, 5),
               bound_ms=bound_ms(nbytes, 0), bytes=nbytes)
    print(f"  decode, {label}: kernel = plain version = oracle, bit for "
          f"bit; depth {depth}, {n_bits} of {n_planes} planes read; kernel"
          f" {row['ms']:.4f} ms (bound {row['bound_ms']:.4f}), plain "
          f"{row['plain_ms']:.3f} [{card}]", flush=True)
    return row


def preds_fed_ms(g, st, p, feeds):
    """The preds kernel's ms (CUDA events, median of 21) on the same BFS
    labels fed each way of `feeds` ({name: a call that returns them}),
    the feed run just before each kernel call, outside its events."""
    from gunrockinst_tpu_torch.ops import preds as preds_op
    box, out = {}, {}
    for name, feed in feeds.items():
        out[name] = event_ms(
            lambda: preds_op.min_preds(st.offsets, st.in_src, box["v"], p),
            lambda: box.update(v=feed()), 21)
    return out


def preds_phase(csr20, planes, src, ref_labels, ref_preds, dev, card,
                counts):
    """Phase 7b: the min-id preds kernel against its plain version at
    rmat-s20, bit for bit, for BFS labels (phase 4's) and SSSP distances
    (phase 7's, per-edge weights 1..63 and the constant 1), timed beside
    its byte bound, the plain version and the chain it replaced
    (`library_ms`), at every chunk plan of PREDS_PLANS.  The decode
    kernel (`plane_labels`) on the planes of a step-8 and of a chain
    search from `src`, as the mega branch leaves them, against its plain
    version and the oracle (`decode_row`); the preds kernel on the same
    labels fed three ways: decoded, uploaded and scattered as the path
    did before, and decoded with L2 then written over.  Then one preds
    launch per `bfs.run`/`sssp.run` that marks preds and none for one
    that does not, into `counts`, and one decode launch per `bfs.run`
    that marks preds, none otherwise.  Returns the kernels line's rows
    of the preds kernel and of the decode."""
    from gunrockinst_tpu_torch.ops import preds as preds_op
    t0 = phase("7b min-id preds kernel vs plain version, rmat-s20")
    wcsr, wdist, _ = planes["weights 1..63"]
    g = search_graph(csr20, dev)
    wg = sssp.get_sssp_planes(wcsr, dev)
    cases = {
        "bfs": (g, g.to_internal(torch.from_numpy(ref_labels).to(dev),
                                 INF32), None, None),
        "sssp_w": (wg.g, wg.g.to_internal(torch.from_numpy(wdist).to(dev),
                                          float("inf")),
                   wg.stepper.weights, None),
        "sssp_c": (g, g.to_internal(torch.from_numpy(
            planes["unweighted"][1]).to(dev), float("inf")), None, 1.0)}
    rows, outs = [], {}
    for name, (sg, vals, w, cw) in cases.items():
        st = sg.stepper
        p = preds_op.plan(st.offsets, sg._perm)
        call = lambda: preds_op.min_preds(st.offsets, st.in_src, vals, p, w,
                                          cw)
        got = call()
        want = preds_op.min_preds_reference(st.offsets, st.in_src, vals,
                                            p.input_id, w, cw)
        old = old_preds_chain(sg, vals, lambda x, u, v: preds_op.achieves(
            x, u, v, w, cw))
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, old)):
            raise AssertionError(f"{name}: the preds kernel differs from "
                                 "its plain version or the old chain")
        outs[name] = got.cpu().numpy()
        outs[name][src] = -1
        if name == "bfs" and not np.array_equal(outs[name], ref_preds):
            raise AssertionError("bfs: the preds kernel differs from the "
                                 "oracle")
        nbytes, edges = preds_work(st, vals, w)
        by_plan = {}
        for long_degree, chunk in PREDS_PLANS:
            q = preds_op.plan(st.offsets, sg._perm, long_degree, chunk)
            by_plan[f"{long_degree}/{chunk}"] = event_ms(
                lambda: preds_op.min_preds(st.offsets, st.in_src, vals, q, w,
                                           cw), lambda: None, 21)
        row = dict(name=name, ms=event_ms(call, lambda: None, 21),
                   plain_ms=event_ms(lambda: preds_op.min_preds_reference(
                       st.offsets, st.in_src, vals, p.input_id, w, cw),
                       lambda: None, 5),
                   library_ms=event_ms(lambda: old_preds_chain(
                       sg, vals, lambda x, u, v: preds_op.achieves(
                           x, u, v, w, cw)), lambda: None, 5),
                   bound_ms=bound_ms(nbytes, 0), bytes=nbytes,
                   edges_read=edges, parents=int((got >= 0).sum()),
                   ms_by_plan=by_plan)
        rows.append(row)
        print(f"  {name}: kernel = plain version = old chain, bit for bit; "
              f"{row['parents']} parents, {edges} of {st.in_src.numel()} "
              f"in-edges read; kernel {row['ms']:.4f} ms (bound "
              f"{row['bound_ms']:.4f}), plain {row['plain_ms']:.3f}, old "
              f"chain {row['library_ms']:.3f}; by long_degree/chunk "
              f"{ {k: round(v, 4) for k, v in by_plan.items()} } [{card}]",
              flush=True)
    psrc = g.internal(src)
    searches = {"step8": g.search(psrc, g.reach(psrc), 8, 255)[:3]}
    chain_planes, chain_vw, chain_depth = chain.ChainBfs(
        g, max((g.n + 1).bit_length(), 1))(psrc)
    searches["chain"] = (chain_planes, chain_vw, int(chain_depth.item()))
    decode_rows = [decode_row(g, *searches[route], psrc, cases["bfs"][1],
                              f"rmat-s20 {route}", card)
                   for route in ("step8", "chain")]
    step_planes, step_vw, step_depth = searches["step8"]
    decoded = lambda: preds_op.plane_labels(step_planes, step_vw, g.n,
                                            step_depth, psrc)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    fed = preds_fed_ms(g, g.stepper, preds_op.plan(g.stepper.offsets,
                                                   g._perm), {
        "decoded": decoded,
        "uploaded": lambda: g.to_internal(upload(ref_labels, dev), INF32),
        "decoded, L2 written over": lambda: (decoded(), flush.fill_(1))[0]})
    del flush
    print(f"  preds kernel on phase 4's labels by how they were fed: "
          f"{ {k: round(v, 4) for k, v in fed.items()} } ms [{card}]",
          flush=True)
    paths = {
        "bfs.run auto": lambda mark: bfs.run(csr20, src,
                                             traversal_mode="auto",
                                             mark_preds=mark).preds,
        "sssp.run planes": lambda mark: sssp.run(wcsr, src, mode="planes",
                                                 mark_preds=mark).preds}
    decodes = {}
    for path, run in paths.items():
        zero_launches("min_preds", "plane_labels")
        run(False)
        if launches_of("min_preds") != 0 or launches_of("plane_labels"):
            raise AssertionError(f"{path} without preds launched the preds "
                                 "kernel or the decode")
        got = run(True)
        counts[path] = launches_of("min_preds")
        decodes[path] = launches_of("plane_labels")
        if counts[path] != 1:
            raise AssertionError(f"{path}: {counts[path]} preds launches, "
                                 "not 1")
        if decodes[path] != int(path == "bfs.run auto"):
            raise AssertionError(f"{path}: {decodes[path]} decode "
                                 "launches")
        want = ref_preds if path == "bfs.run auto" else outs["sssp_w"]
        if not np.array_equal(got, want):
            raise AssertionError(f"{path}: preds differ from the kernel's "
                                 "above")
    print(f"  launch.min_preds per call with preds {counts}, 0 without; "
          f"launch.plane_labels {decodes}, 0 without [{card}]", flush=True)
    done(t0)
    bfs_row = rows[0]
    step_row = decode_rows[0]
    return dict(
        name="min_preds", **KERNELS["min_preds"],
        launches=sum(counts.values()), max_abs_err=0, ms=bfs_row["ms"],
        plain_ms=bfs_row["plain_ms"], bound_ms=bfs_row["bound_ms"],
        bound_by="bytes", library_ms=bfs_row["library_ms"],
        matches_plain=True,
        work="the preds of phase 4's rmat-s20 BFS; configs lists SSSP's "
             "too",
        configs=rows, launches_by_path=counts, ms_by_feed=fed), dict(
        name="plane_labels", **KERNELS["plane_labels"],
        launches=sum(decodes.values()), max_abs_err=0, ms=step_row["ms"],
        plain_ms=step_row["plain_ms"], bound_ms=step_row["bound_ms"],
        bound_by="bytes", library_ms=None, matches_plain=True,
        work="the labels of a rmat-s20 step-8 search from phase 4's "
             "source; configs lists its chain search's and phase 11's",
        configs=decode_rows,
        launches_by_path={k: v for k, v in decodes.items() if v})


def cc_phase(csr20, dev, card, counts, routes, replays):
    """Phase 8: CC at rmat-s20 against scipy; its rounds replayed
    through every route."""
    t0 = phase("8 cc.run planes, rmat-s20")
    with RouteWindow("cc", counts, routes):
        res = cc.run(csr20, mode="planes")
    if not np.array_equal(res.component_ids, scipy_components(csr20)):
        raise AssertionError("cc component ids differ from scipy's")
    ms = res.stats.elapsed_ms
    print(f"  exact vs scipy; {res.num_components} components, "
          f"{res.stats.search_depth} rounds, {ms:.3f} ms, "
          f"{csr20.num_edges / (ms * 1e6):.4f} G edges/s; launches by "
          f"route {routes['cc']} [{card}]", flush=True)
    fn = cc.get_cc_planes(csr20, dev)
    replays["cc"] = replay_path({"min": fn.stepper}, fn, "cc", card)
    done(t0)


def pr_phase(csr20, card, counts, routes):
    """Phase 9: PR at rmat-s20, twice, against the NumPy oracle.
    Returns (the ranks, the oracle's)."""
    t0 = phase(f"9 pr.run planes max_iter={PR_ITERS}, rmat-s20")
    with RouteWindow("pr", counts, routes):
        res = pr.run(csr20, max_iter=PR_ITERS, mode="planes")
        again = pr.run(csr20, max_iter=PR_ITERS, mode="planes")
    if not np.array_equal(res.ranks.view(np.int32),
                          again.ranks.view(np.int32)):
        raise AssertionError("two pr.run calls give different ranks")
    ref = pagerank_reference(csr20, 0.85, 0.01, max_iter=PR_ITERS)
    if not np.allclose(res.ranks, ref, rtol=1e-4, atol=1e-6):
        raise AssertionError("pr ranks differ from the oracle beyond rtol "
                             "1e-4, atol 1e-6")
    it, m = res.stats.search_depth, csr20.num_edges
    for r in (res, again):
        ms = r.stats.elapsed_ms
        print(f"  {it} iterations, {ms:.3f} ms, "
              f"{m * it / (ms * 1e6):.4f} G edge-updates/s [{card}]",
              flush=True)
    print(f"  allclose to the oracle (max |diff| "
          f"{float(np.abs(res.ranks - ref).max()):.3g}); two calls "
          f"bitwise equal; launches by route {routes['pr']}", flush=True)
    done(t0)
    return res.ranks, ref


def lattice(side):
    t0 = time.perf_counter()
    csr = grid_graph(side)
    print(f"  grid-{side}^2: {csr.num_nodes} vertices, {csr.num_edges} "
          f"directed edges ({time.perf_counter() - t0:.1f} s)", flush=True)
    return csr


def compare_chain(g, psrc, label, map_cap=None, widths=None):
    """One chain-kernel search from psrc against the plain version on
    the same graph; raises on a difference.  `map_cap` and `widths` go
    to ChainBfs (map_cap 0: the visited map in global memory; widths [1]:
    one block, where the map fits).  Returns (the ChainBfs, its outputs,
    the largest |kernel - plain|)."""
    ch = chain.ChainBfs(g, max((g.n + 1).bit_length(), 1), map_cap=map_cap,
                        widths=widths)
    t0 = time.perf_counter()
    got = ch(psrc)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    st = g.stepper
    want = chain.chain_reference(st.offsets, st.in_src, psrc, ch.planes,
                                 g.rows, st.edge_dst())
    max_err = 0
    for name, a, b in zip(("planes", "vw", "depth"), got, want):
        err = int((a.long() - b.long()).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: chain kernel {name} differs "
                                 f"from the plain version (max |diff| "
                                 f"{err})")
    print(f"  {label}: depth {int(got[2])}, {ch.planes} planes, equal to "
          f"the plain version (tolerance: bitwise; {chain_layout(ch)}; "
          f"first call {t_kernel:.3f} s)", flush=True)
    return ch, got, max_err


def chain_layout(ch):
    """The cluster, visited-map placement and shared frontier list room
    of ch's last launch."""
    where = ("visited map in its shared memory" if ch.cluster == 1
             else "visited map in global memory")
    return (f"cluster of {ch.cluster} blocks, {where}, {ch.q} entries of "
            "each frontier list in shared memory")


def chain_work(g, vw, n_planes):
    """(bytes, operations) a whole search needs: each visited vertex's
    offset and out-edge ids read once, the planes, visited words and
    depth written once; three operations per out-edge read."""
    visited = mask_from_words(vw.cpu().numpy(), g.n)
    edges = int(np.diff(g.csr_p.row_offsets)[visited].sum())
    nbytes = 4 * (int(visited.sum()) + edges
                  + (n_planes + 1) * g.n_words + 1)
    return nbytes, 3 * edges


def wall_ms(run, reps):
    """Median host-clock ms of run() ended by a device sync (for routes
    whose host loop syncs every level)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def chain_phase(csr14, dev, card):
    """Phase 10: the chain kernel against its plain version on paths,
    grids, rmat-s14 undirected and directed, each visited-map placement;
    then timed at grid-1024^2 beside the step_full baseline and the old
    route.  Returns (largest |kernel - plain|, the timing row, the
    grid-1024^2 graph)."""
    t0 = phase("10 chain kernel vs plain version")
    max_err = 0
    cases = []
    for n in (CHAIN_PATH, CHAIN_DEEP):
        g = search_graph(path_graph(n), dev)
        cases.append((g, g.internal(0), f"path-{n} src 0"))
    for side in (64, 256):
        csr = lattice(side)
        g = search_graph(csr, dev)
        src = int(np.argmax(csr.degrees))
        cases.append((g, g.internal(src), f"grid-{side}^2 src {src}"))
    for kind, csr in (("", csr14), (" directed", graph(14, False))):
        g = search_graph(csr, dev)
        for which, src in zip(("top-degree", "random"), sources(csr)):
            cases.append((g, g.internal(src), f"s14{kind} {which} src {src}"))
    for g, psrc, label in cases:
        for kw in (dict(widths=[1]), dict(map_cap=0)):
            max_err = max(max_err, compare_chain(
                g, psrc, label + ", " + ", ".join(
                    f"{k} {v}" for k, v in kw.items()), **kw)[2])
    side = 1024
    csr = lattice(side)
    t1 = time.perf_counter()
    g = search_graph(csr, dev)
    src = int(np.argmax(csr.degrees))
    psrc = g.internal(src)
    reach = g.reach(psrc)
    print(f"  grid-{side}^2 search graph (relabel, CSC, reach) "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    widths = []    # the route's measure: the 8-plane loop's level widths
    g.search(psrc, reach, 8, 255, widths=widths)
    glob, _, err = compare_chain(g, psrc, f"grid-{side}^2 src {src}, "
                                          "map_cap 0", map_cap=0)
    max_err = max(max_err, err)
    ch, (planes, vw, depth), err = compare_chain(
        g, psrc, f"grid-{side}^2 src {src}, the widths of its first "
                 f"{len(widths)} levels (widest {max(widths)}; as the route "
                 "passes them)", widths=widths)
    max_err = max(max_err, err)
    depth = int(depth)
    st = g.stepper
    k_ms = event_ms(lambda: ch(psrc), lambda: None, 10)
    g_ms = event_ms(lambda: glob(psrc), lambda: None, 10)
    p_ms = event_ms(lambda: chain.chain_reference(
        st.offsets, st.in_src, psrc, ch.planes, g.rows, st.edge_dst()),
        lambda: None, 1)
    full = ch.planes
    step_full_ms = wall_ms(lambda: g.search(psrc, reach, full,
                                            min(g.n, (1 << full) - 1)), 3)
    old_ms = wall_ms(lambda: (g.search(psrc, reach, 8, 255),
                              g.search(psrc, reach, full,
                                       min(g.n, (1 << full) - 1))), 3)
    nbytes, ops = chain_work(g, vw, full)
    row = dict(ms=k_ms, plain_ms=p_ms, bytes=nbytes, ops=ops,
               bound_ms=bound_ms(nbytes, ops), depth=depth,
               step_full_ms=step_full_ms, old_route_ms=old_ms,
               global_map_ms=g_ms, layout=chain_layout(ch))
    print(f"  grid-{side}^2 from {src}: {depth} levels; chain kernel "
          f"{k_ms:.4f} ms ({k_ms * 1e3 / depth:.3f} us per level; "
          f"{row['layout']}; earlier design {EARLIER_MS['chain']} ms), "
          f"visited map in global memory {g_ms:.4f} ms, plain version "
          f"{p_ms:.1f} ms; step_full (full planes, host loop) "
          f"{step_full_ms:.4f} ms; old route (8-plane pass, then "
          f"step_full) {old_ms:.4f} ms; bound {row['bound_ms'] * 1e3:.2f}"
          f" us ({nbytes} B, bytes) [{card}]", flush=True)
    done(t0)
    return max_err, row, csr


def chain_path(csr, dev, card, counts):
    """Phase 11: bfs.run auto at grid-1024^2 through route "chain",
    exact against the oracle; the chain kernel's launches of the call
    (its warm-up search's among them: the graph's first call) go into
    `counts`, then one more call must take exactly one and no
    warm-up.  Returns the decode's row (`decode_row`) of that call's
    own planes."""
    t0 = phase("11 bfs.run auto, grid-1024^2")
    src = int(np.argmax(csr.degrees))
    zero_launches("chain_bfs")
    warm = warm_ups()
    res = bfs.run(csr, src, traversal_mode="auto")
    warm = warm_ups() - warm
    counts["bfs.run auto, grid-1024^2"] = launches_of("chain_bfs")
    print(f"  route {res.stats.route}, depth {res.stats.search_depth}, "
          f"{res.stats.nodes_visited} vertices, {res.stats.elapsed_ms:.3f}"
          f" ms (timed call); chain launches {launches_of('chain_bfs')} "
          f"({warm} in warm-up searches, 1 in the timed one) [{card}]",
          flush=True)
    if res.stats.route != "chain":
        raise AssertionError(f"route {res.stats.route!r}, expected "
                             "'chain'")
    fn = bfs_pallas.get_fused_bfs(csr, device=dev)
    if not fn.went_deep:
        raise AssertionError("the deep search did not set went_deep")
    zero_launches("chain_bfs")
    warm = warm_ups()
    again = bfs.run(csr, src, traversal_mode="auto")
    if launches_of("chain_bfs") != 1 or warm_ups() != warm:
        raise AssertionError(f"{launches_of('chain_bfs')} chain launches "
                             f"and {warm_ups() - warm} warm-up searches "
                             "for one more call once went_deep is set, "
                             "expected 1 and 0")
    if not (np.array_equal(again.labels, res.labels)
            and np.array_equal(again.preds, res.preds)):
        raise AssertionError("the second grid bfs.run differs from the "
                             "first")
    t1 = time.perf_counter()
    ref_labels, ref_preds = bfs_reference(csr, src)
    print(f"  oracle {time.perf_counter() - t1:.1f} s", flush=True)
    if not np.array_equal(res.labels, ref_labels):
        raise AssertionError("grid bfs.run labels differ from the oracle")
    if not np.array_equal(res.preds, ref_preds):
        raise AssertionError("grid bfs.run preds differ from the oracle")
    g = fn.g
    planes, vw, depth, psrc, _ = fn._last
    row = decode_row(g, planes, vw, depth, psrc, g.to_internal(
        torch.from_numpy(ref_labels).to(dev), INF32), "grid-1024^2 chain",
        card)
    done(t0, "labels and preds exact; one chain launch per search")
    return row


def compare_touch(sw, fw, vw, label):
    """The touched sweep and its fused form against the plain version
    on (fw, vw); raises on a difference.  Returns the largest
    |kernel - plain|."""
    dst = sw.edge_dst()
    max_err = 0
    for name, got, want in (
            ("touched", sw(fw), pull.touch_reference(
                sw.offsets, sw.in_src, fw, None, dst)),
            ("fused", sw.sweep_fused(fw, vw), pull.touch_reference(
                sw.offsets, sw.in_src, fw, vw, dst))):
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: touch_sweep {name} differs "
                                 f"from the plain version (max |diff| "
                                 f"{err})")
    return max_err


def touch_levels(sw, src):
    """(fw, vw) at each level of the search from src, through the plain
    version: the frontier the level's sweep reads and the visited words
    before it."""
    fw = start_words(src, sw.rows, sw.device)
    vw = fw.clone()
    levels = []
    while bool(fw.any()):
        levels.append((fw, vw))
        nfw = pull.touch_reference(sw.offsets, sw.in_src, fw, vw,
                                   sw.edge_dst())
        fw, vw = nfw, vw | nfw
    return levels


def touch_work(sw, fw, vw):
    """(bytes, operations) one sweep needs: the frontier words the
    scanned in-edge ids point to, one offset per candidate vertex (every
    vertex; the unvisited ones for the fused form), the in-edge ids read
    up to the first hit, the output written whole (and vw read whole);
    three operations per in-edge read."""
    cand = torch.ones(sw.n, dtype=torch.bool, device=fw.device)
    if vw is not None:
        cand &= ~unpack_bitmap(vw, sw.n)
    edges, fw_words, cands, _ = pull_work(sw.offsets, sw.in_src,
                                          sw.edge_dst(), fw, cand)
    nbytes = 4 * (fw_words + cands + edges + sw.n_words
                  * (1 if vw is None else 2))
    return nbytes, 3 * edges


def touch_phase(csrs, dev, card):
    """Phase 12: the touched sweep, plain and fused, against its plain
    version at every level of a top-degree and a random search at
    rmat-s14 and rmat-s20; timed at s20 on the frontier of the level-2
    vertices of the top-degree search, beside its bound and a library
    SpMV.  Returns (largest |kernel - plain|, the timing row)."""
    t0 = phase("12 touched sweep vs plain version")
    max_err, row = 0, None
    for scale in (14, 20):
        csr = csrs[scale]
        sw = bfs_pallas.get_pull_sweeper(csr, dev)
        for which, src in zip(("top-degree", "random"), sources(csr)):
            levels = touch_levels(sw, src)
            for d, (fw, vw) in enumerate(levels, 1):
                max_err = max(max_err, compare_touch(
                    sw, fw, vw, f"s{scale} {which} level {d}"))
            print(f"  s{scale} {which} src {src}: {len(levels)} levels, "
                  f"plain and fused equal to the plain version "
                  f"(tolerance: bitwise)", flush=True)
            if scale == 20 and which == "top-degree":
                fw, vw = levels[2]    # the vertices at level 2
                row = time_touch(sw, fw, vw, card)
                capped = pull.PullSweeper(sw.offsets.cpu().numpy(),
                                          sw.in_src.cpu().numpy(), dev,
                                          stage_cap=TOUCH_CAP)
                for d, (fw, vw) in enumerate(levels, 1):
                    max_err = max(max_err, compare_touch(
                        capped, fw, vw, f"s20 stage_cap {TOUCH_CAP} B level "
                                        f"{d}"))
                print(f"  s20 stage_cap {TOUCH_CAP} B ({capped.staged} of "
                      f"{capped.n_words} words staged; full budget "
                      f"{sw.staged}): {len(levels)} levels equal to the "
                      f"plain version (tolerance: bitwise)", flush=True)
    rng = np.random.default_rng(SEED)
    for gname, (col_offsets, in_src, n) in edge_graphs().items():
        for cap in (None, 0):
            sw = pull.PullSweeper(col_offsets, in_src, dev, stage_cap=cap)
            far = torch.zeros(sw.n_words * 32, dtype=torch.bool,
                              device=dev)
            far[int(in_src[-1])] = True     # the last in-edge of the last list
            for what, mask in (
                    ("empty", torch.zeros_like(far)), ("one far source", far),
                    ("30%", torch.from_numpy(rng.random(far.numel()) < 0.3)
                     .to(dev))):
                mask[n:] = False
                fw = pack_bitmap(mask, sw.n_words)
                vw = fw | pack_bitmap(torch.from_numpy(
                    rng.random(far.numel()) < 0.3).to(dev), sw.n_words)
                max_err = max(max_err, compare_touch(
                    sw, fw, vw, f"{gname} stage_cap {cap} frontier {what}"))
        print(f"  {gname}: empty, one-source and 30% frontiers, staged "
              f"whole and not at all, plain and fused equal to the plain "
              f"version (tolerance: bitwise)", flush=True)
    done(t0)
    return max_err, row


def time_touch(sw, fw, vw, card):
    """Kernel ms (plain and fused), plain-version ms, library ms and
    bound of one sweep from fw."""
    k_ms = event_ms(lambda: sw(fw), lambda: None, 20)
    f_ms = event_ms(lambda: sw.sweep_fused(fw, vw), lambda: None, 20)
    dst = sw.edge_dst()
    p_ms = event_ms(lambda: pull.touch_reference(
        sw.offsets, sw.in_src, fw, None, dst), lambda: None, 5)
    # yardstick only: the in-edge hit counts by one library call, a CSR
    # SpMV of the CSC with unit values and the frontier indicator;
    # never used by the port
    with warnings.catch_warnings():    # sparse CSR is "beta"
        warnings.simplefilter("ignore")
        a = torch.sparse_csr_tensor(
            sw.offsets, sw.in_src,
            torch.ones(sw.in_src.numel(), dtype=torch.float32,
                       device=fw.device), size=(sw.n, sw.n))
    x = unpack_bitmap(fw, sw.n).to(torch.float32)
    lib = a @ x
    if not torch.equal(pack_bitmap(lib > 0, sw.n_words), sw(fw)):
        raise AssertionError("the library SpMV's touched set differs from "
                             "the kernel's")
    lib_ms = event_ms(lambda: a @ x, lambda: None, 20)
    all_ms, none_ms = touch_variant_ms(sw, fw)
    nbytes, ops = touch_work(sw, fw, None)
    f_bytes, f_ops = touch_work(sw, fw, vw)
    row = dict(ms=k_ms, fused_ms=f_ms, plain_ms=p_ms, library_ms=lib_ms,
               bytes=nbytes, ops=ops, bound_ms=bound_ms(nbytes, ops),
               fused_bound_ms=bound_ms(f_bytes, f_ops),
               frontier=int(unpack_bitmap(fw, sw.n).sum()))
    print(f"  s20 sweep from the {row['frontier']} level-2 vertices: "
          f"kernel {k_ms * 1e3:.1f} us (previous design: "
          f"{EARLIER_US['touch']} us; bound "
          f"{row['bound_ms'] * 1e3:.2f} us, {nbytes} B), fused "
          f"{f_ms * 1e3:.1f} us (previous design: "
          f"{EARLIER_US['touch fused']} us; bound "
          f"{row['fused_bound_ms'] * 1e3:.2f} us), plain {p_ms * 1e3:.1f}"
          f" us, library SpMV {lib_ms * 1e3:.1f} us; every frontier bit "
          f"set {all_ms * 1e3:.1f} us, none {none_ms * 1e3:.1f} us; "
          f"{sw.staged} of {sw.n_words} frontier words staged [{card}]",
          flush=True)
    return row


def touch_variant_ms(sw, fw):
    """Kernel ms of the plain sweep with every frontier bit set (each
    candidate reads one id and one frontier word: the least walk) and
    with none set (each reads its whole in-list: every id of the CSC)."""
    ones, none = torch.full_like(fw, -1), torch.zeros_like(fw)
    return (event_ms(lambda: sw(ones), lambda: None, 20),
            event_ms(lambda: sw(none), lambda: None, 20))


def sweep_paths(csr20, src, ref_labels, ref_preds, card, counts):
    """Phase 13: the grid-stepped entry points at rmat-s20 against the
    oracle, each with the touched sweep's launches in its own window
    (into `counts`)."""
    t0 = phase("13 grid-stepped entry points, rmat-s20")
    zero_launches("touch_sweep")
    res = bfs.run(csr20, src, traversal_mode="pallas")
    counts["bfs.run pallas"] = launches_of("touch_sweep")
    if res.stats.route != "sweep":
        raise AssertionError(f"route {res.stats.route!r}, expected 'sweep'")
    if not (np.array_equal(res.labels, ref_labels)
            and np.array_equal(res.preds, ref_preds)):
        raise AssertionError("bfs.run pallas labels or preds differ from "
                             "the oracle")
    print(f"  bfs.run pallas: exact; depth {res.stats.search_depth}, "
          f"{res.stats.elapsed_ms:.3f} ms (timed call) [{card}]",
          flush=True)
    for cap in (None, 2):
        zero_launches("touch_sweep")
        labels, preds, depth = bfs_pallas.bfs_pallas(csr20, src,
                                                     max_depth=cap)
        counts[f"bfs_pallas max_depth={cap}"] = launches_of("touch_sweep")
        want = ref_labels if cap is None else np.where(
            ref_labels <= cap, ref_labels, INF32)
        want_preds = np.where(want != INF32, ref_preds, -1)
        if not (np.array_equal(labels, want)
                and np.array_equal(preds, want_preds)):
            raise AssertionError(f"bfs_pallas(max_depth={cap}) labels or "
                                 "preds differ from the oracle")
        print(f"  bfs_pallas max_depth={cap}: exact; depth {depth}",
              flush=True)
    sw = bfs_pallas.get_pull_sweeper_v2(csr20)
    fw = start_words(src, sw.rows, sw.device)
    zero_launches("touch_sweep")
    got = sw(fw)
    counts["get_pull_sweeper_v2"] = launches_of("touch_sweep")
    want = words_from_mask(ref_labels == 1, sw.n_words)
    if not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError("the v2 sweeper's touched set from the source "
                             "differs from the oracle's level 1")
    print(f"  touch_sweep launches per path: {counts}", flush=True)
    done(t0)


def spmv_work(sw):
    """(bytes, operations) one pull-SpMV needs: the CSC offsets and
    in-edge ids read whole, contrib read and the sums written once; one
    add per in-edge."""
    m = sw.in_src.numel()
    return 4 * ((sw.n + 1) + m + 2 * sw.n_pad), m


def compare_spmv(sw, label):
    """The pull-SpMV against its plain version on a seeded contrib;
    raises on a difference.  Returns (contrib, the kernel's sums, the
    largest |kernel - plain|)."""
    c = np.zeros(sw.n_pad, np.float32)
    c[: sw.n] = np.random.default_rng(SEED).random(sw.n, dtype=np.float32)
    contrib = torch.from_numpy(c).to(sw.device)
    got = sw(contrib)
    torch.cuda.synchronize()
    want = sw.reference(contrib)
    err = float((got.double() - want.double()).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"{label}: pull-SpMV sums differ from the "
                             f"plain version beyond rtol 1e-5, atol 1e-6 "
                             f"(max |diff| {err})")
    if not torch.equal(sw(contrib).view(torch.int32), got.view(torch.int32)):
        raise AssertionError(f"{label}: two pull-SpMV runs differ")
    print(f"  {label}: equal to the plain version (allclose rtol 1e-5 atol "
          f"1e-6, two runs bitwise; max |diff| {err:.3g})", flush=True)
    return contrib, got, err


def spmv_phase(graphs, dev, card):
    """Phase 14: the pull-SpMV against its plain version on both s20
    graphs and on the edge-case graphs; timed on the undirected s20 graph
    beside its bound, the plain version and a library SpMV.  Returns
    (largest |kernel - plain|, the timing row)."""
    t0 = phase("14 pull-SpMV vs plain version, rmat-s20")
    max_err, row = 0.0, None
    for kind, csr in graphs.items():
        sw = pr.get_spmv_sweeper(csr, dev)
        contrib, got, err = compare_spmv(sw, kind)
        max_err = max(max_err, err)
        if kind == "undirected":
            row = time_spmv(sw, contrib, got, card)
    for gname, (col_offsets, in_src, n) in edge_graphs().items():
        offsets, src = on_device(col_offsets, in_src, dev)
        max_err = max(max_err, compare_spmv(spmv.SpmvSweeper(offsets, src),
                                            gname)[2])
    done(t0)
    return max_err, row


def time_spmv(sw, contrib, got, card):
    """Kernel, plain and library ms of one pull-SpMV, and its bound."""
    out = torch.empty_like(contrib)
    k_ms = event_ms(lambda: sw(contrib, out=out), lambda: None, 20)
    p_ms = event_ms(lambda: sw.reference(contrib), lambda: None, 5)
    # yardstick only: the same sums by one library call, a CSR SpMV of
    # the CSC with unit values; never used by the port
    with warnings.catch_warnings():    # sparse CSR is "beta"
        warnings.simplefilter("ignore")
        a = torch.sparse_csr_tensor(
            sw.offsets, sw.in_src,
            torch.ones(sw.in_src.numel(), dtype=torch.float32,
                       device=contrib.device), size=(sw.n, sw.n))
    x = contrib[: sw.n].clone()
    err = float((a @ x - got[: sw.n]).abs().max())
    lib_ms = event_ms(lambda: a @ x, lambda: None, 20)
    nbytes, ops = spmv_work(sw)
    row = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bytes=nbytes,
               ops=ops, bound_ms=bound_ms(nbytes, ops))
    print(f"  undirected: kernel {k_ms * 1e3:.1f} us (earlier runs: "
          f"{EARLIER_US['spmv']}"
          f" us; one source {spmv_one_source_ms(sw, contrib) * 1e3:.1f} us)"
          f", plain {p_ms * 1e3:.1f} us, library SpMV "
          f"{lib_ms * 1e3:.1f} us (max |diff| to the kernel {err:.3g}), "
          f"bound {row['bound_ms'] * 1e3:.2f} us ({nbytes} B) [{card}]",
          flush=True)
    return row


def spmv_one_source_ms(sw, contrib):
    """Kernel ms of the pull-SpMV with every in-edge id replaced by 0
    (as `one_source_ms`)."""
    one = spmv.SpmvSweeper(sw.offsets, torch.zeros_like(sw.in_src))
    return event_ms(lambda: one(contrib), lambda: None, 20)


def pr_pallas_phase(csr20, planes_ranks, ref, card, counts, routes):
    """Phase 15: pr.run(mode="pallas") at rmat-s20, twice, against the
    NumPy oracle and phase 9's planes ranks; the pull-SpMV's launches of
    the two calls go into `counts`, the value kernel's by route into
    `routes`."""
    t0 = phase(f"15 pr.run pallas max_iter={PR_ITERS}, rmat-s20")
    zero_launches("spmv")
    with RouteWindow("pr pallas", {}, routes):
        res = pr.run(csr20, max_iter=PR_ITERS, mode="pallas")
        again = pr.run(csr20, max_iter=PR_ITERS, mode="pallas")
    counts["pr pallas"] = launches_of("spmv")
    if not np.array_equal(res.ranks.view(np.int32),
                          again.ranks.view(np.int32)):
        raise AssertionError("two pr.run pallas calls give different ranks")
    for what, want in (("the oracle", ref), ("the planes ranks",
                                              planes_ranks)):
        if not np.allclose(res.ranks, want, rtol=1e-4, atol=1e-6):
            raise AssertionError(f"pr pallas ranks differ from {what} "
                                 "beyond rtol 1e-4, atol 1e-6")
    it, m = res.stats.search_depth, csr20.num_edges
    for r in (res, again):
        ms = r.stats.elapsed_ms
        print(f"  {it} iterations, {ms:.3f} ms, "
              f"{m * it / (ms * 1e6):.4f} G edge-updates/s [{card}]",
              flush=True)
    done(t0, f"allclose to the oracle and the planes ranks; two calls "
             f"bitwise equal; {counts['pr pallas']} SpMV launches, by "
             "route "
             f"{routes['pr pallas']}")


def close(what, got, want, rtol, atol=1e-6):
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        err = float(np.abs(got.astype(np.float64) - want).max())
        raise AssertionError(f"{what} differ from the oracle beyond rtol "
                             f"{rtol}, atol {atol} (max |diff| {err:.3g})")


def hits_salsa_phase(graphs, card, counts, routes):
    """Phase 16: HITS and SALSA planes on both s20 graphs against the
    NumPy oracles, each call with the value kernel's launches in its
    own window (into `counts`).  Returns {kind: (hits oracle, salsa
    oracle)} for phase 22."""
    refs = {}
    t0 = phase(f"16 hits.run and salsa.run planes max_iter={RANK_ITERS}, "
               f"rmat-s20")
    for kind, csr in graphs.items():
        src = sources(csr)[0]
        with RouteWindow(f"hits {kind}", counts, routes):
            res = hits.run(csr, src=src, max_iter=RANK_ITERS, mode="planes")
        hub, auth = hits_reference(csr, src, max_iter=RANK_ITERS)
        close(f"{kind} hits hub ranks", res.hub_ranks, hub, 1e-4)
        close(f"{kind} hits auth ranks", res.auth_ranks, auth, 1e-4)
        print(f"  {kind} hits from {src}: allclose; "
              f"{res.stats.elapsed_ms:.3f} ms; launches by route "
              f"{routes[f'hits {kind}']} [{card}]", flush=True)
        with RouteWindow(f"salsa {kind}", counts, routes):
            res = salsa.run(csr, max_iter=RANK_ITERS, mode="planes")
        salsa_ref = salsa_reference(csr, max_iter=RANK_ITERS)
        refs[kind] = ((hub, auth), salsa_ref)
        hub, auth = salsa_ref
        close(f"{kind} salsa hub ranks", res.hub_ranks, hub, 1e-4)
        close(f"{kind} salsa auth ranks", res.auth_ranks, auth, 1e-4)
        print(f"  {kind} salsa: allclose; {res.stats.elapsed_ms:.3f} ms; "
              f"launches by route {routes[f'salsa {kind}']} [{card}]",
              flush=True)
    done(t0)
    return refs


def wtf_phase(graphs, card, counts, routes):
    """Phase 17: WTF planes on both s20 graphs, checked as the JAX
    package's tests check it: PPR allclose, the circle of trust
    score-equivalent per position, the ranks allclose to the oracle
    pinned to the port's circle.  Returns {kind: (the port's circle,
    the pinned oracle ranks, the oracle's PPR)} for phase 22."""
    refs = {}
    t0 = phase(f"17 wtf.run planes cot_size={COT_SIZE}, rmat-s20")
    for kind, csr in graphs.items():
        src = sources(csr)[0]
        with RouteWindow(f"wtf {kind}", counts, routes):
            res = wtf.run(csr, src=src, cot_size=COT_SIZE, mode="planes")
        pinned, _, ppr = wtf_reference(csr, src, cot_size=COT_SIZE,
                                       cot=res.cot)
        refs[kind] = (res.cot, pinned, ppr)
        cot = np.lexsort((np.arange(csr.num_nodes), -ppr))[:COT_SIZE]
        close(f"{kind} wtf ppr ranks", res.ppr_ranks, ppr, 1e-3)
        close(f"{kind} wtf circle-of-trust scores", ppr[res.cot], ppr[cot],
              1e-3)
        close(f"{kind} wtf ranks", res.wtf_ranks, pinned, 1e-3)
        phases = ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                           else f"{k} {v}" for k, v in res.phases.items())
        print(f"  {kind} wtf from {src}: allclose; "
              f"{res.stats.elapsed_ms:.3f} ms ({phases}); launches by route "
              f"{routes[f'wtf {kind}']} [{card}]", flush=True)
    done(t0)
    return refs


def bc_phase(graphs, dev, card, counts, routes, replays):
    """Phase 18: single-source BC planes on both s20 graphs, twice,
    against bc_reference_fast; the levels of one more call replayed
    through every route.  Returns {kind: the oracle's (values, sigma,
    labels)} for phase 23."""
    refs = {}
    t0 = phase("18 bc.run planes, rmat-s20")
    for kind, csr in graphs.items():
        src = sources(csr)[0]
        with RouteWindow(f"bc {kind}", counts, routes):
            res = bc.run(csr, src=src, mode="planes")
            again = bc.run(csr, src=src, mode="planes")
        for what, a, b in (("values", res.bc_values, again.bc_values),
                           ("sigmas", res.sigmas, again.sigmas),
                           ("labels", res.labels, again.labels)):
            if not np.array_equal(a.view(np.int32), b.view(np.int32)):
                raise AssertionError(f"{kind}: two bc.run calls give "
                                     f"different {what}")
        want_bc, want_sigma, want_labels = refs[kind] = \
            bc_reference_fast(csr, src)
        if not np.array_equal(np.where(res.labels == INF32, -1,
                                       res.labels), want_labels):
            raise AssertionError(f"{kind}: bc labels differ from the "
                                 "oracle's")
        close(f"{kind} bc values", res.bc_values, want_bc, 1e-4)
        exact = want_sigma < 2**24
        if not np.array_equal(res.sigmas[exact], want_sigma[exact]):
            raise AssertionError(f"{kind}: bc sigmas below 2^24 differ "
                                 "from the oracle's")
        close(f"{kind} bc sigmas above 2^24", res.sigmas[~exact],
              want_sigma[~exact], 1e-6, 0.0)
        print(f"  {kind} bc from {src}: labels exact, values allclose, "
              f"sigmas exact below 2^24 ({int((~exact).sum())} above); "
              f"depth {res.stats.search_depth}, "
              f"{res.stats.elapsed_ms:.3f} ms, {again.stats.elapsed_ms:.3f}"
              f" ms; two calls bitwise equal; launches by route "
              f"{routes[f'bc {kind}']} [{card}]", flush=True)
        fn = bc.get_bc_planes(csr, dev)
        replays[f"bc {kind}"] = replay_path(
            {"forward": fn.fwd, "reverse": fn.rev}, lambda: fn(src),
            f"bc {kind}", card)
    done(t0)
    return refs


# ---- phases 19-23: the operator layer (the default modes) -----------------

@contextlib.contextmanager
def no_kernel_launch(what):
    """A window in which the hand-written kernels must not launch: the
    default modes run the operator layer alone."""
    zero_launches(*KERNELS)
    yield
    launched = {k: launches_of(k) for k in KERNELS if launches_of(k)}
    if launched:
        raise AssertionError(f"{what}: hand-written kernels launched "
                             f"{launched}")


def device_busy_ms(call):
    """The card's kernel time in one `call`, from torch.profiler, or
    None where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 if total > 0 else None


def idle_line(what, call):
    """"<what> x ms; card busy y ms, idle z% of the call": the host
    clock of one `call` ended by a sync, then the card's kernel time in
    one more, profiled."""
    t1 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t1) * 1e3
    busy = device_busy_ms(call)
    if busy is None:
        return (f"{what} {wall:.3f} ms; card idle not measured (no device"
                " time in the trace)")
    return (f"{what} {wall:.3f} ms; card busy {busy:.3f} ms, idle "
            f"{100 * (1 - busy / wall):.2f}% of the call")


def bfs_xla_phase(csr20, src, ref_labels, ref_preds, mega_res, card):
    """Phase 19: bfs.run dense, sparse and auto with max_depth=3 at
    rmat-s20: labels and preds equal the oracle's (cut at depth 3 for
    the last) and phase 4's."""
    t0 = phase("19 bfs.run dense, sparse, auto max_depth=3, rmat-s20")
    cut = ref_labels <= 3
    for mode, depth in (("dense", None), ("sparse", None), ("auto", 3)):
        with no_kernel_launch(f"bfs {mode}"):
            res = bfs.run(csr20, src, traversal_mode=mode, max_depth=depth)
        want_l, want_p = ref_labels, ref_preds
        if depth is not None:
            want_l = np.where(cut, ref_labels, INF32)
            want_p = np.where(cut, ref_preds, -1)
        if not (np.array_equal(res.labels, want_l)
                and np.array_equal(res.preds, want_p)):
            raise AssertionError(f"bfs {mode}: labels or preds differ from "
                                 "the oracle")
        if depth is None and not (
                np.array_equal(res.labels, mega_res.labels)
                and np.array_equal(res.preds, mega_res.preds)):
            raise AssertionError(f"bfs {mode}: labels or preds differ from "
                                 "phase 4's")
        ms = res.stats.elapsed_ms
        print(f"  {mode}{'' if depth is None else f' max_depth={depth}'}: "
              f"exact; depth {res.stats.search_depth}, total_queued "
              f"{res.stats.total_queued}, {ms:.3f} ms, "
              f"{res.stats.edges_visited / (ms * 1e6):.4f} GTEPS [{card}]",
              flush=True)
    g = device_graph(csr20, resolve_device(None))
    print(f"  {idle_line('bfs_dense search', lambda: bfs.bfs_dense(g, src))}"
          f" [{card}]", flush=True)
    done(t0)


def sssp_xla_phase(planes, csr14, card):
    """Phase 20: sssp.run sparse (the default), delta and bellman at
    rmat-s20, unweighted and with weights 1..63: distances equal
    scipy's Dijkstra bit for bit and phase 7's planes distances; preds
    at rmat-s14 equal the oracle's."""
    t0 = phase("20 sssp.run sparse, delta, bellman, rmat-s20")
    for kind, (csr, planes_dist, want) in planes.items():
        src = sources(csr)[0]
        for mode in ("sparse", "delta", "bellman"):
            with no_kernel_launch(f"sssp {mode}"):
                res = sssp.run(csr, src, mode=mode, mark_preds=False)
            if not (np.array_equal(res.dist, want)
                    and np.array_equal(res.dist, planes_dist)):
                raise AssertionError(f"sssp {mode} {kind}: distances differ"
                                     " from scipy's or phase 7's")
            ms = res.stats.elapsed_ms
            print(f"  {kind} {mode}: exact vs scipy and planes; "
                  f"{res.stats.search_depth} rounds, {ms:.3f} ms "
                  f"[{card}]", flush=True)
    src14 = sources(csr14)[0]
    ref_dist, ref_preds = sssp_reference(csr14, src14)
    for mode in ("sparse", "delta", "bellman"):
        with no_kernel_launch(f"sssp {mode} s14"):
            res = sssp.run(csr14, src14, mode=mode)
        if not (np.array_equal(res.dist, ref_dist)
                and np.array_equal(res.preds, ref_preds)):
            raise AssertionError(f"rmat-s14 sssp {mode}: distances or preds "
                                 "differ from the oracle")
    print("  rmat-s14 with preds, each mode: equal to the oracle",
          flush=True)
    csr20 = planes["unweighted"][0]
    g = device_graph(csr20, resolve_device(None))
    src = sources(csr20)[0]
    line = idle_line("sssp_kernel sparse, unweighted",
                     lambda: sssp.sssp_kernel(g, src, 1.0, mode="sparse"))
    print(f"  {line} [{card}]", flush=True)
    done(t0)


def cc_xla_phase(csr20, card):
    """Phase 21: cc.run (mode "xla") at rmat-s20 against scipy."""
    t0 = phase("21 cc.run xla, rmat-s20")
    with no_kernel_launch("cc xla"):
        res = cc.run(csr20)
    if not np.array_equal(res.component_ids, scipy_components(csr20)):
        raise AssertionError("cc xla component ids differ from scipy's")
    ms = res.stats.elapsed_ms
    print(f"  exact vs scipy; {res.num_components} components, "
          f"{res.stats.search_depth} rounds, {ms:.3f} ms [{card}]",
          flush=True)
    done(t0)


def rank_xla_phase(graphs, pr_ref, rank_refs, wtf_refs, card):
    """Phase 22: pr.run(max_iter=5) on the undirected graph, hits.run
    and salsa.run (max_iter=10) and wtf.run(cot_size=1000) on both s20
    graphs, mode "xla": each held to its oracle with phases 9 and
    15-17's tolerances (the oracles' values those phases computed); PR,
    HITS and SALSA bitwise equal on two calls."""
    t0 = phase("22 pr, hits, salsa, wtf xla, rmat-s20")

    def twice(what, call, arrays):
        with no_kernel_launch(what):
            res, again = call(), call()
        for a, b in zip(arrays(res), arrays(again)):
            if not np.array_equal(a.view(np.int32), b.view(np.int32)):
                raise AssertionError(f"{what}: two calls differ")
        return res, again

    res, again = twice("pr xla", lambda: pr.run(graphs["undirected"],
                                                max_iter=PR_ITERS),
                       lambda r: (r.ranks,))
    close("pr xla ranks", res.ranks, pr_ref, 1e-4)
    print(f"  undirected pr: allclose, two calls bitwise equal; "
          f"{res.stats.search_depth} iterations, "
          f"{res.stats.elapsed_ms:.3f} ms, {again.stats.elapsed_ms:.3f} ms "
          f"[{card}]", flush=True)
    for kind, csr in graphs.items():
        src = sources(csr)[0]
        res, again = twice(f"hits xla {kind}", lambda: hits.run(
            csr, src=src, max_iter=RANK_ITERS),
            lambda r: (r.hub_ranks, r.auth_ranks))
        (hub, auth), salsa_ref = rank_refs[kind]
        close(f"{kind} hits xla hub ranks", res.hub_ranks, hub, 1e-4)
        close(f"{kind} hits xla auth ranks", res.auth_ranks, auth, 1e-4)
        print(f"  {kind} hits from {src}: allclose, two calls bitwise "
              f"equal; {res.stats.elapsed_ms:.3f} ms [{card}]", flush=True)
        res, again = twice(f"salsa xla {kind}", lambda: salsa.run(
            csr, max_iter=RANK_ITERS), lambda r: (r.hub_ranks, r.auth_ranks))
        hub, auth = salsa_ref
        close(f"{kind} salsa xla hub ranks", res.hub_ranks, hub, 1e-4)
        close(f"{kind} salsa xla auth ranks", res.auth_ranks, auth, 1e-4)
        print(f"  {kind} salsa: allclose, two calls bitwise equal; "
              f"{res.stats.elapsed_ms:.3f} ms [{card}]", flush=True)
        with no_kernel_launch(f"wtf xla {kind}"):
            res = wtf.run(csr, src=src, cot_size=COT_SIZE)
        planes_cot, pinned, ppr = wtf_refs[kind]
        moved = int((res.cot != planes_cot).sum())
        if moved:           # the oracle pinned to this circle instead
            pinned = wtf_reference(csr, src, cot_size=COT_SIZE,
                                   cot=res.cot)[0]
        cot = np.lexsort((np.arange(csr.num_nodes), -ppr))[:COT_SIZE]
        close(f"{kind} wtf xla ppr ranks", res.ppr_ranks, ppr, 1e-3)
        close(f"{kind} wtf xla circle-of-trust scores", ppr[res.cot],
              ppr[cot], 1e-3)
        close(f"{kind} wtf xla ranks", res.wtf_ranks, pinned, 1e-3)
        phases = ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                           else f"{k} {v}" for k, v in res.phases.items())
        print(f"  {kind} wtf from {src}: allclose ({moved} circle "
              f"positions differ from phase 17's); "
              f"{res.stats.elapsed_ms:.3f} ms ({phases}) [{card}]",
              flush=True)
    done(t0)


def bc_all_dense(csr, dev):
    """All-sources Brandes BC of `csr`, halved, as bc_reference gives
    it, in float64 with every source at once on dense (n, n) matrices:
    row s of sigma counts the shortest paths from s, and each level's
    path counts and dependencies are one matrix product with the
    adjacency matrix.  Independent of the sparse code under test."""
    n = csr.num_nodes
    f64 = dict(dtype=torch.float64, device=dev)
    adj = torch.zeros((n, n), **f64)
    rows = np.repeat(np.arange(n), csr.degrees)
    adj[torch.from_numpy(rows).to(dev),
        torch.from_numpy(csr.col_indices.astype(np.int64)).to(dev)] = 1.0
    sigma = torch.eye(n, **f64)
    front = sigma > 0
    seen, levels = front.clone(), [front]
    while True:
        paths = (sigma * front) @ adj
        front = (paths > 0) & ~seen
        if not bool(front.any()):
            break
        sigma = torch.where(front, paths, sigma)
        seen |= front
        levels.append(front)
    delta = torch.zeros((n, n), **f64)
    inv = torch.where(sigma > 0, 1.0 / sigma, 0.0)
    for d in range(len(levels) - 1, 0, -1):
        child = torch.where(levels[d], (1.0 + delta) * inv, 0.0)
        delta += torch.where(levels[d - 1], sigma * (child @ adj.T), 0.0)
    delta.fill_diagonal_(0.0)
    return (delta.sum(dim=0) * 0.5).cpu().numpy().astype(np.float32)


def bc_xla_phase(graphs, bc_refs, csr14, card):
    """Phase 23: bc.run(src=top-degree) (mode "xla") on both s20 graphs,
    held as phase 18 holds it (against the oracle values phase 18
    computed), two calls bitwise equal; then bc.run at rmat-s14 with
    every source (the default) against the all-sources Brandes oracle
    (rtol 1e-4, atol 1e-6)."""
    t0 = phase("23 bc.run xla, rmat-s20 one source, rmat-s14 all sources")
    for kind, csr in graphs.items():
        src = sources(csr)[0]
        with no_kernel_launch(f"bc xla {kind}"):
            res, again = bc.run(csr, src=src), bc.run(csr, src=src)
        for what, a, b in (("values", res.bc_values, again.bc_values),
                           ("sigmas", res.sigmas, again.sigmas),
                           ("labels", res.labels, again.labels)):
            if not np.array_equal(a.view(np.int32), b.view(np.int32)):
                raise AssertionError(f"{kind}: two bc.run xla calls give "
                                     f"different {what}")
        want_bc, want_sigma, want_labels = bc_refs[kind]
        if not np.array_equal(np.where(res.labels == INF32, -1,
                                       res.labels), want_labels):
            raise AssertionError(f"{kind}: bc xla labels differ from the "
                                 "oracle's")
        close(f"{kind} bc xla values", res.bc_values, want_bc, 1e-4)
        exact = want_sigma < 2**24
        if not np.array_equal(res.sigmas[exact], want_sigma[exact]):
            raise AssertionError(f"{kind}: bc xla sigmas below 2^24 differ "
                                 "from the oracle's")
        close(f"{kind} bc xla sigmas above 2^24", res.sigmas[~exact],
              want_sigma[~exact], 1e-6, 0.0)
        print(f"  {kind} bc from {src}: labels exact, values allclose, "
              f"two calls bitwise equal; depth {res.stats.search_depth}, "
              f"{res.stats.elapsed_ms:.3f} ms, {again.stats.elapsed_ms:.3f}"
              f" ms [{card}]", flush=True)
    g = device_graph(csr14, resolve_device(None))
    k = bc.auto_batch(g)
    with no_kernel_launch("bc xla all sources"):
        res = bc.run(csr14)
    t1 = time.perf_counter()
    want = bc_all_dense(csr14, g.device)
    oracle_s = time.perf_counter() - t1
    close("rmat-s14 all-sources bc xla values", res.bc_values, want, 1e-4)
    print(f"  rmat-s14 all {csr14.num_nodes} sources, batch {k}: allclose "
          f"to the oracle (max |diff| "
          f"{float(np.abs(res.bc_values - want).max()):.3g}; oracle "
          f"{oracle_s:.1f} s); depth {res.stats.search_depth}, "
          f"{res.stats.elapsed_ms:.3f} ms [{card}]", flush=True)
    done(t0)


# ---- phases 24-29: the last primitives and the host surfaces -----------
# (their modules are imported where they run, so that `--variants DIR`
# still runs on checkouts that predate them)

def preds_memory(call):
    """(call's result, peak card bytes above the start, bytes still held
    after it) of one `call`."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    return (out, torch.cuda.max_memory_allocated() - base,
            torch.cuda.memory_allocated() - base)


def old_min_preds(g, labels_np, src, held):
    """The preds of `bfs_pallas._preds` as the port's earlier
    `SearchGraph.min_preds` made them, for the peak-memory comparison: an int64 destination per
    CSC edge, which that version cached for the graph's lifetime (put in
    `held`), an int64 copy of `in_src` and int64 labels per edge."""
    st = g.stepper
    dst = torch.repeat_interleave(
        torch.arange(st.n, device=g.device),
        (st.offsets[1:] - st.offsets[:-1]).long())
    held.append(dst)
    labels = g.to_internal(torch.from_numpy(labels_np).to(g.device), INF32)
    u, v = st.in_src.long(), dst
    lu = labels[u].long()
    ok = (lu != INF32) & (labels[v].long() == lu + 1)
    ids = g.to_internal(torch.arange(g.n, dtype=torch.int32,
                                     device=g.device), INF32)
    preds = torch.full((g.n_words * 32,), INF32, dtype=torch.int32,
                       device=g.device)
    preds.scatter_reduce_(0, v, torch.where(ok, ids[u], INF32), "amin")
    preds = torch.where(preds == INF32, -1, preds)
    out = g.to_input(preds).cpu().numpy()
    out[src] = -1
    return out


def preds_memory_line(csr20, src, labels, want, card):
    """Phase 4's preds, as they were made before and as they are now
    (the main path's own: the decode of phase 4's planes, then the
    kernel): both equal the oracle's; the card memory each took."""
    dev = resolve_device(None)
    g = search_graph(csr20, dev)
    held = []
    old, old_peak, old_held = preds_memory(
        lambda: old_min_preds(g, labels, src, held))
    held.clear()
    new, new_peak, new_held = preds_memory(
        bfs_pallas.get_fused_bfs(csr20, True, dev).preds)
    for what, p in (("the earlier preds", old), ("preds", new)):
        if not np.array_equal(p, want):
            raise AssertionError(f"{what} differ from the oracle")
    mb = 1 / 2**20
    print(f"  preds (min_preds, {csr20.num_edges} CSC edges): card peak "
          f"above the call's start {old_peak * mb:.1f} MiB, held after it "
          f"{old_held * mb:.1f} MiB as made before (an int64 "
          f"destination cached per edge) -> peak {new_peak * mb:.1f} MiB, "
          f"held {new_held * mb:.1f} MiB now; both equal the oracle "
          f"[{card}]", flush=True)


def timed_ms(call):
    """(call's result, wall ms of one call ended by a card sync)."""
    t1 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t1) * 1e3


def topk_phase(csr20, card):
    """Phase 24: topk.run(k=1000) at rmat-s20 equals the oracle."""
    from gunrockinst_tpu_torch.oracles import topk_degree_reference
    from gunrockinst_tpu_torch.primitives import topk
    t0 = phase("24 topk.run k=1000, rmat-s20")
    with no_kernel_launch("topk"):
        res, wall = timed_ms(lambda: topk.run(csr20, 1000))
    want = topk_degree_reference(csr20, 1000)
    got = (res.node_ids, res.centralities, res.in_degrees, res.out_degrees)
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("topk differs from the oracle")
    print(f"  exact vs the oracle; top centrality {res.centralities[0]}; "
          f"timed call {res.stats.elapsed_ms:.3f} ms, run {wall:.3f} ms "
          f"[{card}]", flush=True)
    done(t0)


def dobfs_phase(csr20, src, ref_labels, ref_preds, card):
    """Phase 25: dobfs.run from phase 4's source: labels and preds equal
    phase 4's oracle's."""
    from gunrockinst_tpu_torch.primitives import dobfs
    t0 = phase("25 dobfs.run, rmat-s20")
    with no_kernel_launch("dobfs"):
        res, wall = timed_ms(lambda: dobfs.run(csr20, src))
    if not (np.array_equal(res.labels, ref_labels)
            and np.array_equal(res.preds, ref_preds)):
        raise AssertionError("dobfs labels or preds differ from the oracle")
    ms = res.stats.elapsed_ms
    print(f"  exact vs the oracle; depth {res.stats.search_depth}, "
          f"pull_levels {res.pull_levels}, {ms:.3f} ms, "
          f"{res.stats.edges_visited / (ms * 1e6):.4f} GTEPS; run "
          f"{wall:.3f} ms [{card}]", flush=True)
    done(t0)


def edge_list(csr):
    src = np.repeat(np.arange(csr.num_nodes, dtype=np.int32),
                    np.diff(csr.row_offsets))
    return src, csr.col_indices


def check_mis(csr, prio, rounds, in_set):
    """One vectorized pass over the edges of an undirected graph,
    independent of the port's code: the rounds are Luby's with these
    priorities, and in_set is independent and maximal."""
    src, dst = edge_list(csr)
    n = csr.num_nodes
    if (rounds < 0).any():
        raise AssertionError("mis: a vertex was never decided")
    # a vertex beats every neighbour still undecided when it joined
    later = rounds[dst] >= rounds[src]
    if (prio[src][later] < prio[dst][later]).any():
        raise AssertionError("mis: a vertex joined beside an undecided "
                             "neighbour of higher priority")
    # ... and one round earlier some undecided neighbour beat it
    beaten = (rounds[dst] >= rounds[src] - 1) & (prio[dst] > prio[src])
    has = np.bincount(src[beaten], minlength=n) > 0
    if not has[rounds > 0].all():
        raise AssertionError("mis: a vertex joined later than it could")
    if (in_set[src] & in_set[dst]).any():
        raise AssertionError("mis: in_set is not independent")
    covered = np.bincount(src[in_set[dst]], minlength=n) > 0
    if not (in_set | covered).all():
        raise AssertionError("mis: in_set is not maximal")


def mis_phase(csr20, card):
    """Phase 26: mis.run(seed=0) at rmat-s20, checked by `check_mis`."""
    from gunrockinst_tpu_torch.primitives import mis
    t0 = phase("26 mis.run seed=0, rmat-s20")
    with no_kernel_launch("mis"):
        res, wall = timed_ms(lambda: mis.run(csr20, seed=0))
    prio = np.random.default_rng(0).permutation(csr20.num_nodes)
    check_mis(csr20, prio, res.mis_ids, res.in_set)
    print(f"  Luby rounds, independent and maximal; {res.stats.search_depth}"
          f" rounds, set of {int(res.in_set.sum())}; timed mis_kernel call "
          f"{res.stats.elapsed_ms:.3f} ms, run (warm-up and luby_kernel "
          f"included) {wall:.3f} ms [{card}]", flush=True)
    done(t0)


def mst_phase(wcsr, card):
    """Phase 27: mst.run on phase 7's weighted graph (weights 1..63):
    total weight allclose to scipy's (rtol 1e-6), a forest of n -
    components edges spanning the input's components.  Returns the
    canonical edges (u, v, w) and scipy's weight, for phase 30."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import (connected_components,
                                      minimum_spanning_tree)
    from gunrockinst_tpu_torch.primitives import mst
    t0 = phase("27 mst.run, rmat-s20 weights 1..63")
    canonical_edges, canon = mst.canonical_edges, {}

    def timed_canonical(csr):        # the host step inside mst.run
        t1 = time.perf_counter()
        out = canonical_edges(csr)
        canon["ms"], canon["m"] = (time.perf_counter() - t1) * 1e3, len(
            out[0])
        canon["edges"] = out
        return out
    mst.canonical_edges = timed_canonical
    try:
        with no_kernel_launch("mst"):
            res, wall = timed_ms(lambda: mst.run(wcsr))
    finally:
        mst.canonical_edges = canonical_edges
    n = wcsr.num_nodes
    # scipy reads each directed edge as an undirected one, so a pair's
    # lighter direction is the one a spanning tree can take
    a = csr_matrix((wcsr.edge_values.astype(np.float64), wcsr.col_indices,
                    wcsr.row_offsets), shape=(n, n))
    want = float(minimum_spanning_tree(a).sum())
    if not np.isclose(res.total_weight, want, rtol=1e-6, atol=0):
        raise AssertionError(f"mst total weight {res.total_weight} differs "
                             f"from scipy's {want}")
    k_in, lab_in = connected_components(a, directed=False)
    sel = res.edges
    forest = csr_matrix((np.ones(len(sel)), (sel[:, 0], sel[:, 1])),
                        shape=(n, n))
    k_out, lab_out = connected_components(forest, directed=False)

    def canonical(labels, k):
        first = np.full(k, n, np.int64)
        np.minimum.at(first, labels, np.arange(n))
        return first[labels]
    if len(sel) != n - k_in or not np.array_equal(
            canonical(lab_in, k_in), canonical(lab_out, k_out)):
        raise AssertionError("mst edges are not a spanning forest of the "
                             "input's components")
    print(f"  total weight {res.total_weight} (scipy {want}); "
          f"{len(sel)} edges = n - {k_in} components; "
          f"{res.stats.search_depth} rounds; timed mst_kernel call "
          f"{res.stats.elapsed_ms:.3f} ms, run {wall:.3f} ms, of it host "
          f"canonical_edges {canon['ms']:.3f} ms for {canon['m']} edges "
          f"[{card}]", flush=True)
    done(t0)
    return canon["edges"], want


def sampling_phase(csr20, card):
    """Phase 28: sample_khop from the 1024 top-degree seeds, k=10, 2
    hops, from a CUDA generator: every valid (v, nbr, eid) is an edge of
    v's CSR segment, the rest point at the dummy, one seed gives the
    same bits twice."""
    from gunrockinst_tpu_torch.ops import sampling
    t0 = phase("28 sample_khop k=10 hops=2, rmat-s20")
    dev = resolve_device(None)
    g = device_graph(csr20, dev)
    seeds = torch.from_numpy(np.argsort(-csr20.degrees, kind="stable")[
        :1024].astype(np.int32)).to(dev)

    def call():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return sampling.sample_khop(g, seeds, 10, 2, generator=gen)
    with no_kernel_launch("sampling"):
        call()                                   # warm-up
        layers, wall = timed_ms(call)
        again = call()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        draws = [torch.rand((1024 * 10 ** h, 10), generator=gen,
                            device=dev) for h in range(2)]
        explicit = sampling.sample_khop(g, seeds, 10, 2, u=draws)
        eids = [sampling.sample_neighbors(g, f, 10, u=u)[1]
                for (f, _, _), u in zip(explicit, draws)]
    ro, dst = g.row_offsets.long(), g.edge_dst
    for h, ((f, nb, ok), (f2, nb2, ok2), (f3, nb3, ok3), e) in enumerate(
            zip(layers, again, explicit, eids)):
        for a, b, c in ((f, f2, f3), (nb, nb2, nb3), (ok, ok2, ok3)):
            if not (torch.equal(a, b) and torch.equal(a, c)):
                raise AssertionError(f"sampling hop {h}: two calls with "
                                     "one generator seed differ")
        v = f.long()[:, None].expand_as(e)
        e = e.long()
        end = ro[(v + 1).clamp(max=g.n_pad - 1)]
        inside = (e >= ro[v]) & (e < end) & (dst[e] == nb)
        live = (g.out_degree[f.long()] > 0) & (f != g.n)
        if not (bool(inside[ok].all()) and bool((nb[~ok] == g.n).all())
                and torch.equal(ok.any(1), live)):
            raise AssertionError(f"sampling hop {h}: a sample is not an "
                                 "edge of its vertex, or a dummy entry is "
                                 "not masked")
    valid = [int(ok.sum()) for _, _, ok in layers]
    print(f"  every valid sample an edge of its vertex, dummies masked, "
          f"same bits twice; valid {valid} of "
          f"{[1024 * 10, 1024 * 100]}; {wall:.3f} ms a call [{card}]",
          flush=True)
    done(t0)


CLI_ARGS = ["rmat", "--rmat-scale=16", "--undirected"]
# subcommands of phase 29: (argv, the kernels it must launch, the
# kernels it may launch besides: the pull-SpMV's launches are the value
# kernel's add sweep, which counts them too)
CLI_RUNS = [
    (["sssp"], ("value_step",), ()),
    (["cc", "--traversal-mode=planes"], ("value_step",), ()),
    (["pr", "--traversal-mode=pallas"], ("spmv",), ("value_step",)),
    (["bfs", "--traversal-mode=mega"], ("mega_step",), ()),
    (["topk"], (), ()), (["dobfs"], (), ()), (["mis"], (), ()),
    (["mst"], (), ()),
]


def run_cli(argv):
    """(rc, stdout, launches by kernel) of one cli.main call, with every
    launch count zeroed just before it."""
    import io
    from gunrockinst_tpu_torch import cli
    zero_launches(*KERNELS)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    return rc, out.getvalue(), {k: launches_of(k) for k in KERNELS}


def host_phase(csr20, src, ref_labels, card, counts):
    """Phase 29: the CLI on the card at rmat-s16 (validation on), the
    flat API against the primitives' own calls, and SteppedBfs
    (slice_depth=2) at rmat-s20 against phase 4's labels.  The kernel
    launches of each CLI subcommand go into `counts`."""
    from gunrockinst_tpu_torch import api
    from gunrockinst_tpu_torch.utils.instrument import SteppedBfs
    t0 = phase("29 cli, api and SteppedBfs on the card")
    for args, kernels, also in CLI_RUNS:
        t1 = time.perf_counter()
        rc, out, launched = run_cli(args + CLI_ARGS)
        wall = (time.perf_counter() - t1) * 1e3
        name = f"cli {' '.join(args)}"
        if rc != 0 or f"{args[0]} CORRECTNESS: PASSED" not in out:
            raise AssertionError(f"{name}: rc {rc}\n{out}")
        extra = {k: c for k, c in launched.items()
                 if c and k not in kernels + also}
        missing = [k for k in kernels if not launched[k]]
        if extra or missing:
            raise AssertionError(f"{name}: launched {launched}, expected "
                                 f"only {kernels}")
        for k in kernels:
            counts.setdefault(k, {})[name] = launched[k]
        block = next(line for line in out.splitlines()
                     if line.startswith(f"[{args[0]}] elapsed"))
        print(f"  {name}: PASSED; {block}; launches "
              f"{ {k: launched[k] for k in kernels} }; {wall:.1f} ms with "
              f"graph and oracle [{card}]", flush=True)
    csr16 = rmat_graph(16, 16, undirected=True, seed=0)
    ro, ci = csr16.row_offsets, csr16.col_indices
    w = np.random.default_rng(SEED).integers(1, 64, len(ci)).astype(
        np.float32)
    wcsr16 = CsrGraph.from_arrays(ro, ci, w)
    s = sources(csr16)[0]
    with no_kernel_launch("api"):
        t1 = time.perf_counter()
        pairs = [
            ("bfs", api.bfs(ro, ci, s)[0],
             bfs.run(csr16, s, mark_preds=False).labels),
            ("sssp", api.sssp(ro, ci, w, s)[0],
             sssp.run(wcsr16, s, mark_preds=False).dist),
            ("cc", api.cc(ro, ci)[0], cc.run(csr16).component_ids),
            ("bc", api.bc(ro, ci, src=s), bc.run(csr16, src=s).bc_values),
            ("pagerank", api.pagerank(ro, ci)[1], pr.run(csr16).sorted_ranks),
        ]
        from gunrockinst_tpu_torch.primitives import topk
        r = topk.run(csr16, 10)
        pairs += [(f"topk {i}", a, b) for i, (a, b) in enumerate(zip(
            api.topk(ro, ci, 10), (r.node_ids, r.centralities, r.in_degrees,
                                   r.out_degrees)))]
        wall = (time.perf_counter() - t1) * 1e3
    for name, a, b in pairs:
        if not np.array_equal(a, b):
            raise AssertionError(f"api.{name} differs from the primitive's "
                                 "own call")
    print(f"  api bfs, sssp, cc, bc, pagerank, topk at rmat-s16: equal to "
          f"the primitives' own calls ({wall:.1f} ms for both) [{card}]",
          flush=True)
    with no_kernel_launch("SteppedBfs"):
        stepped = SteppedBfs(csr20, src, slice_depth=2)
        labels, wall = timed_ms(stepped.run_to_completion)
    if not np.array_equal(labels, ref_labels):
        raise AssertionError("SteppedBfs labels differ from phase 4's")
    print(f"  SteppedBfs slice_depth=2 at rmat-s20: phase 4's labels; "
          f"{wall:.3f} ms; tracer {stepped.tracer.summary()} [{card}]",
          flush=True)
    done(t0)


def path_graph(n):
    """The undirected path 0 - 1 - ... - (n-1)."""
    u = np.arange(n - 1, dtype=np.int64)
    return CsrGraph.from_coo(CooGraph(n, np.concatenate([u, u + 1]),
                                      np.concatenate([u + 1, u]), None))


def chained_levels_ms(g, psrc, depth, reps, **kw):
    """Device ms of each level of the search from psrc, run `reps` times
    as the main path runs it: every level from the start frontier, back
    to back, no host sync, queued behind a device sleep, with CUDA events
    between levels.  `kw` goes to the step (the direction, where the
    wrapper has one).  Returns (median ms per level, median ms of the
    whole search)."""
    st = g.stepper
    reach = g.reach(psrc)
    runs = []
    for _ in range(reps):
        fw = g.start(psrc)
        runs.append(dict(fw=fw, vw=fw.clone(), planes=torch.zeros(
            (8 * g.rows, 128), dtype=torch.int32, device=fw.device),
            ev=[torch.cuda.Event(enable_timing=True)
                for _ in range(depth + 1)]))
    asleep = torch.cuda.Event()
    torch.cuda.synchronize()
    # ~0.5 ms of sleep per queued level: the host queues every launch
    # before the card wakes (checked below)
    torch.cuda._sleep(max(100_000_000, 1_000_000 * depth * reps))
    asleep.record()
    for r in runs:
        fw = r["fw"]
        r["ev"][0].record()
        for d in range(1, depth + 1):
            fw, _ = st.step(fw, r["vw"], r["planes"], d, reach, **kw)
            r["ev"][d].record()
    if asleep.query():
        raise AssertionError("the card woke before the levels were queued; "
                             "their events would hold host gaps")
    torch.cuda.synchronize()
    per = [sorted(r["ev"][d - 1].elapsed_time(r["ev"][d]) for r in runs)
           [reps // 2] for d in range(1, depth + 1)]
    whole = sorted(r["ev"][0].elapsed_time(r["ev"][depth])
                   for r in runs)[reps // 2]
    return per, whole


def cube_graph(side):
    """The undirected 3-D lattice side^3 (6 neighbours): a deep search
    (3 * (side - 1) levels from a corner) whose middle levels hold ~side^2
    vertices, the wide-frontier case of the chain kernel."""
    idx = np.arange(side ** 3, dtype=np.int64)
    us, vs = [], []
    for stride in (1, side, side * side):
        ok = (idx // stride) % side + 1 < side
        us.append(idx[ok])
        vs.append(idx[ok] + stride)
    return CsrGraph.from_coo(CooGraph(side ** 3, np.concatenate(us),
                                      np.concatenate(vs), None),
                             undirected=True)


def core_tail_graph(csr, tail):
    """`csr` (undirected) with a path of `tail` new vertices hung on its
    top-degree vertex: wide levels in the core, then a long thin tail."""
    n = csr.num_nodes
    rows = np.repeat(np.arange(n, dtype=np.int64),
                     np.diff(csr.row_offsets))
    path = np.arange(n, n + tail, dtype=np.int64)
    us = np.concatenate([rows, [int(np.argmax(csr.degrees))], path[:-1]])
    vs = np.concatenate([csr.col_indices.astype(np.int64), path[:1],
                         path[1:]])
    return CsrGraph.from_coo(CooGraph(n + tail, us, vs, None),
                             undirected=True)


def level_widths(planes, vw, n_planes, rows, n):
    """Vertices claimed at each level (index 0: the source) of a search,
    from its label planes and visited words."""
    level = torch.zeros(n, dtype=torch.int64, device=planes.device)
    for b in range(n_planes):
        level |= unpack_bitmap(planes[b * rows:(b + 1) * rows],
                               n).long() << b
    return torch.bincount(level[unpack_bitmap(vw, n)]).cpu().numpy()


def host_split(g, psrc, reach, levels, card):
    """The 8-plane host level loop from psrc (at most `levels` levels),
    split per level: host time inside the step wrapper, and of it the
    wrapper's C call (ctypes and the launches; timed by wrapping the
    module's `_kernel_fn`), the time between CUDA events around the step
    and the loop's wall time; then the loop's Python functions by their
    own time (cProfile)."""
    import cProfile
    import io
    import pstats
    st = g.stepper
    mod = sys.modules[type(st).__module__]
    real_fn = mod._kernel_fn
    c_call = [0.0]

    def timed_fn():
        fn = real_fn()

        def call(*args):
            t = time.perf_counter()
            out = fn(*args)
            c_call[0] += time.perf_counter() - t
            return out
        return call
    fw = g.start(psrc)
    vw = fw.clone()
    planes = torch.zeros((8 * g.rows, 128), dtype=torch.int32,
                         device=fw.device)
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(levels)]
    host = 0.0
    mod._kernel_fn = timed_fn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for d in range(1, levels + 1):
        evs[d - 1][0].record()
        t1 = time.perf_counter()
        fw, n_new = st.step(fw, vw, planes, d, reach)
        host += time.perf_counter() - t1
        evs[d - 1][1].record()
        if int(n_new.item()) == 0:
            break
    wall = (time.perf_counter() - t0) * 1e3
    mod._kernel_fn = real_fn
    dev = sum(s.elapsed_time(e) for s, e in evs[:d])
    print(f"  host loop split, {d} levels: wall {wall:.4f} ms "
          f"({wall * 1e3 / d:.2f} us a level): in the step wrapper "
          f"{host * 1e6 / d:.2f} us, of which its C call "
          f"{c_call[0] * 1e6 / d:.2f} us; between the events around the "
          f"step {dev * 1e3 / d:.2f} us a level [{card}]", flush=True)
    prof = cProfile.Profile()
    prof.enable()
    g.search(psrc, reach, 8, levels)
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(10)
    rows = [ln for ln in out.getvalue().splitlines()
            if ln.strip()[:1].isdigit()]
    for ln in rows[:10]:
        print(f"    {' '.join(ln.split())}", flush=True)


def step_directions(st):
    """The directions the step wrapper can be forced to take (none
    before the push/pull design)."""
    import inspect
    if "direction" in inspect.signature(st.step).parameters:
        return ("auto", "push", "pull")
    return ("as is",)


def bfs_variants(csr, dev, card):
    """`--variants DIR`, the BFS kernels: the step kernel per level
    (chained as the main path runs it) at rmat-s20 from the top-degree
    and a random source, and on a level with no candidate (reach & ~vw
    empty: the launch and the word scan alone); the chain kernel on the
    2045-vertex path (one vertex a level: the fixed cost of a level) and
    at grid-1024^2."""
    for scale, csr_s in ((14, graph(14)), (20, csr)):
        g = search_graph(csr_s, dev)
        st = g.stepper
        for which, src in zip(("top-degree", "random"), sources(csr_s)):
            psrc = g.internal(src)
            depth = g.search(psrc, g.reach(psrc), 8, g.n)[2]
            for how in step_directions(st):
                kw = {} if how == "as is" else dict(direction=how)
                per, whole = chained_levels_ms(g, psrc, depth, 20, **kw)
                print(f"  step s{scale} {which} src {src}, {how}: {depth} "
                      f"levels, search {whole * 1e3:.1f} us (sum of levels "
                      f"{sum(per) * 1e3:.1f}); per level "
                      + ", ".join(f"{ms * 1e3:.1f}" for ms in per)
                      + f" us [{card}]", flush=True)
    g = search_graph(csr, dev)
    st = g.stepper
    psrc = g.internal(sources(csr)[0])
    reach = g.reach(psrc)
    fw = g.start(psrc)
    vw = reach | fw
    planes = torch.zeros((8 * g.rows, 128), dtype=torch.int32, device=dev)
    for how in step_directions(st):
        kw = {} if how == "as is" else dict(direction=how)
        ms = event_ms(lambda: st.step(fw, vw, planes, 1, reach, **kw),
                      lambda: None, 20)
        print(f"  step s20, no candidate, {how}: {ms * 1e3:.1f} us "
              f"[{card}]", flush=True)
    import inspect
    layouts = ((("one block", dict(widths=[1])),
                ("global map", dict(map_cap=0)))
               if "widths" in inspect.signature(chain.ChainBfs).parameters
               else (("as is", {}),))
    for label, csr_c, src in (
            (f"path-{CHAIN_DEEP}", path_graph(CHAIN_DEEP), 0),
            ("grid-1024^2", grid_graph(1024), None),
            ("cube-112^3", cube_graph(112), 0),
            ("rmat-s18 + tail-400", core_tail_graph(graph(18), 400), None)):
        if src is None:
            src = int(np.argmax(csr_c.degrees))
        gc = search_graph(csr_c, dev)
        psrc = gc.internal(src)
        if label.startswith("grid"):
            # the step kernel on a road-like graph: the 8-plane pass that
            # a deep search's first call runs before it goes deep
            reach = gc.reach(psrc)
            loop = wall_ms(lambda: gc.search(psrc, reach, 8, 255), 3)
            print(f"  step {label} src {src}, 255 levels through the host "
                  f"level loop: {loop:.4f} ms [{card}]", flush=True)
            host_split(gc, psrc, reach, 255, card)
        if len(layouts) > 1:
            widths = []     # what the route measures before it goes deep
            gc.search(psrc, gc.reach(psrc), 8, 255, widths=widths)
            cluster = chain.layout(gc.n_words, chain._smem_limit(), None,
                                   widths)[0]
            wide = sum(w > chain.NARROW_LEVEL for w in widths)
            print(f"  chain {label}: the route passes the widths of "
                  f"{len(widths)} levels ({wide} wider than "
                  f"{chain.NARROW_LEVEL}, widest {max(widths)}) and takes "
                  f"{'one block' if cluster == 1 else 'the global map'}",
                  flush=True)
        for name, kw in layouts:
            ch = chain.ChainBfs(gc, max((gc.n + 1).bit_length(), 1), **kw)
            planes, vw, depth = ch(psrc)
            width = level_widths(planes, vw, ch.planes, gc.rows, gc.n)
            depth = int(depth)
            ms = event_ms(lambda: ch(psrc), lambda: None, 10)
            print(f"  chain {label} src {src}, {name}: {depth} levels "
                  f"(widest {int(width.max())} vertices, mean "
                  f"{gc.n / max(len(width), 1):.0f}), {ms:.4f} ms "
                  f"({ms * 1e3 / depth:.3f} us per level) [{card}]",
                  flush=True)


def digest(tensors):
    """The first 16 hex digits of the sha256 of the tensors' bytes: the
    same on two checkouts when their kernels give the same bits."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.int32).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


WALL_CALLS = 11         # `walls`: timed calls of each entry point


def walls(card):
    """`--variants DIR walls`: the timed call's wall ms (each entry
    point's own Stats.elapsed_ms, after its warm-up) of WALL_CALLS calls
    of each value-kernel entry point at rmat-s20 (SSSP unweighted and
    weights 1..63, CC, PR planes and pallas on the undirected graph;
    HITS, SALSA, WTF and BC planes on both), with their medians."""
    und, dire = graph(20), graph(20, undirected=False)
    src = sources(und)[0]
    w = np.random.default_rng(SEED).integers(1, 64, und.num_edges).astype(
        np.float32)
    wcsr = CsrGraph.from_arrays(und.row_offsets, und.col_indices, w)
    calls = {
        "sssp": lambda: sssp.run(und, src, mode="planes", mark_preds=False),
        "sssp weighted": lambda: sssp.run(wcsr, src, mode="planes",
                                          mark_preds=False),
        "cc": lambda: cc.run(und, mode="planes"),
        "pr": lambda: pr.run(und, max_iter=PR_ITERS, mode="planes"),
        "pr pallas": lambda: pr.run(und, max_iter=PR_ITERS, mode="pallas"),
    }
    for kind, csr in (("undirected", und), ("directed", dire)):
        s = sources(csr)[0]
        calls.update({
            f"hits {kind}": lambda csr=csr, s=s: hits.run(
                csr, src=s, max_iter=RANK_ITERS, mode="planes"),
            f"salsa {kind}": lambda csr=csr: salsa.run(
                csr, max_iter=RANK_ITERS, mode="planes"),
            f"wtf {kind}": lambda csr=csr, s=s: wtf.run(
                csr, src=s, cot_size=COT_SIZE, mode="planes"),
            f"bc {kind}": lambda csr=csr, s=s: bc.run(csr, src=s,
                                                      mode="planes"),
        })
    for name, call in calls.items():
        ms = [call().stats.elapsed_ms for _ in range(WALL_CALLS)]
        print(f"  wall {name}: median {sorted(ms)[len(ms) // 2]:.4f} ms "
              f"(" + ", ".join(f"{t:.4f}" for t in ms) + f") [{card}]",
              flush=True)


def variants(dev, card, only=None):
    """`--variants DIR [bfs|sweeps|walls]`: the BFS kernels
    (`bfs_variants`) unless `sweeps` or `walls` is given, then, unless
    `bfs` is given, the s20 sweeps of phases 6, 12 and 14 as they are and
    on the variant inputs; with `walls` only `walls`; on the kernels of
    the package imported (DIR's)."""
    import gunrockinst_tpu_torch
    print(f"  kernels of {Path(gunrockinst_tpu_torch.__file__).parent}",
          flush=True)
    if only == "walls":
        walls(card)
        return 0
    csr = graph(20)
    if only != "sweeps":
        bfs_variants(csr, dev, card)
    if only == "bfs":
        return 0
    g = search_graph(csr, dev)
    rng = np.random.default_rng(SEED + 20)
    for name in VALUE_CONFIGS:
        st, vals, ch = value_inputs(g.stepper.offsets, g.stepper.in_src,
                                    g.n, name, rng)
        out = torch.empty_like(vals)
        kw = dense_kw(st)
        ms = event_ms(lambda: st.sweep(vals, ch, out=out, **kw),
                      lambda: None, 20)
        print(f"  value {name}: dense {ms * 1e3:.1f} us, one source "
              f"{one_source_ms(st, vals, ch, name) * 1e3:.1f} us; bits "
              f"{digest(st.sweep(vals, ch, **kw)[:2])} [{card}]",
              flush=True)

    sw = pr.get_spmv_sweeper(csr, dev)
    c = np.zeros(sw.n_pad, np.float32)
    c[: sw.n] = np.random.default_rng(SEED).random(sw.n, dtype=np.float32)
    contrib = torch.from_numpy(c).to(dev)
    ms = event_ms(lambda: sw(contrib), lambda: None, 20)
    print(f"  spmv: {ms * 1e3:.1f} us, one source "
          f"{spmv_one_source_ms(sw, contrib) * 1e3:.1f} us; bits "
          f"{digest([sw(contrib)])} [{card}]", flush=True)

    sw = bfs_pallas.get_pull_sweeper(csr, dev)
    for d, (fw, vw) in enumerate(touch_levels(sw, sources(csr)[0])):
        k_ms = event_ms(lambda: sw(fw), lambda: None, 20)
        f_ms = event_ms(lambda: sw.sweep_fused(fw, vw), lambda: None, 20)
        extra = ""
        if d == 2:
            all_ms, none_ms = touch_variant_ms(sw, fw)
            extra = (f", every frontier bit set {all_ms * 1e3:.1f} us, none "
                     f"{none_ms * 1e3:.1f} us")
        print(f"  touch level {d}: {k_ms * 1e3:.1f} us, fused "
              f"{f_ms * 1e3:.1f} us{extra} [{card}]", flush=True)
    return 0


# ---- phases 30-32: the multi-device tier (parallel/) -----------------------

PAR_RANKS = 4           # ranks of phases 31-32, sharing the one card (gloo)
PAR_TOPK = 1000
PAR_CLOSE = dict(rtol=1e-4, atol=1e-6)
# the tiers' PR stops after max_iter iterations, pr.run and the oracle
# after max_iter + 1: the 6 of phase 9.  Deeper, the threshold gate
# flips on last-bit differences and no two orders of summation agree
PAR_PR_ITERS = PR_ITERS + 1


def par_layouts():
    """Each output's kind, per entry point: e/E an owned int/float slice
    (the ranks' slices concatenated), r/R a replicated int/float value,
    t the modelled bytes (replicated, depends on P)."""
    return {"bfs": "eert", "bfs grid": "eert", "dobfs": "eerrt",
            "sssp": "ert", "cc": "ert", "pr": "Et", "bc": "Rrt",
            "hits": "RRt", "hits directed": "RRt", "salsa": "RRt",
            "salsa directed": "RRt", "mis": "rrt", "topk": "rrt",
            "wtf": "RRt", "wtf directed": "RRt", "mst": "rrrt",
            "bfs_dist": "rrr", "sssp_dist": "rr", "cc_dist": "rr",
            "pagerank_push_dist": "R", "hits_dist": "RR",
            "hits_dist directed": "RR", "salsa_dist": "RR",
            "salsa_dist directed": "RR", "mis_dist": "rr",
            "topk_dist": "rr", "dobfs_dist": "rrrr", "bc_dist": "RRrr",
            "mst_dist": "rrr", "wtf_dist": "RR", "wtf_dist directed": "RR"}


def par_mis_prio(n, n_pad):
    prio = np.zeros(n_pad, np.int32)
    prio[:n] = np.random.default_rng(0).permutation(n)
    return prio


def par_calls(tier, n, p, srcs):
    """(label, entry point, args, kwargs) of one tier's calls at P ranks,
    its graphs named by what each rank keeps (`par_keep`)."""
    from gunrockinst_tpu_torch.parallel import dist, dist_more
    from gunrockinst_tpu_torch.parallel import dist_words as dw
    from gunrockinst_tpu_torch.parallel.mesh import MESH, Kept
    k = Kept
    src = srcs["undirected"]
    if tier == "words":
        n_loc = -(-(n + 1) // (4096 * p)) * 4096
        calls = [("bfs", dw.bfs_dist_words, (k("g20"), src, MESH)),
                 ("bfs grid", dw.bfs_dist_words, (k("ggrid"), 0, MESH)),
                 ("dobfs", dw.dobfs_dist_words, (k("g20"), src, MESH)),
                 ("sssp", dw.sssp_dist_words, (k("gw20"), src, MESH)),
                 ("cc", dw.cc_dist_words, (k("g20"), MESH)),
                 ("pr", dw.pagerank_dist_words, (k("g20"), MESH),
                  dict(max_iter=PAR_PR_ITERS)),
                 ("bc", dw.bc_dist_words, (k("csr20"), src, MESH))]
        for kind in ("", " directed"):
            g = k("dcsr20" if kind else "csr20")
            s = srcs["directed" if kind else "undirected"]
            calls += [(f"hits{kind}", dw.hits_dist_words, (g, MESH, s),
                       dict(max_iter=RANK_ITERS)),
                      (f"salsa{kind}", dw.salsa_dist_words, (g, MESH),
                       dict(max_iter=RANK_ITERS))]
        calls += [("mis", dw.mis_dist_words,
                   (k("csr20"), MESH, par_mis_prio(n, n_loc * p))),
                  ("topk", dw.topk_dist_words, (k("csr20"), MESH, PAR_TOPK))]
        for kind in ("", " directed"):
            g = k("dcsr20" if kind else "csr20")
            s = srcs["directed" if kind else "undirected"]
            calls.append((f"wtf{kind}", dw.wtf_dist_words, (g, MESH, s),
                          dict(cot_size=COT_SIZE)))
        calls.append(("mst", dw.mst_dist_words,
                      (k("mst_u"), k("mst_v"), k("mst_w"), n, MESH)))
    else:
        n_pad = -(-(n + 1) // 128) * 128
        calls = [("bfs_dist", dist.bfs_dist, (k("s20"), src, MESH)),
                 ("sssp_dist", dist.sssp_dist, (k("sw20"), src, MESH)),
                 ("cc_dist", dist.cc_dist, (k("s20"), MESH)),
                 ("pagerank_push_dist", dist.pagerank_push_dist,
                  (k("s20"), MESH), dict(max_iter=PAR_PR_ITERS))]
        for kind in ("", " directed"):
            g = k("ds20" if kind else "s20")
            s = srcs["directed" if kind else "undirected"]
            calls += [(f"hits_dist{kind}", dist_more.hits_dist, (g, MESH, s),
                       dict(max_iter=RANK_ITERS)),
                      (f"salsa_dist{kind}", dist_more.salsa_dist, (g, MESH),
                       dict(max_iter=RANK_ITERS))]
        calls += [("mis_dist", dist_more.mis_dist,
                   (k("s20"), MESH, par_mis_prio(n, n_pad))),
                  ("topk_dist", dist_more.topk_dist,
                   (k("s20"), MESH, PAR_TOPK)),
                  ("dobfs_dist", dist_more.dobfs_dist,
                   (k("s20"), src, MESH)),
                  ("bc_dist", dist_more.bc_dist, (k("s20"), src, MESH)),
                  ("mst_dist", dist_more.mst_dist,
                   (k("mst_u"), k("mst_v"), k("mst_w"), n, MESH))]
        for kind in ("", " directed"):
            g = k("ds20" if kind else "s20")
            s = srcs["directed" if kind else "undirected"]
            calls.append((f"wtf_dist{kind}", dist_more.wtf_dist,
                          (g, MESH, s), dict(cot_size=COT_SIZE)))
    return [c if len(c) == 4 else c + ({},) for c in calls]


def par_keep(tier):
    """(name, value) pairs each rank keeps beside the host graphs: their
    partitions, built on the rank (call(...) runs there)."""
    from gunrockinst_tpu_torch.graph.csr import DeviceGraph
    from gunrockinst_tpu_torch.parallel import dist_words as dw
    from gunrockinst_tpu_torch.parallel.mesh import MESH, Kept, call
    from gunrockinst_tpu_torch.parallel.partition import shard_graph
    pairs = []
    if tier == "words":
        for name, g in (("g20", "csr20"), ("gw20", "wcsr20"),
                        ("ggrid", "grid")):
            pairs.append((name, call(dw.shard_graph_by_dst, Kept(g), MESH)))
    else:
        for name, g in (("s20", "csr20"), ("sw20", "wcsr20"),
                        ("ds20", "dcsr20")):
            dg = call(DeviceGraph.build, Kept(g), with_csc=False,
                      device=call(getattr, MESH, "device"))
            pairs.append((name, call(shard_graph, dg, MESH)))
    return pairs


def par_peak_jobs(n, p):
    """The two word-tier partition builders of rmat-s20 at P ranks, as
    (builder, args...) for `memory_peaks`."""
    from gunrockinst_tpu_torch.parallel import dist_words as dw
    from gunrockinst_tpu_torch.parallel.mesh import MESH, Kept
    n_loc = -(-(n + 1) // (4096 * p)) * 4096
    return [(dw.shard_graph_by_dst, Kept("csr20"), MESH),
            (dw._src_owned_edges, Kept("csr20"), n_loc, p, n, MESH)]


def print_peaks(p, per_rank):
    """One line a rank: each builder's host peak (its NumPy buffers),
    device peak and device bytes kept, and the rank's peak RSS."""
    for r, peaks in enumerate(per_rank):
        parts = [f"{what} host peak {k['host_peak']} B, device peak "
                 f"{k['device_peak']} B, kept {k['device_kept']} B"
                 for what, k in zip(("dst-owned", "src-owned"), peaks)]
        rss = ("the smoke's own process" if p == 1
               else f"{peaks[-1]['rss_peak']} B")
        print(f"  partition memory, rmat-s20, {p} rank(s), rank {r}: "
              f"{'; '.join(parts)}; peak RSS {rss}", flush=True)


def par_outputs(label, per_rank):
    """One call's outputs from every rank's: owned slices concatenated
    in rank order, replicated values checked equal on every rank."""
    layout = par_layouts()[label]
    per_rank = [o if isinstance(o, tuple) else (o,) for o in per_rank]
    outs = []
    for i, kind in enumerate(layout):
        vals = [o[i] for o in per_rank]
        if kind in "eE":
            outs.append(np.concatenate(vals))
            continue
        for r, v in enumerate(vals[1:], 1):
            if not np.array_equal(np.asarray(v), np.asarray(vals[0])):
                raise AssertionError(f"{label}: rank {r}'s output {i} "
                                     "differs from rank 0's")
        outs.append(vals[0])
    return outs


def check_mis_set(csr, in_set):
    src, dst = edge_list(csr)
    if (in_set[src] & in_set[dst]).any():
        raise AssertionError("mis: the set is not independent")
    covered = np.bincount(src[in_set[dst]], minlength=csr.num_nodes) > 0
    if not (in_set | covered).all():
        raise AssertionError("mis: the set is not maximal")


def grid_oracle(side):
    """BFS labels and min-id preds from vertex 0 of grid_graph(side):
    Manhattan distance; the parent above, else the one to the left."""
    ids = np.arange(side * side, dtype=np.int64)
    r, c = ids // side, ids % side
    labels = (r + c).astype(np.int32)
    preds = np.where(r > 0, ids - side, ids - 1).astype(np.int32)
    preds[0] = -1
    return labels, preds


def par_check(label, out, refs):
    """Holds one single-rank output to what the JAX package's tests hold
    its call to: the oracles of earlier phases and scipy."""
    n = refs["n"]
    name = label.split()[0]
    directed = label.endswith("directed")
    kind = "directed" if directed else "undirected"
    if name in ("bfs", "dobfs", "bfs_dist", "dobfs_dist"):
        want = refs["grid"] if label == "bfs grid" else refs["bfs"]
        m = len(want[0])
        if not (np.array_equal(out[0][:m], want[0])
                and np.array_equal(out[1][:m], want[1])):
            raise AssertionError(f"{label}: labels or preds differ from the "
                                 "oracle")
    elif name in ("sssp", "sssp_dist"):
        if not np.array_equal(out[0][:n], refs["sssp"]):
            raise AssertionError(f"{label}: distances differ from scipy's")
    elif name in ("cc", "cc_dist"):
        if not np.array_equal(out[0][:n], refs["cc"]):
            raise AssertionError(f"{label}: components differ from scipy's")
    elif name in ("pr", "pagerank_push_dist"):
        close(f"{label} ranks", out[0][:n], refs["pr"][0], 1e-4)
        close(f"{label} ranks (vs pr.run planes)", out[0][:n], refs["pr"][1],
              1e-4)
    elif name in ("bc", "bc_dist"):
        close(f"{label} values", out[0][:n], refs["bc"], 1e-4)
    elif name in ("hits", "salsa", "hits_dist", "salsa_dist"):
        hub, auth = refs["rank"][kind][0 if name.startswith("hits") else 1]
        close(f"{label} hub ranks", out[0][:n], hub, 1e-4)
        close(f"{label} auth ranks", out[1][:n], auth, 1e-4)
    elif name in ("mis", "mis_dist"):
        state = out[0][:n]
        if (state == 0).any():
            raise AssertionError(f"{label}: a vertex was never decided")
        check_mis_set(refs["csr"], state == 1)
    elif name in ("topk", "topk_dist"):
        ids, cent = refs["topk"][:2]
        if not (np.array_equal(out[0], ids) and np.array_equal(out[1], cent)):
            raise AssertionError(f"{label}: differs from the oracle")
    elif name in ("wtf", "wtf_dist"):
        csr = refs["graphs"][kind]
        src = refs["srcs"][kind]
        ppr = out[1][:n]
        cot_pl, pinned, want_ppr = refs["wtf"][kind]
        close(f"{label} ppr ranks", ppr, want_ppr, 1e-3)
        cot = np.argsort(-ppr, kind="stable")[:COT_SIZE]
        if not np.array_equal(cot, cot_pl):
            pinned = wtf_reference(csr, src, cot_size=COT_SIZE, cot=cot)[0]
        close(f"{label} ranks", out[0][:n], pinned, 1e-3)
    elif name in ("mst", "mst_dist"):
        got = float(refs["mst"][2][out[0]].astype(np.float64).sum())
        if not np.isclose(got, refs["mst_weight"], rtol=1e-6, atol=0):
            raise AssertionError(f"{label}: weight {got} differs from "
                                 f"scipy's {refs['mst_weight']}")
    else:
        raise AssertionError(f"no check for {label}")


def par_line(label, out, wall, coll, wall_t, card, extra=""):
    layout = par_layouts()[label]
    ints = [out[i] for i, k in enumerate(layout) if k == "r"
            and np.ndim(out[i]) == 0]
    traffic = [out[i] for i, k in enumerate(layout) if k == "t"]
    print(f"  {label}: {wall:.3f} ms; levels/rounds {ints}; modelled "
          f"bytes/rank {traffic[0] if traffic else 'n/a'}"
          f"{' (past int32)' if traffic and traffic[0] >= 2**31 else ''}; "
          f"warm-up collectives {coll:.3f} of {wall_t:.3f} ms{extra} "
          f"[{card}]",
          flush=True)


def par_single(tier, data, refs, card):
    """Phase 30 (the word tier) or the first half of 32 (the fallbacks):
    one rank on nccl in this process.  Returns {label: outputs}."""
    from gunrockinst_tpu_torch.parallel.mesh import bind, edge_mesh, timed
    from gunrockinst_tpu_torch.parallel.mesh import to_host
    mesh = edge_mesh(device=resolve_device(None))
    kept = dict(data)
    t1 = time.perf_counter()
    for name, value in par_keep(tier):
        kept[name] = bind(value, mesh, kept)
    mesh.sync()
    print(f"  1 rank ({mesh.path}): partitions built in "
          f"{(time.perf_counter() - t1) * 1e3:.1f} ms", flush=True)
    if tier == "words":
        from gunrockinst_tpu_torch.parallel.mesh import memory_peaks
        print_peaks(1, [tuple(memory_peaks(mesh, *bind(job, mesh, kept))
                              for job in par_peak_jobs(refs["n"], 1))])
    results = {}
    for label, fn, args, kwargs in par_calls(tier, refs["n"], 1,
                                             refs["srcs"]):
        with no_kernel_launch(label):
            out, wall, coll, wall_t = timed(mesh, fn, *bind(args, mesh, kept),
                                            **kwargs)
        out = par_outputs(label, [to_host(out)])
        par_check(label, out, refs)
        results[label] = out
        par_line(label, out, wall, coll, wall_t, card)
    del kept
    torch.cuda.empty_cache()
    return results


def par_pool(tier, pool, refs, single, card):
    """Phase 31 or the second half of 32: the same calls on PAR_RANKS
    gloo ranks sharing the card, which keep the host graphs already;
    integer outputs equal phase 30's (or 32's single rank's) bit for
    bit, float outputs allclose."""
    from gunrockinst_tpu_torch.parallel.mesh import MESH, timed
    t1 = time.perf_counter()
    for name, value in par_keep(tier):
        pool.keep(name, value)
    print(f"  {pool.size} ranks: partitions built in "
          f"{(time.perf_counter() - t1) * 1e3:.1f} ms", flush=True)
    if tier == "words":
        from gunrockinst_tpu_torch.parallel.mesh import memory_peaks
        print_peaks(pool.size, list(zip(*(
            pool.run(memory_peaks, MESH, *job)
            for job in par_peak_jobs(refs["n"], pool.size)))))
    for label, fn, args, kwargs in par_calls(tier, refs["n"], pool.size,
                                             refs["srcs"]):
        per_rank = pool.run(timed, MESH, fn, *args, **kwargs)
        out = par_outputs(label, [r[0] for r in per_rank])
        want = single[label]
        same = True
        for i, kind in enumerate(par_layouts()[label]):
            if np.ndim(out[i]) == 1 and len(out[i]) != len(want[i]):
                # vertex vectors padded to P's n_pad: the real vertices
                out[i], want[i] = out[i][:refs["n"]], want[i][:refs["n"]]
            if kind in "er":
                if not np.array_equal(out[i], want[i]):
                    raise AssertionError(f"{label}: output {i} at "
                                         f"{pool.size} ranks differs from "
                                         "one rank's")
            elif kind in "ER":
                close(f"{label} output {i} at {pool.size} ranks",
                      np.asarray(out[i]), np.asarray(want[i]),
                      PAR_CLOSE["rtol"], PAR_CLOSE["atol"])
                same = same and np.array_equal(out[i], want[i])
        walls = [r[1] for r in per_rank]
        floats = ("" if not set("ER") & set(par_layouts()[label]) else
                  f"; floats {'bitwise equal' if same else 'allclose'} to "
                  "1 rank's")
        par_line(label, out, max(walls), max(r[2] for r in per_rank),
                 max(r[3] for r in per_rank), card,
                 f"{floats}; rank walls {min(walls):.3f}-{max(walls):.3f}")


def parallel_phases(data, refs, card):
    """Phases 30-32."""
    import torch.distributed as tdist
    from gunrockinst_tpu_torch.parallel.mesh import MESH, RankPool, mesh_check
    t0 = phase("30 parallel word tier, 1 rank on nccl, rmat-s20 and "
               "grid-1024^2")
    words = par_single("words", data, refs, card)
    done(t0)
    t0 = phase(f"31 parallel word tier, {PAR_RANKS} ranks on the card "
               f"through gloo")
    torch.cuda.empty_cache()
    try:
        with RankPool(PAR_RANKS, device="cuda", backend="gloo",
                      deadline_s=600) as pool:
            checked = pool.run(mesh_check, MESH)
            print(f"  {PAR_RANKS} ranks up in {time.perf_counter() - t0:.1f}"
                  f" s; exchange path: {checked[0][2]} (gloo takes the "
                  f"card's tensors as they are); ranks {checked[0][0]}",
                  flush=True)
            t1 = time.perf_counter()
            for name, value in data.items():
                pool.keep(name, value)
            print(f"  host graphs sent to the ranks in "
                  f"{time.perf_counter() - t1:.1f} s", flush=True)
            par_pool("words", pool, refs, words, card)
            done(t0)
            t0 = phase(f"32 parallel replicated fallbacks, 1 rank on nccl "
                       f"and {PAR_RANKS} ranks through gloo")
            fallbacks = par_single("replicated", data, refs, card)
            par_pool("replicated", pool, refs, fallbacks, card)
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    done(t0)


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    dev = resolve_device(None)
    if sys.argv[1:2] == ["--variants"]:
        t0 = phase("sweep variants")
        variants(dev, card_line(), only=(sys.argv[3:4] or [None])[0])
        done(t0)
        faulthandler.cancel_dump_traceback_later()
        return 0

    t0 = phase("1 device")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{kind}; nvidia-smi: {card}", flush=True)
    done(t0)

    t0 = phase("2 build")
    reports = _build.build(sorted({Path(k["source"]).stem
                                   for k in KERNELS.values()}))
    for name, report in reports.items():
        print(f"  {name}: {report.strip() or 'cached'}", flush=True)
    done(t0, "built")

    t0 = phase("3 kernel vs plain version")
    max_err, timing, step_times = 0, None, {}
    csrs = {}
    for scale in (14, 20):
        csr = csrs[scale] = graph(scale)
        g = search_graph(csr, dev)
        for which, src in zip(("top-degree", "random"), sources(csr)):
            label = f"s{scale} {which} src {src}"
            levels, reach, err = compare_search(g, g.internal(src), label)
            max_err = max(max_err, err)
            rows = time_levels(g, levels, reach, g.internal(src), label, card)
            step_times[label] = sum(r["ms"] for r in rows)
            if scale == 20 and which == "top-degree":
                timing = rows
    csr14, csr20 = csrs[14], csrs[20]
    for label, csr in step_edge_graphs().items():
        g = search_graph(csr, dev)
        for which, src in zip(("top-degree", "random"), sources(csr)):
            max_err = max(max_err, compare_search(
                g, g.internal(src), f"{label} {which} src {src}")[2])
    g = search_graph(csr14, dev)
    src = sources(csr14)[1]
    compare_stale_slot(g, g.internal(src), f"s14 random src {src}")
    done(t0)

    # ---- the main path: counts from here on --------------------------
    zero_launches()
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
    preds_memory_line(csr20, src, res.labels, ref_preds, card)
    done(t0, "labels and preds exact")

    t0 = phase(f"5 get_fused_bfs_multi reps={MULTI_K}, rmat-s20")
    fn = bfs_pallas.get_fused_bfs_multi(csr20, reps=MULTI_K)
    srcs = np.argsort(-csr20.degrees, kind="stable")[:MULTI_K].astype(
        np.int32)
    fn(srcs)                                   # warm-up
    walls, timed_from = [], launches_of("mega_step")
    for _ in range(3):
        deps, vws, wall = fn(srcs)
        walls.append(wall)
    launches = {"mega_step": launches_of("mega_step")}
    per_search = (launches["mega_step"] - timed_from) / (3 * MULTI_K)
    # ---- end of the main path ----------------------------------------
    ref_vis = ref_labels != INF32
    symmetric = is_symmetric(search_graph(csr20, dev).csr_p)
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
    card_ms = replay_ms(search_graph(csr20, dev), srcs, deps,
                        vws)
    busy = sum(card_ms)
    print(f"  replay, no host sync between levels: step kernels "
          f"{busy:.4f} ms for {MULTI_K} searches ({busy / MULTI_K:.5f} "
          f"ms/search; per search min {min(card_ms):.5f}, max "
          f"{max(card_ms):.5f}); card idle {100 * (1 - busy / best):.2f}%"
          f" of the best call, {100 * (1 - busy / med):.2f}% of the "
          f"median [{card}]", flush=True)
    done(t0)

    value_err, value_rows, sweep, route_rows = value_phase(csrs, dev, card)

    # ---- the value-plane paths: one count window per entry point -----
    by_path, by_route, replays = {}, {}, {}
    sssp_planes = sssp_phase(csr20, csr14, dev, card, by_path, by_route,
                             replays)
    preds_counts = {}
    preds_row, decode_kernel_row = preds_phase(
        csr20, sssp_planes, src, ref_labels, ref_preds, dev, card,
        preds_counts)
    launches["min_preds"] = sum(preds_counts.values())
    launches["plane_labels"] = decode_kernel_row["launches"]
    cc_phase(csr20, dev, card, by_path, by_route, replays)
    planes_ranks, pr_ref = pr_phase(csr20, card, by_path, by_route)
    # ---- end of the value-plane paths (more in phases 16-18) ---------

    chain_err, chain_row, csr1024 = chain_phase(csr14, dev, card)
    # ---- the deep BFS path: its own count window ---------------------
    chain_counts = {}
    decode_kernel_row["configs"].append(
        chain_path(csr1024, dev, card, chain_counts))
    launches["chain_bfs"] = sum(chain_counts.values())
    # ---- end of the deep BFS path ------------------------------------
    touch_err, touch_row = touch_phase(csrs, dev, card)
    # ---- the grid-stepped paths: one count window per entry point ----
    touch_counts = {}
    sweep_paths(csr20, src, ref_labels, ref_preds, card, touch_counts)
    launches["touch_sweep"] = sum(touch_counts.values())
    # ---- end of the grid-stepped paths -------------------------------

    graphs = {"undirected": csr20, "directed": graph(20, undirected=False)}
    spmv_err, spmv_row = spmv_phase(graphs, dev, card)
    # ---- the pull-SpMV path: its own count window --------------------
    spmv_counts = {}
    pr_pallas_phase(csr20, planes_ranks, pr_ref, card, spmv_counts,
                    by_route)
    launches["spmv"] = sum(spmv_counts.values())
    # ---- end of the pull-SpMV path -----------------------------------
    # ---- the link-analysis paths: one value count window per call ----
    rank_refs = hits_salsa_phase(graphs, card, by_path, by_route)
    wtf_refs = wtf_phase(graphs, card, by_path, by_route)
    bc_refs = bc_phase(graphs, dev, card, by_path, by_route, replays)
    launches["value_step"] = sum(by_path.values())
    # ---- end of the link-analysis paths ------------------------------
    print(f"  value_step launches per path: {by_path}", flush=True)
    print(f"  value_step launches per path and route: {by_route}",
          flush=True)
    for path in ("sssp", "sssp weighted", "cc", "bc undirected",
                 "bc directed"):
        if by_route[path]["push"] + by_route[path]["touched"] == 0:
            raise AssertionError(f"{path}: no sweep took the push or the "
                                 f"touched route ({by_route[path]})")
    # ---- the default modes: no hand-written kernel may launch --------
    bfs_xla_phase(csr20, src, ref_labels, ref_preds, res, card)
    sssp_xla_phase(sssp_planes, csr14, card)
    cc_xla_phase(csr20, card)
    rank_xla_phase(graphs, pr_ref, rank_refs, wtf_refs, card)
    bc_xla_phase(graphs, bc_refs, csr14, card)
    # ---- the last primitives and sampling: no kernel may launch -------
    topk_phase(csr20, card)
    dobfs_phase(csr20, src, ref_labels, ref_preds, card)
    mis_phase(csr20, card)
    canon, mst_weight = mst_phase(sssp_planes["weights 1..63"][0], card)
    sampling_phase(csr20, card)
    # ---- the host surfaces: one count window per CLI subcommand -------
    cli_counts = {}
    host_phase(csr20, src, ref_labels, card, cli_counts)
    by_path.update(cli_counts["value_step"])
    launches["value_step"] = sum(by_path.values())
    spmv_counts.update(cli_counts["spmv"])
    launches["spmv"] = sum(spmv_counts.values())
    mega_counts = {"bfs.run auto, get_fused_bfs_multi":
                   launches["mega_step"], **cli_counts["mega_step"]}
    launches["mega_step"] = sum(mega_counts.values())
    # ---- end of the host surfaces -------------------------------------
    # ---- the multi-device tier: no hand-written kernel may launch -----
    from gunrockinst_tpu_torch.oracles import topk_degree_reference
    t1 = time.perf_counter()
    par_refs = {
        "n": csr20.num_nodes, "csr": csr20, "graphs": graphs,
        "srcs": {k: sources(g)[0] for k, g in graphs.items()},
        "bfs": (ref_labels, ref_preds), "grid": grid_oracle(1024),
        "sssp": sssp_planes["weights 1..63"][2],
        "cc": scipy_components(csr20), "bc": bc_refs["undirected"][0],
        "rank": rank_refs, "wtf": wtf_refs,
        "topk": topk_degree_reference(csr20, PAR_TOPK),
        "mst": canon, "mst_weight": mst_weight,
        "pr": (pr_ref, planes_ranks)}
    print(f"[30-32 oracles] {time.perf_counter() - t1:.1f} s", flush=True)
    parallel_phases({"csr20": csr20, "dcsr20": graphs["directed"],
                     "wcsr20": sssp_planes["weights 1..63"][0],
                     "grid": csr1024, "mst_u": canon[0], "mst_v": canon[1],
                     "mst_w": canon[2]}, par_refs, card)

    for name, count in {**launches, **by_path, **chain_counts,
                        **touch_counts, **spmv_counts, **mega_counts,
                        **preds_counts}.items():
        if count <= 0:
            raise AssertionError(f"kernel or path {name} had no launch on "
                                 "the main path")
    line = [dict(
        name="mega_step", **KERNELS["mega_step"],
        launches=launches["mega_step"], max_abs_err=max_err,
        ms=sum(r["ms"] for r in timing),
        plain_ms=sum(r["plain_ms"] for r in timing),
        bound_ms=sum(r["bound_ms"] for r in timing),
        bound_by=("bytes" if sum(r["bytes"] for r in timing)
                  / HBM_BYTES_PER_S >= sum(r["ops"] for r in timing)
                  / OPS_PER_S else "operations"),
        library_ms=None, matches_plain=True,
        work="all levels of one rmat-s20 search from the top-degree "
             "vertex, run as the main path runs it",
        directions=[r["direction"] for r in timing],
        ms_by_search=step_times, launches_by_path=mega_counts)]
    pr_row = next(r for r in value_rows if r["name"] == "pr")
    line.append(dict(
        name="value_step", **KERNELS["value_step"],
        launches=launches["value_step"], max_abs_err=value_err,
        ms=pr_row["ms"], plain_ms=pr_row["plain_ms"],
        bound_ms=pr_row["bound_ms"],
        bound_by=("bytes" if pr_row["bytes"] / HBM_BYTES_PER_S
                  >= pr_row["ops"] / OPS_PER_S else "operations"),
        library_ms=pr_row["library_ms"], matches_plain=True,
        work="one rmat-s20 sweep of the pr configuration; configs lists "
             "one sweep of each configuration",
        configs=[{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                                    "library_ms")} for r in value_rows],
        launches_by_path=by_path, launches_by_route=by_route,
        routes=route_rows,
        replays={p: {k: {t: v[t] for t in ("taken_ms", "dense_ms",
                                            "best_ms")}
                     for k, v in r.items()} for p, r in replays.items()},
        ms_by_long_degree=sweep))
    line.append(dict(
        name="chain_bfs", **KERNELS["chain_bfs"],
        launches=launches["chain_bfs"], max_abs_err=chain_err,
        ms=chain_row["ms"], plain_ms=chain_row["plain_ms"],
        bound_ms=chain_row["bound_ms"],
        bound_by=("bytes" if chain_row["bytes"] / HBM_BYTES_PER_S
                  >= chain_row["ops"] / OPS_PER_S else "operations"),
        library_ms=None, matches_plain=True,
        work=f"one whole search of grid-1024^2 from the top-degree vertex "
             f"({chain_row['depth']} levels)",
        step_full_ms=chain_row["step_full_ms"],
        old_route_ms=chain_row["old_route_ms"],
        layout=chain_row["layout"],
        global_map_ms=chain_row["global_map_ms"],
        launches_by_path=chain_counts))
    line.append(dict(
        name="touch_sweep", **KERNELS["touch_sweep"],
        launches=launches["touch_sweep"], max_abs_err=touch_err,
        ms=touch_row["ms"], plain_ms=touch_row["plain_ms"],
        bound_ms=touch_row["bound_ms"],
        bound_by=("bytes" if touch_row["bytes"] / HBM_BYTES_PER_S
                  >= touch_row["ops"] / OPS_PER_S else "operations"),
        library_ms=touch_row["library_ms"], matches_plain=True,
        work=f"one rmat-s20 sweep from the {touch_row['frontier']} "
             f"level-2 vertices of the top-degree search",
        fused_ms=touch_row["fused_ms"],
        fused_bound_ms=touch_row["fused_bound_ms"],
        launches_by_path=touch_counts))
    line.append(dict(
        name="spmv", **KERNELS["spmv"],
        launches=launches["spmv"], max_abs_err=spmv_err,
        ms=spmv_row["ms"], plain_ms=spmv_row["plain_ms"],
        bound_ms=spmv_row["bound_ms"],
        bound_by=("bytes" if spmv_row["bytes"] / HBM_BYTES_PER_S
                  >= spmv_row["ops"] / OPS_PER_S else "operations"),
        library_ms=spmv_row["library_ms"], matches_plain=True,
        work="one sweep of a seeded contrib over the unrelabeled CSC of "
             "rmat-s20 undirected",
        launches_by_path=spmv_counts,
        launches_by_route={"pr pallas": by_route["pr pallas"]}))
    line.append(preds_row)
    line.append(decode_kernel_row)
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
