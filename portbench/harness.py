"""One run of one cell: make the graph, hand it to the program, warm up,
drive queries in a closed loop for the window, then check a sample of
the window's answers against the reference.

Everything a metric may read ends in a `Record`; each metric is a
reader `metrics/<name>.py::read(record)` found by the metric's name in
`BENCHMARK.json`.  A reader that finds nothing to read returns None
and the metric is left out of the result.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import resource
import statistics
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import devtrace
from portbench.graphs._csr import BenchGraph
from portbench.work import teps

PKG = Path(__file__).resolve().parent
CHECKOUT = PKG.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gunrockinst_tpu"})


def forbidden_modules(names) -> List[str]:
    """The names of FORBIDDEN among the top-level names (the part
    before the first dot, compared whole) of module names `names`."""
    return sorted({str(k).split(".")[0] for k in names} & FORBIDDEN)


def bench_spec() -> dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict


def load_cell(name: str, spec: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration file and
    its traffic file (`traffic/<traffic>.json`)."""
    spec = spec or bench_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return Cell(name=name, chips=int(cell["chips"]),
                config=json.loads((CHECKOUT / config["file"]).read_text()),
                traffic=json.loads((PKG / "traffic" /
                                    f"{cell['traffic']}.json").read_text()))


def metrics_for(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The entries of the metrics a run of `cell` reports: its end-to-end
    metrics, or with `trace` its per-layer ones."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def reader(name: str):
    """`metrics/<name>.py`, loaded from its path (names hold dots)."""
    path = PKG / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Query:
    root: int
    wall_s: float
    elapsed_ms: float       # the program's own span (Stats.elapsed_ms)
    depth: int              # levels or rounds (Stats.search_depth)
    edges: int              # simple undirected edges of the root's component
    error: Optional[str] = None


@dataclasses.dataclass
class Checked:
    index: int              # into Record.queries
    root: int
    checks: Dict[str, int]
    bytes: int              # work/<primitive>.py, from the reference


@dataclasses.dataclass
class Record:
    """What one run measured: read by the metric readers."""

    cell: str
    primitive: str
    device_kind: str
    setup: Dict[str, float]
    window_s: float
    queries: List[Query]
    checked: List[Checked]
    limits: Dict[str, int]
    trace: Optional[devtrace.Summary]
    hbm_bytes_per_s: Optional[float]
    memory_peak_bytes: int

    @property
    def failed(self) -> int:
        return sum(q.error is not None for q in self.queries)

    @property
    def served(self) -> List[Query]:
        return [q for q in self.queries if q.error is None]

    def check_totals(self) -> Dict[str, int]:
        totals = {k: 0 for k in self.limits}
        for c in self.checked:
            for k, v in c.checks.items():
                totals[k] += v
        return totals

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checked)
                and all(v <= self.limits[k]
                        for k, v in self.check_totals().items()))

    def roofline_pct(self, primitive: str) -> Optional[float]:
        """The checked queries' least time on the card (their bytes at
        the HBM peak) over their summed device time in the trace."""
        tr = self.trace
        if (primitive != self.primitive or tr is None
                or self.hbm_bytes_per_s is None
                or len(tr.query_device_s) != len(self.queries)):
            return None
        least = sum(c.bytes for c in self.checked) / self.hbm_bytes_per_s
        spent = sum(tr.query_device_s[c.index] for c in self.checked)
        return 100.0 * least / spent if spent > 0 and least > 0 else None


def peak_bandwidth(kind: str) -> Optional[float]:
    peaks = json.loads((PKG / "peaks.json").read_text())
    entry = peaks.get(kind)
    return None if entry is None else float(entry["hbm_bytes_per_s"])


def seed_key(seed: int) -> int:
    """The seed as the unsigned 64-bit number both generators take."""
    return int(seed) % (1 << 64)


def draw_roots(graph: BenchGraph, seed: int, warmup: int):
    """(window roots, warm-up roots): one permutation of the vertices of
    degree >= 1 drawn from the seed; the window takes it from the front,
    the warm-up from the back, so no root repeats and the window meets
    no root the warm-up searched."""
    live = np.flatnonzero(graph.degrees().numpy() > 0)
    order = np.random.default_rng([seed_key(seed), 1]).permutation(live)
    if order.shape[0] <= warmup:
        raise ValueError(f"{order.shape[0]} vertices of degree >= 1 "
                         f"leave no root after {warmup} warm-up roots")
    return order[: order.shape[0] - warmup], order[::-1][:warmup]


class Reservoir:
    """A uniform sample of k of the window's answers, drawn from the
    seed, whatever the number of queries (algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed_key(seed), 2])
        self.items: Dict[int, tuple] = {}
        self.seen = 0

    def offer(self, item: tuple) -> None:
        if self.seen < self.k:
            self.items[self.seen] = item
        else:
            slot = int(self.rng.integers(0, self.seen + 1))
            if slot < self.k:
                self.items[slot] = item
        self.seen += 1


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell: Cell, seed: int, seconds: float, device="cuda",
             t_start: Optional[float] = None, log=print) -> Record:
    """One run of `cell`.  `t_start` is the process's start on the
    perf_counter clock (set-up is counted from it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    primitive = cell.traffic["primitive"]
    adaptor = importlib.import_module(f"portbench.queries.{primitive}")
    graph, csr, roots, edges_of, setup = _set_up(cell, seed, dev, adaptor,
                                                 t_start, log)
    queries, sample, summary, window_s = _window(
        csr, roots, edges_of, cell.traffic, seed, seconds, dev, adaptor,
        log)
    peak = (int(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else 0)
    # the program's state goes before the reference runs
    del csr
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = importlib.import_module(f"portbench.reference.{primitive}")
    checked = _check(graph, sample, ref, primitive, dev, log)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return Record(cell=cell.name, primitive=primitive, device_kind=kind,
                  setup=setup, window_s=window_s, queries=queries,
                  checked=checked, limits=dict(ref.LIMITS), trace=summary,
                  hbm_bytes_per_s=peak_bandwidth(kind),
                  memory_peak_bytes=peak)


def _set_up(cell, seed, dev, adaptor, t_start, log):
    """CUDA init, the graph made from the seed, the roots, the count of
    traversed edges of each root, the program's first call and the warm-up:
    (graph, csr, roots, edges_of, setup seconds by phase)."""
    from gunrockinst_tpu_torch.graph.csr import CsrGraph
    now = time.perf_counter
    torch.zeros(1, device=dev)
    _sync(dev)
    t_init = now()
    generator = importlib.import_module(
        f"portbench.graphs.{cell.config['generator']}")
    graph = generator.make(cell.config, seed_key(seed), dev)
    edges_of = teps.edges_per_vertex(graph.to(dev))
    roots, warm = draw_roots(graph, seed,
                             int(cell.traffic["warmup_queries"]))
    ro, ci, ev = graph.port_arrays(adaptor.WEIGHTED)
    csr = CsrGraph(row_offsets=ro, col_indices=ci, edge_values=ev)
    _sync(dev)
    if dev.type == "cuda":
        # the peak is the program's: the benchmark's own graph is gone
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t_graph = now()
    args = cell.traffic["call"]
    adaptor.call(csr, int(warm[0]), args, dev)
    t_first = now()
    for root in warm[1:]:
        adaptor.call(csr, int(root), args, dev)
    t_warm = now()
    setup = {"cuda_init_s": t_init - t_start, "graph_s": t_graph - t_init,
             "first_call_s": t_first - t_graph, "warmup_s": t_warm - t_first,
             "setup_s": t_warm - t_start}
    log("setup " + " ".join(f"{k}={v:.6f}" for k, v in setup.items())
        + f" n={graph.n} m={graph.m} roots={roots.shape[0]}")
    return graph, csr, roots, edges_of, setup


def _window(csr, roots, edges_of, traffic, seed, seconds, dev, adaptor,
            log):
    """One caller, closed loop, a fresh root a query, until `seconds`
    have passed, under the profiler, with Python's collector off and the
    caller's thread pinned to one core: (queries, sampled answers, trace
    summary, seconds from the first query's start to the last one's
    end)."""
    args = traffic["call"]
    sample = Reservoir(int(traffic["checked_queries"]), seed)
    gc.collect()
    gc.disable()
    cores = _pin_this_thread()
    try:
        return _closed_loop(csr, roots, edges_of, args, sample, seconds,
                            dev, adaptor, log)
    finally:
        gc.enable()
        if cores is not None:
            os.sched_setaffinity(0, cores)


def _pin_this_thread():
    """Pin the calling thread, which runs every query's host work, to
    one fixed core (the highest it may use) for the window, so that no
    run's host work migrates between cores: the cores to restore, or
    None where the system cannot pin."""
    if not hasattr(os, "sched_setaffinity"):
        return None
    cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(cores)})
    return cores


def _closed_loop(csr, roots, edges_of, args, sample, seconds, dev,
                 adaptor, log):
    now = time.perf_counter
    queries: List[Query] = []
    # traced in every run: the card's busy time is an end-to-end reading
    # (`card_gteps`), so both modes do the same work in the window
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    cpu0 = resource.getrusage(resource.RUSAGE_SELF)
    w0 = now()
    w1 = w0
    for root in roots:
        if w1 - w0 >= seconds:
            break
        root = int(root)
        answer, error, stats = None, None, None
        q0 = now()
        try:
            with torch.profiler.record_function(devtrace.QUERY):
                answer, stats = adaptor.call(csr, root, args, dev)
        except Exception as exc:   # a query that fails counts, and goes on
            error = f"{type(exc).__name__}: {exc}"
        w1 = now()
        queries.append(Query(
            root=root, wall_s=w1 - q0,
            elapsed_ms=float(stats.elapsed_ms) if stats else float("nan"),
            depth=int(stats.search_depth) if stats else 0,
            edges=int(edges_of[root]), error=error))
        sample.offer((len(queries) - 1, root, answer))
        del answer
    cpu1 = resource.getrusage(resource.RUSAGE_SELF)
    prof.__exit__(None, None, None)
    summary = devtrace.summarize(prof)
    failed = [q.error for q in queries if q.error is not None]
    log(f"window {w1 - w0:.6f} s, {len(queries)} queries, "
        f"core {sorted(os.sched_getaffinity(0))}, "
        f"{len(failed)} failed" + (f"; last error: {failed[-1]}"
                                   if failed else ""))
    if queries:
        walls = np.percentile([q.wall_s * 1e3 for q in queries],
                              [5, 25, 50, 75, 95])
        log("query wall_ms p5/p25/p50/p75/p95 "
            + " ".join(f"{v:.3f}" for v in walls)
            + f"; span_ms p50 "
            f"{np.nanmedian([q.elapsed_ms for q in queries]):.3f}"
            f"; host cpu {cpu1.ru_utime - cpu0.ru_utime:.3f} s user, "
            f"{cpu1.ru_stime - cpu0.ru_stime:.3f} s sys")
    return queries, sample, summary, w1 - w0


def _check(graph, sample, ref, primitive, dev, log) -> List[Checked]:
    """The sampled answers against the reference, on the benchmark's own
    graph uploaded again, with each query's bytes from `work/`."""
    t0 = time.perf_counter()
    work = importlib.import_module(f"portbench.work.{primitive}")
    on_dev = graph.to(dev)
    checked = []
    for index, root, answer in sorted(sample.items.values(),
                                      key=lambda it: it[0]):
        if answer is None:
            continue
        expected = ref.solve(on_dev, root)
        checked.append(Checked(index=index, root=root,
                               checks=ref.compare(answer, expected),
                               bytes=work.bytes_of(on_dev, expected)))
        del expected
    log(f"check {len(checked)} answers in {time.perf_counter() - t0:.3f} s")
    return checked


def median(values) -> Optional[float]:
    values = list(values)
    return statistics.median(values) if values else None
