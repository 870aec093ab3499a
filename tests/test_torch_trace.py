"""The port's spans and counters (`gunrockinst_tpu_torch/utils/trace.py`)
and the benchmark's readers of them (`portbench/metrics/`), on the CPU:
the span tree and its bounds, the off switch, the profiler's clock, the
entry points' phases, and each reader on a made-up run."""

import itertools
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gunrockinst_tpu_torch.graph.rmat import rmat_graph
from gunrockinst_tpu_torch.primitives import bfs, sssp
from gunrockinst_tpu_torch.utils import trace
from portbench import devtrace, harness

PHASES = ["gt.entry.check", "gt.entry.warmup", "gt.entry.search",
          "gt.entry.extract", "gt.entry.preds", "gt.entry.stats"]


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.set_enabled(True)
    trace.clear()
    trace.reset_totals()
    yield
    trace.set_enabled(True)
    trace.clear()


@pytest.fixture(scope="module")
def graph():
    return rmat_graph(9, 8, undirected=True, seed=5, with_values=True)


def _spin(ns):
    t = torch.zeros(1)
    end = time.perf_counter_ns() + ns
    while time.perf_counter_ns() < end:
        t += 1


def test_span_tree_parents_counts_and_self_time():
    with trace.call("gt.bfs.run", "bfs", 7) as root:
        trace.count("host_read")
        with trace.span("gt.entry.search") as search:
            _spin(2_000_000)
            with trace.span("gt.driver.level"):
                trace.count("launch.mega_step", 2)
                trace.count("host_read")
        root.set_route("step8")
    rec = trace.calls()[-1]
    assert rec.primitive == "bfs" and rec.src == 7 and rec.route == "step8"
    assert [s.name for s in rec.spans] == ["gt.bfs.run", "gt.entry.search",
                                           "gt.driver.level"]
    level = rec.spans[2]
    assert rec.root is root and root.parent == 0
    assert search.parent == root.id and level.parent == search.id
    assert root.counts == {"host_read": 1}
    assert search.counts == {}
    assert level.counts == {"launch.mega_step": 2, "host_read": 1}
    assert trace.totals() == {"host_read": 2, "launch.mega_step": 2}
    assert search.elapsed_ms >= 2.0
    assert rec.self_ms(search) == pytest.approx(
        search.elapsed_ms - level.elapsed_ms)
    assert 0 <= rec.self_ms(root) < root.elapsed_ms
    assert root.start_ns <= search.start_ns <= level.start_ns
    assert level.end_ns <= search.end_ns <= root.end_ns
    assert root.sys_s >= 0 and root.minflt >= 0


def test_a_nested_entry_is_a_child_span_and_threads_keep_their_stacks():
    barrier = threading.Barrier(2, timeout=30)

    def worker(src):
        with trace.call("gt.sssp.run", "sssp", src):
            barrier.wait()
            with trace.span("gt.entry.search"):
                trace.count("host_read", src)
                barrier.wait()
            with trace.call("gt.bfs.run", "bfs", src + 100):
                trace.count("host_read")

    threads = [threading.Thread(target=worker, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    recs = {r.src: r for r in trace.calls()}
    assert set(recs) == {1, 2}      # the nested bfs.run opened no record
    for src, rec in recs.items():
        root, search, inner = rec.spans
        assert [s.name for s in rec.spans] == ["gt.sssp.run",
                                               "gt.entry.search",
                                               "gt.bfs.run"]
        assert search.parent == root.id and inner.parent == root.id
        assert search.counts == {"host_read": src}
        assert inner.counts == {"host_read": 1} and inner.record is None
    assert trace.totals()["host_read"] == 1 + 2 + 2


def test_calls_keep_the_last_1024_and_setup_spans_outlive_them():
    with trace.call("gt.bfs.run", "bfs", 0):
        with trace.span("gt.setup.relabel"):
            pass
    for src in range(1, trace.CALLS + 6):
        with trace.call("gt.bfs.run", "bfs", src):
            pass
    held = trace.calls()
    assert len(held) == trace.CALLS
    assert [c.src for c in held] == list(range(6, trace.CALLS + 6))
    assert [s.name for s in trace.setup_spans()] == ["gt.setup.relabel"]
    for _ in range(trace.SETUP + 3):
        with trace.span("gt.setup.transpose"):
            pass
    assert len(trace.setup_spans()) == trace.SETUP
    assert trace.setup_spans()[0].name == "gt.setup.transpose"


def test_a_call_records_a_bounded_number_of_spans():
    with trace.call("gt.bfs.run", "bfs", 3):
        with trace.span("gt.entry.search") as search:
            for _ in range(trace.SPANS_PER_CALL + 10):
                with trace.span("gt.driver.level"):
                    trace.count("host_read")
    rec = trace.calls()[-1]
    assert len(rec.spans) == trace.SPANS_PER_CALL
    assert rec.dropped == 12
    # the levels past the bound count into the innermost recorded span
    recorded = sum(s.counts.get("host_read", 0) for s in rec.spans)
    assert recorded == trace.SPANS_PER_CALL + 10
    assert search.counts == {"host_read": 12}


def test_disabled_records_nothing_and_enters_no_record_function():
    trace.set_enabled(False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.call("gt.bfs.run", "bfs", 1) as root:
            with trace.span("gt.entry.search") as s:
                trace.count("host_read")
                _spin(1_000_000)
    assert trace.calls() == [] and trace.totals() == {}
    assert trace.setup_spans() == []
    assert root.record is None and s.elapsed_ms >= 1.0
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not any(n.startswith("gt.") for n in names)


def test_span_start_lands_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.call("gt.bfs.run", "bfs", 2):
            with trace.span("gt.entry.search"):
                _spin(500_000)
            with trace.span("gt.entry.extract"):
                pass
    rec = trace.calls()[-1]
    starts = {e.name(): e.start_ns()
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("gt.")}
    assert set(starts) == {s.name for s in rec.spans}
    for s in rec.spans:
        assert abs(s.start_ns + rec.clock_offset_ns - starts[s.name]) < 1e6


def _phases(rec):
    root = rec.root
    return [s.name for s in rec.spans
            if s.parent == root.id and s.name in PHASES]


def _levels_and_reads(rec):
    search = [s for s in rec.spans if s.parent == rec.root.id
              and s.name == "gt.entry.search"][0]
    inside, reads, levels = {search.id}, 0, 0
    for s in rec.spans:
        if s.id == search.id or s.parent in inside:
            inside.add(s.id)
            reads += s.counts.get("host_read", 0)
            levels += s.name in ("gt.driver.level", "gt.driver.round")
    return levels, reads


@pytest.mark.parametrize("primitive", ["bfs", "sssp"])
def test_entry_calls_carry_their_phases_and_answers_do_not_change(
        graph, primitive):
    src = int(np.argmax(graph.degrees))
    if primitive == "bfs":
        def go():
            res = bfs.run(graph, src, traversal_mode="auto", device="cpu")
            return res.labels, res.preds, res.stats
    else:
        def go():
            res = sssp.run(graph, src, mode="planes", device="cpu")
            return res.dist, res.preds, res.stats
    got = go()
    rec = trace.calls()[-1]
    assert rec.primitive == primitive and rec.src == src
    assert rec.root.name == f"gt.{primitive}.run"
    assert rec.route == ("step8" if primitive == "bfs" else "planes")
    assert _phases(rec) == PHASES
    levels, reads = _levels_and_reads(rec)
    assert levels >= got[2].search_depth > 0
    assert reads >= levels
    assert all(s.end_ns >= s.start_ns for s in rec.spans)
    copies = sum(s.counts.get("copy.d2h_bytes", 0) for s in rec.spans)
    assert copies >= got[0].nbytes + got[1].nbytes
    trace.set_enabled(False)
    again = go()
    assert len(trace.calls()) == 1
    for a, b in zip(got[:2], again[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert got[2].search_depth == again[2].search_depth


# ---- the readers ----------------------------------------------------------

_IDS = itertools.count(1)


def _span(rec_spans, name, parent, start_ms, end_ms, counts=None, sys_s=0.0):
    s = trace.Span(name)
    s.id = next(_IDS)
    s.parent = parent.id if parent is not None else 0
    s.start_ns, s.end_ns = int(start_ms * 1e6), int(end_ms * 1e6)
    s.counts = dict(counts or {})
    s.sys_s = sys_s
    rec_spans.append(s)
    return s


def _call(src, scale, primitive="bfs"):
    """A made-up call of `primitive` from `src`: every phase `scale` ms
    long (the warm-up twice), 3 levels of one read and one launch each,
    `scale` MB each way, `scale` s of system time."""
    c = trace.Call(primitive, src)
    sp = c.spans
    root = _span(sp, f"gt.{primitive}.run", None, 0, 10 * scale,
                 sys_s=scale / 1e3)
    _span(sp, "gt.entry.check", root, 0, scale)
    warm = _span(sp, "gt.entry.warmup", root, scale, 3 * scale)
    _span(sp, "gt.entry.reach", warm, scale, 1.5 * scale,
          {"copy.h2d_bytes": scale * 500_000})
    _span(sp, "gt.entry.search", warm, 1.5 * scale, 2.5 * scale)
    _span(sp, "gt.entry.extract", warm, 2.5 * scale, 3 * scale)
    search = _span(sp, "gt.entry.search", root, 3 * scale, 4 * scale,
                   {"host_read": 1})
    for k in range(3):
        _span(sp, "gt.driver.level", search, 3 * scale, 3 * scale,
              {"host_read": 1, "launch.mega_step": 1})
    _span(sp, "gt.entry.extract", root, 4 * scale, 5 * scale,
          {"copy.d2h_bytes": scale * 1_000_000})
    _span(sp, "gt.entry.preds", root, 5 * scale, 6 * scale,
          {"copy.h2d_bytes": scale * 500_000})
    _span(sp, "gt.entry.stats", root, 6 * scale, 7 * scale)
    return c


def _record(roots, depth=4):
    queries = [harness.Query(root=r, wall_s=0.01, elapsed_ms=1.0,
                             depth=depth, edges=10) for r in roots]
    summary = devtrace.Summary(
        window_s=10.0, busy_s=2.0, query_device_s=[0.1] * len(roots),
        device_ops=[], idle_gaps=[("gt.entry.extract", 4.0),
                                  ("gt.bfs.run", 2.0),
                                  ("host code after aten::copy_", 1.5),
                                  ("aten::nonzero", 0.5)])
    return harness.Record(
        cell="kron21-bfs", primitive="bfs", device_kind="cpu", setup={},
        window_s=10.0, queries=queries, checked=[], limits={},
        trace=summary, hbm_bytes_per_s=None, memory_peak_bytes=0)


def _setup_span(spans, name, parent, ms):
    return _span(spans, name, parent, 0, ms)


@pytest.fixture
def made_up(monkeypatch):
    """The window served roots 11, 12, 13; the held records are a
    warm-up call (root 99), 11, a failed or foreign call (root 50), 12,
    a late repeat of 11 that must not match, and 13."""
    calls = [_call(99, 100.0), _call(11, 1.0), _call(50, 100.0),
             _call(12, 2.0), _call(11, 100.0), _call(13, 3.0),
             _call(12, 100.0, primitive="sssp")]
    setup = []
    sym = _setup_span(setup, "gt.setup.symmetry", None, 900)
    _setup_span(setup, "gt.setup.transpose", sym, 500)
    outer = _setup_span(setup, "gt.setup.transpose", None, 700)
    _setup_span(setup, "gt.setup.transpose", outer, 300)   # nested: once
    _setup_span(setup, "gt.setup.relabel", None, 1500)
    _setup_span(setup, "gt.setup.relabel", None, 500)
    _setup_span(setup, "gt.setup.kernel_load", None, 2500)
    monkeypatch.setattr(trace, "calls", lambda: list(calls))
    monkeypatch.setattr(trace, "setup_spans", lambda: list(setup))
    return _record([11, 12, 13])


def test_window_calls_match_served_roots_in_order(made_up):
    from portbench.queries import spans
    matched = spans.window_calls(made_up)
    assert [(q.root, c.src) for q, c in matched] == [(11, 11), (12, 12),
                                                      (13, 13)]
    assert [c.root.elapsed_ms for _, c in matched] == [10.0, 20.0, 30.0]


@pytest.mark.parametrize("metric,want", [
    ("entry.warmup_ms", 4.0),           # 2 * scale, median scale 2
    ("entry.extract_ms", 2.0),          # the root's own, not the warm-up's
    ("entry.preds_ms", 2.0),
    ("entry.scans_ms", 5.0),            # check 2 + reach 1 + stats 2
    ("entry.sys_ms", 2.0),
    ("entry.copy_mb", 4.0),             # 1 + 2 + 1 MB a unit of scale
    ("driver.host_reads_per_level", 1.0),   # 4 reads, depth 4
    ("driver.launches_per_level", 0.75),    # 3 launches, depth 4
    ("host_setup.relabel_s", 2.0),
    ("host_setup.transpose_s", 1.2),    # 0.5 + 0.7, the nested 0.3 left out
    ("host_setup.components_s", 0.0),   # none ran
    ("host_setup.kernel_load_s", 2.5),
    ("device.idle_unattributed_pct", 25.0),  # (8 - 4 - 2) / 8
])
def test_each_reader_on_a_made_up_run(made_up, metric, want):
    assert harness.reader(metric)(made_up) == pytest.approx(want)


def test_readers_say_nothing_without_calls_or_a_card(monkeypatch):
    rec = _record([11, 12])
    monkeypatch.setattr(trace, "calls", lambda: [])
    for metric in ("entry.warmup_ms", "entry.extract_ms", "entry.preds_ms",
                   "entry.scans_ms", "entry.sys_ms", "entry.copy_mb",
                   "driver.host_reads_per_level",
                   "driver.launches_per_level"):
        assert harness.reader(metric)(rec) is None
    rec.trace.busy_s = 0.0
    assert harness.reader("device.idle_unattributed_pct")(rec) is None
