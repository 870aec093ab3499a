"""GAP's uniform random graph (`portbench/graphs/uniform.py`) on the
port's BFS path, on the CPU: the generator, `bfs.run(traversal_mode=
"auto", mark_preds=True)` against the benchmark's plain reference on a
graph large enough to reach the relabel's depth probe (scale 17), the
relabel's order counter and probe span, the per-level direction
counters, and the two readers of them in `portbench/metrics/`."""

import numpy as np
import pytest
import torch

from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.ops.mega import MegaStepper
from gunrockinst_tpu_torch.primitives import bfs
from gunrockinst_tpu_torch.utils import trace
from portbench import devtrace, harness
from portbench.graphs import uniform
from portbench.reference import bfs as ref_bfs

SMALL = {"scale": 10, "degree": 16}
PROBED = {"scale": 17, "degree": 16}    # n = 2 * 65536: the probe runs
SEED = 2**31 + 77
ROOTS = 3


def _edges(g):
    src = np.repeat(np.arange(g.n), np.diff(g.offsets.numpy()))
    return src, g.cols.numpy().astype(np.int64)


def test_uniform_tuples_simple_symmetric_and_seeded(monkeypatch):
    seen = {}
    real = uniform.undirected_csr

    def spy(n, u, v, w):
        seen.update(n=n, m=u.shape[0], lo=int(min(u.min(), v.min())),
                    hi=int(max(u.max(), v.max())), w=w)
        return real(n, u, v, w)

    monkeypatch.setattr(uniform, "undirected_csr", spy)
    g = uniform.make(SMALL, SEED, "cpu")
    n = 1 << SMALL["scale"]
    assert seen["n"] == n and seen["m"] == SMALL["degree"] * n
    assert seen["lo"] >= 0 and seen["hi"] < n and seen["w"] is None
    assert g.n == n and g.weights is None
    src, dst = _edges(g)
    assert not np.any(src == dst)                # no self-loop
    key = src * n + dst
    assert np.all(np.diff(key) > 0)              # sorted rows, no duplicate
    assert np.array_equal(np.sort(dst * n + src), key)   # both ways
    # every tuple that is no self-loop is stored both ways, once
    assert g.m <= 2 * seen["m"]

    again = uniform.make(SMALL, SEED, "cpu")
    other = uniform.make(SMALL, SEED + 1, "cpu")
    assert torch.equal(g.offsets, again.offsets)
    assert torch.equal(g.cols, again.cols)
    assert not (g.m == other.m and torch.equal(g.cols, other.cols))


@pytest.fixture(scope="module")
def searched():
    """Scale-17 Urand searched from ROOTS roots of degree >= 1 as the
    benchmark's cell calls it, with the trace's records and the order
    each step took (`last_direction()` after every level)."""
    g = uniform.make(PROBED, SEED, "cpu")
    ro, ci, _ = g.port_arrays(False)
    csr = CsrGraph(row_offsets=ro, col_indices=ci)
    live = np.flatnonzero(g.degrees().numpy() > 0)
    roots = live[np.linspace(0, live.shape[0] - 1, ROOTS).astype(int)]
    taken = []
    real_step = MegaStepper.step

    def step(self, *args, **kw):
        out = real_step(self, *args, **kw)
        taken.append(self.last_direction())
        return out

    trace.set_enabled(True)
    trace.clear()
    trace.reset_totals()
    MegaStepper.step = step
    try:
        results = []
        for root in roots:
            before = len(taken)
            res = bfs.run(csr, int(root), traversal_mode="auto",
                          mark_preds=True, device="cpu")
            results.append((int(root), res, taken[before:]))
    finally:
        MegaStepper.step = real_step
    out = dict(graph=g, csr=csr, results=results, calls=trace.calls(),
               setup=trace.setup_spans(), totals=trace.totals())
    trace.clear()
    trace.reset_totals()
    return out


def test_bfs_matches_the_reference_bit_for_bit(searched):
    on = searched["graph"].to("cpu")
    for root, res, _ in searched["results"]:
        assert res.stats.route == "step8"
        assert res.labels.dtype == np.int32 and res.preds.dtype == np.int32
        got = {"labels": res.labels, "preds": res.preds}
        assert ref_bfs.compare(got, ref_bfs.solve(on, root)) == {
            "label_mismatch": 0, "pred_mismatch": 0}


def test_unrelabeled_with_probe_span_and_order_count(searched):
    from gunrockinst_tpu_torch.primitives.search_graph import search_graph
    g = search_graph(searched["csr"], torch.device("cpu"))
    assert g.perm is None and g.csr_p is searched["csr"]
    totals = searched["totals"]
    assert totals.get("relabel.none") == 1
    assert "relabel.degree" not in totals and "relabel.breadth" not in totals
    setup = searched["setup"]
    relabel = [s for s in setup if s.name == "gt.setup.relabel"]
    probe = [s for s in setup if s.name == "gt.setup.depth_probe"]
    assert len(relabel) == 1 and len(probe) == 1
    assert probe[0].parent == relabel[0].id
    assert relabel[0].counts == {"relabel.none": 1}
    assert relabel[0].start_ns <= probe[0].start_ns <= probe[0].end_ns \
        <= relabel[0].end_ns


def test_each_level_counts_the_direction_it_took(searched):
    calls = searched["calls"]
    assert len(calls) == len(searched["results"])
    for call, (root, res, taken) in zip(calls, searched["results"]):
        assert call.src == root
        levels = [s for s in call.spans if s.name == "gt.driver.level"]
        ways = []
        for s in levels:
            dirs = {k: v for k, v in s.counts.items()
                    if k.startswith("level.")}
            assert len(dirs) == 1 and list(dirs.values()) == [1], dirs
            ways.append(next(iter(dirs))[len("level."):])
        assert ways == taken       # the warm-up's search, then the timed
        search = [s for s in call.spans if s.name == "gt.entry.search"
                  and s.parent == call.root.id]
        assert len(search) == 1
        timed = [s for s in levels if s.parent == search[0].id]
        # the levels run count the last, empty one
        assert len(timed) == res.stats.search_depth + 1
        pulls = sum(s.counts.get("level.pull", 0) for s in timed)
        pushes = sum(s.counts.get("level.push", 0) for s in timed)
        assert pulls + pushes == len(timed)
        assert pulls >= 1 and pushes >= 1
        assert all(s.counts.get("host_read") == 1 for s in timed)


def _record(roots, depth=5):
    queries = [harness.Query(root=r, wall_s=0.01, elapsed_ms=1.0,
                             depth=depth, edges=10) for r in roots]
    summary = devtrace.Summary(window_s=10.0, busy_s=2.0,
                               query_device_s=[0.1] * len(roots),
                               device_ops=[], idle_gaps=[])
    return harness.Record(
        cell="urand21-bfs", primitive="bfs", device_kind="cpu", setup={},
        window_s=10.0, queries=queries, checked=[], limits={},
        trace=summary, hbm_bytes_per_s=None, memory_peak_bytes=0)


def test_readers_on_the_searched_records(searched, monkeypatch):
    monkeypatch.setattr(trace, "calls", lambda: list(searched["calls"]))
    monkeypatch.setattr(trace, "setup_spans",
                        lambda: list(searched["setup"]))
    rec = _record([root for root, _, _ in searched["results"]])
    probe = [s for s in searched["setup"]
             if s.name == "gt.setup.depth_probe"][0]
    assert harness.reader("host_setup.depth_probe_s")(rec) == \
        pytest.approx(probe.elapsed_ms / 1e3)
    want = []
    for call in searched["calls"]:
        search = [s for s in call.spans if s.name == "gt.entry.search"
                  and s.parent == call.root.id][0]
        pulls = [s.elapsed_ms for s in call.spans
                 if s.parent == search.id and s.counts.get("level.pull")]
        want.append(sum(pulls) / len(pulls))
    assert harness.reader("driver.pull_level_ms")(rec) == pytest.approx(
        float(np.median(want)))


def test_readers_say_nothing_without_the_span_or_the_counters(
        searched, monkeypatch):
    rec = _record([root for root, _, _ in searched["results"]])
    # the same calls as a program without the direction counters: no
    # level names its order
    bare = []
    for call in searched["calls"]:
        copy = trace.Call(call.primitive, call.src)
        for s in call.spans:
            t = trace.Span(s.name)
            t.id, t.parent = s.id, s.parent
            t.start_ns, t.end_ns = s.start_ns, s.end_ns
            t.counts = {k: v for k, v in s.counts.items()
                        if not k.startswith("level.")}
            copy.spans.append(t)
        bare.append(copy)
    no_probe = [s for s in searched["setup"]
                if s.name != "gt.setup.depth_probe"]
    monkeypatch.setattr(trace, "calls", lambda: bare)
    monkeypatch.setattr(trace, "setup_spans", lambda: no_probe)
    assert no_probe and bare
    assert harness.reader("host_setup.depth_probe_s")(rec) is None
    assert harness.reader("driver.pull_level_ms")(rec) is None
    monkeypatch.setattr(trace, "calls", lambda: [])
    monkeypatch.setattr(trace, "setup_spans", lambda: [])
    assert harness.reader("host_setup.depth_probe_s")(rec) is None
    assert harness.reader("driver.pull_level_ms")(rec) is None
