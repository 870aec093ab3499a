"""The kernel routes of `bfs.run` and `sssp.run` warm up once per cached
search object (`primitives/base.py::warm_search`), on the CPU (the
kernels' plain versions): one warm-up search on an object's first call
and on a route switch, none after; every answer equal to the NumPy
oracle's and to a fresh graph object's first call, traced or not."""

import dataclasses

import numpy as np
import pytest

from gunrockinst_tpu_torch.graph.coo import CooGraph
from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.graph.rmat import rmat_graph
from gunrockinst_tpu_torch.oracles import bfs_reference, sssp_reference
from gunrockinst_tpu_torch.primitives import bfs, bfs_pallas, sssp
from gunrockinst_tpu_torch.utils import trace

ROOTS = 4
STAR = 20       # the route-switch graph: a star of STAR vertices,
PATH = 300      # and apart from it a path deeper than the 8 planes


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.set_enabled(True)
    trace.clear()
    trace.reset_totals()
    yield
    trace.set_enabled(True)
    trace.clear()
    trace.reset_totals()


def _graph():
    """A new graph object on every call, so its search objects start
    cold."""
    return rmat_graph(9, 8, undirected=True, seed=5, with_values=True)


def _roots(csr):
    return [int(v) for v in np.argsort(-csr.degrees, kind="stable")[:ROOTS]]


def _bfs(mode):
    def go(csr, src):
        res = bfs.run(csr, src, traversal_mode=mode, mark_preds=True,
                      device="cpu")
        return res.labels, res.preds, res.stats
    return go


def _sssp(csr, src):
    res = sssp.run(csr, src, mode="planes", mark_preds=True, device="cpu")
    return res.dist, res.preds, res.stats


# kind: (call, oracle, route, search object's class)
RUNS = {
    "bfs auto": (_bfs("auto"), bfs_reference, "step8",
                 bfs_pallas._FusedBfs),
    "bfs pallas": (_bfs("pallas"), bfs_reference, "sweep",
                   bfs_pallas._SweptBfs),
    "sssp planes": (_sssp, sssp_reference, "planes", sssp._SsspPlanes),
}


def _warmups(call):
    return sum(s.counts.get("warmup.search", 0) for s in call.spans)


def _root_level(call, name):
    return [s for s in call.spans
            if s.parent == call.root.id and s.name == name]


def _fields(stats):
    out = dataclasses.asdict(stats)
    out.pop("elapsed_ms")
    return out


def _same(got, want):
    """Equal arrays, bit for bit, and equal Stats but for the time."""
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert _fields(got[2]) == _fields(want[2])


def _matches_oracle(got, oracle, csr, src):
    want = oracle(csr, src)
    for a, b in zip(got[:2], want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_one_warm_up_search_per_search_object(kind):
    go, oracle, route, _ = RUNS[kind]
    csr = _graph()
    roots = _roots(csr)
    for i, src in enumerate(roots):
        got = go(csr, src)
        call = trace.calls()[-1]
        assert call.src == src and call.route == route
        assert got[2].route in ("", route)
        assert _warmups(call) == (1 if i == 0 else 0)
        (warm,) = _root_level(call, "gt.entry.warmup")
        inside = [s for s in call.spans if s.parent == warm.id]
        assert bool(inside) == (i == 0)    # the first call's search
        (search,) = _root_level(call, "gt.entry.search")
        assert got[2].elapsed_ms == search.elapsed_ms
        _matches_oracle(got, oracle, csr, src)
        _same(got, go(_graph(), src))      # a cold object's first call
    # this graph's first call, then each fresh graph's
    assert trace.totals()["warmup.search"] == 1 + len(roots)


def _shallow_and_deep():
    """(graph, the path's two ends): a star centred on vertex 0 and,
    apart from it, an undirected path of PATH vertices."""
    u = np.concatenate([np.zeros(STAR - 1, np.int64),
                        np.arange(STAR, STAR + PATH - 1, dtype=np.int64)])
    v = np.concatenate([np.arange(1, STAR, dtype=np.int64),
                        np.arange(STAR + 1, STAR + PATH, dtype=np.int64)])
    csr = CsrGraph.from_coo(CooGraph(STAR + PATH, np.concatenate([u, v]),
                                     np.concatenate([v, u]), None))
    return csr, (STAR, STAR + PATH - 1)


def test_a_route_switch_reruns_the_timed_search_warm(monkeypatch):
    """A shallow root first (route step8), then a root on the path: its
    8-plane search reaches depth 255 with a frontier left and turns to
    the chain kernel inside the timed search, so the entry searches once
    more, warm, and reports that search; later calls need no rerun.
    (The switch call's 255 levels fill its record: the spy, not the
    spans, sees its searches.)"""
    go = _bfs("auto")
    csr, ends = _shallow_and_deep()
    got = go(csr, 0)
    assert got[2].route == "step8"
    assert _warmups(trace.calls()[-1]) == 1
    _matches_oracle(got, bfs_reference, csr, 0)
    searches = []
    real = bfs_pallas._FusedBfs.__call__

    def spy(self, src):
        out = real(self, src)
        searches.append((self.route, out[2]))
        return out

    monkeypatch.setattr(bfs_pallas._FusedBfs, "__call__", spy)
    for i, src in enumerate(ends):
        before = len(searches)
        got = go(csr, src)
        call = trace.calls()[-1]
        assert got[2].route == "chain" and call.route == "chain"
        assert got[2].search_depth == PATH - 1
        assert _warmups(call) == (1 if i == 0 else 0)
        assert [r for r, _ in searches[before:]] == \
            ["chain"] * (2 if i == 0 else 1)
        assert got[2].elapsed_ms == searches[-1][1]    # the warm search
        if i > 0:                # a warm call's record is whole
            (search,) = _root_level(call, "gt.entry.search")
            below = [s.name for s in call.spans if s.parent == search.id]
            assert below == ["gt.driver.chain"]
            assert got[2].elapsed_ms == search.elapsed_ms
        _matches_oracle(got, bfs_reference, csr, src)
        _same(got, go(_shallow_and_deep()[0], src))
    assert trace.totals()["warmup.search"] == 2 + len(ends)


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_the_off_switch_changes_no_answer(kind, monkeypatch):
    """With spans and counters off, the answers are the same and the
    object still warms up on its first call only."""
    go, _, _, cls = RUNS[kind]
    csr = _graph()
    roots = _roots(csr)
    on = [go(csr, src) for src in roots]
    searches = []
    real = cls.__call__

    def spy(self, src):
        searches.append(src)
        return real(self, src)

    monkeypatch.setattr(cls, "__call__", spy)
    trace.set_enabled(False)
    held = len(trace.calls())
    csr = _graph()
    per_call = []
    for src, want in zip(roots, on):
        before = len(searches)
        _same(go(csr, src), want)
        per_call.append(len(searches) - before)
    assert per_call == [2] + [1] * (len(roots) - 1)
    assert len(trace.calls()) == held
    assert trace.totals()["warmup.search"] == 1    # the traced calls'
