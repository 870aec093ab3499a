"""Port parity: the host surfaces (gunrockinst_tpu_torch's `Stats`
metric block, `api`, `utils/config` and `utils/instrument`) against the
JAX package's.

- `Stats.display` returns and prints the JAX string for the same
  fields; `m_teps` and `redundant_pct` agree;
- the six `api` functions equal the JAX ones on raw CSR arrays;
- the flag parser has the same flags and defaults (`--device` also
  takes `cpu`); `resolve_source` and `load_graph` give the same graph;
- the stepped searches give the JAX outputs and trace records
  (kernel, iteration, frontier size) slice for slice, and a `SteppedBfs`
  checkpoint written by either package resumes in the other.

device="cpu" throughout; JAX runs on the CPU."""

import dataclasses

import numpy as np
import pytest

from gunrockinst_tpu import api as ref_api
from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.csr import DeviceGraph as RefDevice
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.primitives.base import Stats as RefStats
from gunrockinst_tpu.utils import config as ref_config
from gunrockinst_tpu.utils import instrument as ref_inst

from gunrockinst_tpu_torch import api
from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph
from gunrockinst_tpu_torch.oracles import bfs_reference
from gunrockinst_tpu_torch.primitives.base import Stats
from gunrockinst_tpu_torch.utils import config, instrument


def _coo_graph(n, rows, cols, values=None, undirected=False):
    return RefCsr.from_coo(RefCoo(n, np.asarray(rows, np.int64),
                                  np.asarray(cols, np.int64), values),
                           undirected=undirected)


def _random(n, m, seed, undirected):
    rng = np.random.default_rng(seed)
    return _coo_graph(n, rng.integers(0, n, m), rng.integers(0, n, m),
                      rng.integers(1, 64, m).astype(np.float32),
                      undirected)


GRAPHS = {
    "random200": lambda: _random(200, 1500, 7, False),
    "rmat9_undirected": lambda: ref_rmat(9, 8, undirected=True, seed=5),
    "path_star": lambda: _coo_graph(
        32, np.r_[np.arange(9), np.arange(11, 31)],
        np.r_[np.arange(1, 10), np.full(20, 10)]),
}


def _pair(name):
    ref = GRAPHS[name]()
    return ref, CsrGraph.from_arrays(ref.row_offsets, ref.col_indices,
                                     ref.edge_values)


# -- Stats -------------------------------------------------------------------

STATS = [
    dict(),
    dict(elapsed_ms=1.25, search_depth=4, nodes_visited=100,
         edges_visited=1000),
    dict(elapsed_ms=0.3, search_depth=7, nodes_visited=10,
         edges_visited=80, total_queued=120, avg_duty=0.4567),
    dict(elapsed_ms=2.0, edges_visited=50, total_queued=20, avg_duty=0.0),
    dict(elapsed_ms=-1.0, edges_visited=5),
]


@pytest.mark.parametrize("kw", STATS)
def test_stats_display_matches_reference(kw, capsys):
    got = Stats(route="chain", **kw)
    want = RefStats(**kw)
    text = got.display("bfs")
    printed = capsys.readouterr().out
    assert text == want.display("bfs")
    assert printed == capsys.readouterr().out == text + "\n"
    assert got.m_teps == want.m_teps
    assert got.redundant_pct == want.redundant_pct
    port_fields = {f.name for f in dataclasses.fields(Stats)}
    assert port_fields - {"route"} == {
        f.name for f in dataclasses.fields(RefStats)}


# -- api ---------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_api_matches_reference(name):
    ref, _ = _pair(name)
    ro, ci, ev = ref.row_offsets, ref.col_indices, ref.edge_values
    if ev is None:
        ev = np.ones(len(ci), np.float32)
    for mark in (False, True):
        for got, want in zip(api.bfs(ro, ci, 0, mark_preds=mark,
                                     device="cpu"),
                             ref_api.bfs(ro, ci, 0, mark_preds=mark)):
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)
        for got, want in zip(api.sssp(ro, ci, ev, 0, mark_preds=mark,
                                      device="cpu"),
                             ref_api.sssp(ro, ci, ev, 0, mark_preds=mark)):
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)
    labels, count = api.cc(ro, ci, device="cpu")
    want_labels, want_count = ref_api.cc(ro, ci)
    np.testing.assert_array_equal(labels, want_labels)
    assert count == want_count
    for src in (-1, 1):
        np.testing.assert_allclose(api.bc(ro, ci, src=src, device="cpu"),
                                   ref_api.bc(ro, ci, src=src),
                                   rtol=1e-4, atol=1e-6)
    ids, ranks = api.pagerank(ro, ci, device="cpu")
    want_ids, want_ranks = ref_api.pagerank(ro, ci)
    np.testing.assert_allclose(ranks, want_ranks, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ids, want_ids)
    for got, want in zip(api.topk(ro, ci, 5, device="cpu"),
                         ref_api.topk(ro, ci, 5)):
        np.testing.assert_array_equal(got, want)


# -- config ------------------------------------------------------------------

ARGVS = [
    ["rmat"],
    ["market", "g.mtx", "--undirected", "--src=largestdegree", "--quick",
     "--iteration-num=3", "--traversal-mode=planes", "--mark-pred"],
    ["grid", "--grid-side=9", "--grid-diagonal", "--delta=0.5",
     "--delta-factor=2", "--error=0.1", "--max-iter=7", "--top-nodes=4",
     "--alpha=6.5", "--beta=2.5", "--salsa-alpha=0.3", "--instrumented",
     "--idempotence", "--queue-sizing=2", "--quiet", "--rmat-scale=5",
     "--rmat-edgefactor=4", "--rmat-seed=3"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parser_matches_reference(argv):
    got = vars(config.standard_parser("bfs").parse_args(argv))
    want = vars(ref_config.standard_parser("bfs").parse_args(argv))
    assert got == want


def test_parser_flags_and_device():
    def table(p):
        return {a.dest: (tuple(a.option_strings), a.default,
                         getattr(a, "choices", None)) for a in p._actions}
    assert table(config.standard_parser("sssp")) == table(
        ref_config.standard_parser("sssp"))
    p = config.standard_parser("bfs")
    assert p.parse_args(["rmat", "--device=cpu"]).device == "cpu"
    assert p.parse_args(["rmat", "--device", "1"]).device == 1
    assert config.torch_device("cpu") == "cpu"
    assert config.torch_device(2) == "cuda:2"
    for bad in ("gpu", "-1"):
        with pytest.raises(SystemExit):
            p.parse_args(["rmat", f"--device={bad}"])


def test_resolve_source_and_load_graph(tmp_path):
    mtx = tmp_path / "g.mtx"
    mtx.write_text("%%MatrixMarket matrix coordinate pattern general\n"
                   "6 6 5\n1 2\n2 3\n3 1\n4 5\n6 6\n")
    argvs = [["rmat", "--rmat-scale=6", "--rmat-edgefactor=4",
              "--rmat-seed=2", "--undirected"],
             ["grid", "--grid-side=7"], ["grid", "--grid-side=5",
                                         "--grid-diagonal"],
             ["market", str(mtx)], ["market", str(mtx), "--undirected"]]
    for argv in argvs:
        got = config.load_graph(config.standard_parser("cc").parse_args(
            argv))
        want = ref_config.load_graph(ref_config.standard_parser(
            "cc").parse_args(argv))
        np.testing.assert_array_equal(got.row_offsets, want.row_offsets)
        np.testing.assert_array_equal(got.col_indices, want.col_indices)
        for flag in ("0", "3", "randomize", "largestdegree"):
            assert config.resolve_source(flag, got, seed=1) == \
                ref_config.resolve_source(flag, want, seed=1)
    with pytest.raises(SystemExit):
        config.load_graph(config.standard_parser("bfs").parse_args(
            ["market"]))


# -- instrument --------------------------------------------------------------

def _records(tracer):
    return [(r.kernel, r.iteration, r.frontier_size)
            for r in tracer.records]


@pytest.mark.parametrize("slice_depth", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_stepped_runs_match_reference(name, slice_depth):
    ref, port = _pair(name)
    rg = RefDevice.build(ref, with_csc=False)
    g = DeviceGraph.build(port, with_csc=False, device="cpu")
    for cls, ref_cls, args in (
            (instrument.SteppedBfs, ref_inst.SteppedBfs, (1,)),
            (instrument.SteppedSssp, ref_inst.SteppedSssp, (1,)),
            (instrument.SteppedCc, ref_inst.SteppedCc, ())):
        got = cls(g, *args, slice_depth=slice_depth, device="cpu")
        want = ref_cls(rg, *args, slice_depth=slice_depth)
        out, ref_out = got.run_to_completion(), want.run_to_completion()
        np.testing.assert_array_equal(out, ref_out, cls.__name__)
        assert _records(got.tracer) == _records(want.tracer), cls.__name__
        s, rs = got.tracer.summary(), want.tracer.summary()
        assert s.keys() == rs.keys()
        assert (s["iterations"], s["total_queued"]) == (
            rs["iterations"], rs["total_queued"])
        assert 0 <= got.tracer.avg_duty <= 1
        assert not got.step()        # converged: no more slices


def test_stepped_bfs_from_a_host_graph():
    ref, port = _pair("rmat9_undirected")
    labels = instrument.SteppedBfs(port, 1, slice_depth=2,
                                   device="cpu").run_to_completion()
    np.testing.assert_array_equal(labels, bfs_reference(port, 1)[0])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_packages(writer, tmp_path):
    ref, port = _pair("rmat9_undirected")
    rg = RefDevice.build(ref, with_csc=False)
    g = DeviceGraph.build(port, with_csc=False, device="cpu")
    path = str(tmp_path / "bfs_state.npz")
    first = (ref_inst.SteppedBfs(rg, 1) if writer == "jax"
             else instrument.SteppedBfs(g, 1, device="cpu"))
    first.step()
    first.checkpoint(path)
    keys = instrument.load_state(path)
    want_keys = ref_inst.load_state(path)
    assert sorted(keys) == ["depth", "frontier", "labels"]
    for k in keys:
        assert keys[k].dtype == want_keys[k].dtype
        assert keys[k].shape == want_keys[k].shape
    full = ref_inst.SteppedBfs(rg, 1).run_to_completion()
    resumed_port = instrument.SteppedBfs.resume(g, path, slice_depth=2,
                                                device="cpu")
    resumed_ref = ref_inst.SteppedBfs.resume(rg, path, slice_depth=2)
    np.testing.assert_array_equal(resumed_port.run_to_completion(), full)
    np.testing.assert_array_equal(resumed_ref.run_to_completion(), full)
    assert _records(resumed_port.tracer) == _records(resumed_ref.tracer)


def test_save_load_state_roundtrip(tmp_path):
    import torch
    path = str(tmp_path / "s.npz")
    instrument.save_state(path, a=torch.arange(5, dtype=torch.int32),
                          b=np.float32(2.5), c=torch.tensor(True))
    st = instrument.load_state(path)
    np.testing.assert_array_equal(st["a"], np.arange(5, dtype=np.int32))
    assert st["a"].dtype == np.int32 and st["b"] == np.float32(2.5)
    assert st["c"].dtype == np.bool_ and bool(st["c"])
    ref_st = ref_inst.load_state(path)
    assert sorted(ref_st) == sorted(st)


def test_tracer_lines_match_reference(capsys):
    got, want = instrument.ProgressTracer(True), ref_inst.ProgressTracer(
        True)
    for t in (got, want):
        t.record("advance", 3, 17, 2.0, 0.5)
        t.record("advance", 4, 0, 1.0)
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:]
    assert got.summary() == want.summary()
