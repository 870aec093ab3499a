"""Port parity: the default (XLA) modes of BFS, SSSP, CC, PR, HITS,
SALSA, WTF and BC (gunrockinst_tpu_torch.primitives) against the JAX
package's same calls, on CsrGraph and DeviceGraph inputs:

- bitwise: BFS labels, preds, depth and total_queued; SSSP distances,
  preds and rounds (explicit delta); CC ids and rounds;
- PR, HITS and SALSA allclose (rtol 1e-5, atol 1e-6), PR with equal
  iteration counts; WTF as tests/test_wtf.py holds it; BC labels and
  sigma equal, values allclose (rtol 1e-4), for one source and for all
  sources at an explicit batch;
- the rank primitives and BC bitwise equal between two calls.

device="cpu" throughout; JAX runs on the CPU."""

import numpy as np
import pytest
import torch

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.csr import DeviceGraph as RefDevice
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.oracles.wtf import wtf_reference as ref_wtf_oracle
from gunrockinst_tpu.primitives import bc as ref_bc
from gunrockinst_tpu.primitives import bfs as ref_bfs
from gunrockinst_tpu.primitives import cc as ref_cc
from gunrockinst_tpu.primitives import hits as ref_hits
from gunrockinst_tpu.primitives import pr as ref_pr
from gunrockinst_tpu.primitives import salsa as ref_salsa
from gunrockinst_tpu.primitives import sssp as ref_sssp
from gunrockinst_tpu.primitives import wtf as ref_wtf

from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph
from gunrockinst_tpu_torch.oracles import (bc_reference, bfs_reference,
                                           cc_reference, sssp_reference)
from gunrockinst_tpu_torch.primitives import (bc, bfs, cc, hits, pr, salsa,
                                              sssp, wtf)
from gunrockinst_tpu_torch.primitives.base import device_graph

CPU = torch.device("cpu")


def _coo_graph(n, rows, cols, values=None, undirected=False):
    return RefCsr.from_coo(RefCoo(n, np.asarray(rows, np.int64),
                                  np.asarray(cols, np.int64), values),
                           undirected=undirected)


def _random(n, m, seed, undirected):
    # the small_random / small_random_ud fixtures (tests/conftest.py)
    rng = np.random.default_rng(seed)
    return _coo_graph(n, rng.integers(0, n, m), rng.integers(0, n, m),
                      rng.integers(1, 64, m).astype(np.float32),
                      undirected)


GRAPHS = {
    # 200 vertices, directed, weights 1..63
    "random200": lambda: _random(200, 1500, 7, False),
    # 150 vertices, undirected, weights 1..63
    "random150_ud": lambda: _random(150, 900, 11, True),
    "rmat9_undirected": lambda: ref_rmat(9, 8, undirected=True, seed=5),
    # a path 0-...-9 beside a star into 10 and the isolated vertex 31
    "path_star": lambda: _coo_graph(
        32, np.r_[np.arange(9), np.arange(11, 31)],
        np.r_[np.arange(1, 10), np.full(20, 10)]),
}
SOURCES = {"random200": 0, "random150_ud": 3, "rmat9_undirected": 1,
           "path_star": 0}


def _pair(name, kind):
    """The same graph in both packages: host CSRs, or DeviceGraphs."""
    ref = GRAPHS[name]()
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices,
                                ref.edge_values)
    if kind == "device":
        return RefDevice.build(ref), DeviceGraph.build(port, device=CPU)
    return ref, port


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("kind", ["csr", "device"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_matches_reference(name, kind):
    ref, port = _pair(name, kind)
    src = SOURCES[name]
    cases = [dict(), dict(traversal_mode="dense"),
             dict(traversal_mode="sparse"),
             dict(traversal_mode="auto", max_depth=2),
             dict(traversal_mode="dense", max_depth=1, mark_preds=False)]
    if kind == "device":         # "auto" takes the operator layer too
        cases.append(dict(traversal_mode="auto"))
    for kw in cases:
        got = bfs.run(port, src, device="cpu", **kw)
        want = ref_bfs.run(ref, src, **kw)
        np.testing.assert_array_equal(got.labels, want.labels, str(kw))
        if want.preds is None:
            assert got.preds is None
        else:
            np.testing.assert_array_equal(got.preds, want.preds, str(kw))
        assert got.stats.total_queued == want.stats.total_queued, kw
        assert got.stats.search_depth == want.stats.search_depth, kw
        assert got.stats.edges_visited == want.stats.edges_visited, kw
    if kind == "csr":
        labels, preds = bfs_reference(port, src)
        got = bfs.run(port, src, device="cpu")
        np.testing.assert_array_equal(got.labels, labels)
        np.testing.assert_array_equal(got.preds, preds)


@pytest.mark.parametrize("name", ["rmat9_undirected", "path_star"])
def test_bfs_searches_match_reference(name):
    """The searches' own outputs, depth (the level count, with the
    dummy level of "auto"'s dense branch) and total_queued included."""
    ref, port = _pair(name, "device")
    src = SOURCES[name]
    for fn, ref_fn, kw in (
            (bfs.bfs_dense, ref_bfs.bfs_dense, {}),
            (bfs.bfs_sparse, ref_bfs.bfs_sparse, dict(mode="sparse")),
            (bfs.bfs_sparse, ref_bfs.bfs_sparse, dict(mode="auto")),
            (bfs.bfs_sparse, ref_bfs.bfs_sparse,
             dict(mode="auto", max_depth=2))):
        labels, preds, depth, queued = fn(port, src, **kw)
        rl, rp, rd, rq = ref_fn(ref, src, **kw)
        np.testing.assert_array_equal(labels.numpy(), np.asarray(rl))
        np.testing.assert_array_equal(preds.numpy(), np.asarray(rp))
        assert (depth, queued) == (int(rd), int(rq)), kw


@pytest.mark.parametrize("kind", ["csr", "device"])
@pytest.mark.parametrize("name", ["random200", "random150_ud",
                                  "path_star"])
def test_sssp_matches_reference(name, kind):
    ref, port = _pair(name, kind)
    src = SOURCES[name]
    for kw in (dict(), dict(mode="sparse", delta=7.0),
               dict(mode="delta", delta=7.0), dict(mode="delta", delta=0.5),
               dict(mode="bellman", delta=7.0)):
        got = sssp.run(port, src, device="cpu", **kw)
        want = ref_sssp.run(ref, src, **kw)
        np.testing.assert_array_equal(_bits(got.dist), _bits(want.dist))
        np.testing.assert_array_equal(got.preds, want.preds)
        assert got.stats.search_depth == want.stats.search_depth, kw
    if kind == "csr":
        dist, preds = sssp_reference(port, src)
        got = sssp.run(port, src, mode="delta", device="cpu")
        np.testing.assert_array_equal(got.dist, dist)
        np.testing.assert_array_equal(got.preds, preds)
        assert sssp.run(port, src, mark_preds=False,
                        device="cpu").preds is None


@pytest.mark.parametrize("kind", ["csr", "device"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_cc_matches_reference(name, kind):
    ref, port = _pair(name, kind)
    got, want = cc.run(port, device="cpu"), ref_cc.run(ref)
    np.testing.assert_array_equal(got.component_ids, want.component_ids)
    assert got.num_components == want.num_components
    assert got.stats.search_depth == want.stats.search_depth
    if kind == "csr":
        np.testing.assert_array_equal(got.component_ids,
                                      cc_reference(port))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["csr", "device"])
@pytest.mark.parametrize("name", ["random200", "rmat9_undirected",
                                  "path_star"])
def test_pr_matches_reference(name, kind):
    ref, port = _pair(name, kind)
    for kw in (dict(), dict(src=SOURCES[name], max_iter=20),
               dict(normalize=True, threshold=1e-4)):
        got = pr.run(port, device="cpu", **kw)
        want = ref_pr.run(ref, **kw)
        _close(got.ranks, want.ranks)
        assert got.stats.search_depth == want.stats.search_depth, kw
        again = pr.run(port, device="cpu", **kw)
        np.testing.assert_array_equal(_bits(got.ranks), _bits(again.ranks))


@pytest.mark.parametrize("kind", ["csr", "device"])
@pytest.mark.parametrize("name", ["random200", "rmat9_undirected",
                                  "path_star"])
def test_hits_salsa_match_reference(name, kind):
    ref, port = _pair(name, kind)
    src = SOURCES[name]
    pairs = ((lambda: hits.run(port, src=src, max_iter=12, device="cpu"),
              ref_hits.run(ref, src=src, max_iter=12)),
             (lambda: hits.run(port, device="cpu"), ref_hits.run(ref)),
             (lambda: salsa.run(port, max_iter=12, device="cpu"),
              ref_salsa.run(ref, max_iter=12)))
    for call, want in pairs:
        got, again = call(), call()
        _close(got.hub_ranks, want.hub_ranks)
        _close(got.auth_ranks, want.auth_ranks)
        np.testing.assert_array_equal(_bits(got.hub_ranks),
                                      _bits(again.hub_ranks))
        np.testing.assert_array_equal(_bits(got.auth_ranks),
                                      _bits(again.auth_ranks))


@pytest.mark.parametrize("kind", ["csr", "device"])
@pytest.mark.parametrize("name", ["random200", "random150_ud"])
def test_wtf_matches_reference(name, kind):
    ref, port = _pair(name, kind)
    src = SOURCES[name] + 11
    got = wtf.run(port, src, cot_size=50, device="cpu")
    want = ref_wtf.run(ref, src, cot_size=50)
    np.testing.assert_array_equal(got.cot, want.cot)
    np.testing.assert_allclose(got.ppr_ranks, want.ppr_ranks, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.wtf_ranks, want.wtf_ranks, rtol=1e-4,
                               atol=1e-6)
    assert set(got.phases) == {"ppr_ms", "ppr_iters", "cot_sort_ms",
                               "salsa_ms"}
    if kind == "csr":
        rank, cot, _ = ref_wtf_oracle(ref, src, cot_size=50)
        np.testing.assert_array_equal(got.cot, cot)
        np.testing.assert_allclose(got.wtf_ranks, rank, rtol=1e-4,
                                   atol=1e-6)


def _assert_bc(got, want):
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.sigmas, want.sigmas)
    np.testing.assert_allclose(got.bc_values, want.bc_values, rtol=1e-4,
                               atol=1e-6)
    assert got.stats.search_depth == want.stats.search_depth


@pytest.mark.parametrize("kind", ["csr", "device"])
@pytest.mark.parametrize("name", ["random200", "rmat9_undirected",
                                  "path_star"])
def test_bc_matches_reference(name, kind):
    ref, port = _pair(name, kind)
    src = SOURCES[name]
    got = bc.run(port, src=src, device="cpu")
    _assert_bc(got, ref_bc.run(ref, src=src))
    again = bc.run(port, src=src, device="cpu")
    np.testing.assert_array_equal(_bits(got.bc_values),
                                  _bits(again.bc_values))
    for batch in (16, 64):
        got = bc.run(port, batch=batch, device="cpu")
        _assert_bc(got, ref_bc.run(ref, batch=batch))
    if kind == "csr":
        want = bc_reference(port)[0]
        np.testing.assert_allclose(got.bc_values, want, rtol=1e-4,
                                   atol=1e-6)


def test_default_batch_and_bad_inputs():
    ref, port = _pair("random200", "csr")
    g = device_graph(port, CPU)
    assert device_graph(port, CPU) is g            # built once
    k = bc.auto_batch(g)
    assert 1 <= k <= 128 and k & (k - 1) == 0
    assert k == ref_bc._auto_batch(RefDevice.build(ref))
    _assert_bc(bc.run(port, device="cpu"), ref_bc.run(ref))
    with pytest.raises(ValueError):
        bfs.run(port, 200, device="cpu")
    with pytest.raises(ValueError):
        sssp.run(port, -1, device="cpu")
    with pytest.raises(ValueError):
        wtf.run(g, 200, device="cpu")
    with pytest.raises(ValueError):
        bc.run(port, src=200, device="cpu")
    with pytest.raises(TypeError):
        bfs.run(g, 0, traversal_mode="mega", device="cpu")
    with pytest.raises(TypeError):
        cc.run(object(), device="cpu")
    negative = CsrGraph.from_arrays(port.row_offsets, port.col_indices,
                                    -port.edge_values)
    with pytest.raises(ValueError):
        sssp.run(negative, 0, device="cpu")


def test_smoke_all_sources_oracle_matches_bc_reference():
    """chip_smoke.bc_all_dense, the all-sources oracle of the smoke
    run's phase 23, equals bc_reference on small graphs."""
    import chip_smoke
    for name in ("random200", "path_star"):
        _, port = _pair(name, "csr")
        np.testing.assert_allclose(chip_smoke.bc_all_dense(port, CPU),
                                   bc_reference(port)[0], rtol=1e-6,
                                   atol=1e-6)


def test_entry_points_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port = _pair("path_star", "csr")
    g = DeviceGraph.build(port, device=CPU)
    for call in (lambda: bfs.run(port, 0), lambda: sssp.run(g, 0),
                 lambda: cc.run(port), lambda: pr.run(g),
                 lambda: hits.run(port), lambda: salsa.run(g),
                 lambda: wtf.run(port, 0), lambda: bc.run(g),
                 lambda: DeviceGraph.build(port)):
        with pytest.raises(RuntimeError):
            call()
