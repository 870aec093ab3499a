"""Port parity: the replicated-state fallbacks (gunrockinst_tpu_torch.
parallel.partition.ShardedGraph, parallel.dist and parallel.dist_more)
against the JAX package's same calls on its virtual CPU mesh of the
same size, the port as P gloo ranks of a RankPool (device="cpu"), every
output the same on every rank.

- bitwise: the ShardedGraph slices and replicated arrays; labels, preds,
  distances, component ids, the MIS state, TopK's ids and centralities,
  MST's mask and components, depth, rounds and pull levels;
- PR, HITS, SALSA, WTF and BC values allclose (rtol 1e-4, atol 1e-6)
  and the same bits in two runs at the same P; the PR on the undirected
  graph also allclose to the port's single-device pr.run;
- P in {1, 2, 8} on rmat(8, 8, undirected, seed 5) and rmat(9, 4,
  directed, seed 31), P = 3 on the first; MST on rmat(7, 8, with values,
  seed 11); the oracles the JAX tests use;
- the fallback PR allclose between 1 and 4 ranks at rmat-s16, where the
  JAX package's float32 psum is not."""

import numpy as np
import pytest

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.csr import DeviceGraph as RefDevice
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.parallel import dist as ref_dist
from gunrockinst_tpu.parallel import dist_more as ref_more
from gunrockinst_tpu.parallel import edge_mesh as ref_mesh
from gunrockinst_tpu.parallel import shard_graph as ref_shard
from gunrockinst_tpu.primitives import mst as ref_mst

from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph
from gunrockinst_tpu_torch.graph.rmat import rmat_graph as rmat_graph_port
from gunrockinst_tpu_torch.oracles import (bfs_reference, cc_reference,
                                           mst_reference_weight,
                                           sssp_reference, verify_mis)
from gunrockinst_tpu_torch.parallel import dist, dist_more
from gunrockinst_tpu_torch.parallel.mesh import MESH, RankPool, call
from gunrockinst_tpu_torch.parallel.partition import shard_graph
from gunrockinst_tpu_torch.primitives import pr

PS = (1, 2, 3, 8)
CLOSE = dict(rtol=1e-4, atol=1e-6)


def _port(ref):
    return CsrGraph.from_arrays(ref.row_offsets, ref.col_indices,
                                ref.edge_values)


def _weighted():
    rng = np.random.default_rng(3)
    n, m = 120, 700
    return RefCsr.from_coo(RefCoo(n, rng.integers(0, n, m),
                                  rng.integers(0, n, m),
                                  rng.integers(1, 32, m).astype(np.float32)))


GRAPHS = {
    "undirected": ref_rmat(8, 8, undirected=True, seed=5),
    "directed": ref_rmat(9, 4, undirected=False, seed=31),
}


def _graphs(p):
    return ["undirected"] if p == 3 else list(GRAPHS)


@pytest.fixture(scope="module", params=PS)
def pool(request):
    with RankPool(request.param, device="cpu", deadline_s=120) as p:
        yield p


def _ref_sharded(csr, p):
    mesh = ref_mesh(p)
    return ref_shard(RefDevice.build(csr, with_csc=False), mesh), mesh


def _sharded(csr):
    return call(shard_graph, call(DeviceGraph.build, _port(csr),
                                  with_csc=False, device="cpu"), MESH)


def _same(results, i):
    for r in results[1:]:
        np.testing.assert_array_equal(r[i], results[0][i])
    return results[0][i]


def _twice(pool, fn, *args, **kw):
    """Two runs; every output the same bits in both and on every rank."""
    a, b = ([r if isinstance(r, tuple) else (r,)
             for r in pool.run(fn, *args, **kw)] for _ in range(2))
    for i in range(len(a[0])):
        np.testing.assert_array_equal(_same(a, i), _same(b, i))
    return a[0]


def test_shard_graph_fields(pool):
    p = pool.size
    for name in _graphs(p):
        ref, _ = _ref_sharded(GRAPHS[name], p)
        got = pool.run(shard_graph, call(DeviceGraph.build,
                                         _port(GRAPHS[name]),
                                         with_csc=False, device="cpu"), MESH)
        for r, g in enumerate(got):
            for k in ("n", "m", "n_pad", "m_pad"):
                assert g[k] == getattr(ref, k), k
            for k in ("edge_src", "edge_dst", "edge_w"):
                want = np.asarray(getattr(ref, k)).reshape(p, -1)[r]
                assert g[k].dtype == want.dtype
                np.testing.assert_array_equal(g[k], want)
            for k in ("out_degree", "row_offsets"):
                np.testing.assert_array_equal(g[k],
                                              np.asarray(getattr(ref, k)))


def test_bfs_dist(pool):
    p = pool.size
    for name in _graphs(p):
        csr = GRAPHS[name]
        sg, mesh = _ref_sharded(csr, p)
        for mark in (True, False):
            labels, preds, depth = ref_dist.bfs_dist(sg, 0, mesh,
                                                     mark_preds=mark)
            got = pool.run(dist.bfs_dist, _sharded(csr), 0, MESH,
                           mark_preds=mark)
            np.testing.assert_array_equal(_same(got, 0), np.asarray(labels))
            np.testing.assert_array_equal(_same(got, 1), np.asarray(preds))
            assert _same(got, 2) == int(depth)
            ref_labels, ref_preds = bfs_reference(_port(csr), 0)
            n = csr.num_nodes
            np.testing.assert_array_equal(got[0][0][:n], ref_labels)
            if mark:
                np.testing.assert_array_equal(got[0][1][:n], ref_preds)


def test_sssp_dist(pool):
    p = pool.size
    graphs = {"weighted": _weighted()}
    graphs.update({k: GRAPHS[k] for k in _graphs(p)})
    for csr in graphs.values():
        sg, mesh = _ref_sharded(csr, p)
        want, it = ref_dist.sssp_dist(sg, 0, mesh)
        got = pool.run(dist.sssp_dist, _sharded(csr), 0, MESH)
        np.testing.assert_array_equal(_same(got, 0), np.asarray(want))
        assert _same(got, 1) == int(it)
        ref, _ = sssp_reference(_port(csr), 0)
        np.testing.assert_array_equal(got[0][0][: csr.num_nodes], ref)


def test_cc_dist(pool):
    p = pool.size
    for name in _graphs(p):
        csr = GRAPHS[name]
        sg, mesh = _ref_sharded(csr, p)
        comp, it = ref_dist.cc_dist(sg, mesh)
        got = pool.run(dist.cc_dist, _sharded(csr), MESH)
        np.testing.assert_array_equal(_same(got, 0), np.asarray(comp))
        assert _same(got, 1) == int(it)
        if name == "undirected":
            np.testing.assert_array_equal(got[0][0][: csr.num_nodes],
                                          cc_reference(_port(csr)))


def test_pagerank_push_dist(pool):
    p = pool.size
    for name in _graphs(p):
        sg, mesh = _ref_sharded(GRAPHS[name], p)
        want = ref_dist.pagerank_push_dist(sg, mesh)
        got = _twice(pool, dist.pagerank_push_dist, _sharded(GRAPHS[name]),
                     MESH)
        np.testing.assert_allclose(got[0], np.asarray(want), **CLOSE)


def test_pagerank_push_dist_matches_pr_run(pool):
    """On the undirected graph (no dangling chain) the fallback PR is the
    port's single-device pr.run, whose max_iter counts one more
    iteration (6 here: much deeper, the threshold gate flips on
    last-bit differences between orders of summation)."""
    csr = GRAPHS["undirected"]
    got = pool.run(dist.pagerank_push_dist, _sharded(csr), MESH, max_iter=6)
    want = pr.run(_port(csr), max_iter=5, device="cpu").ranks
    np.testing.assert_allclose(got[0][: csr.num_nodes], want, **CLOSE)


def test_hits_dist(pool):
    p = pool.size
    for name in _graphs(p):
        sg, mesh = _ref_sharded(GRAPHS[name], p)
        hub, auth = ref_more.hits_dist(sg, mesh, src=0, max_iter=10)
        got = _twice(pool, dist_more.hits_dist, _sharded(GRAPHS[name]), MESH,
                     src=0, max_iter=10)
        np.testing.assert_allclose(got[0], np.asarray(hub), **CLOSE)
        np.testing.assert_allclose(got[1], np.asarray(auth), **CLOSE)


def test_salsa_dist(pool):
    p = pool.size
    for name in _graphs(p):
        sg, mesh = _ref_sharded(GRAPHS[name], p)
        hub, auth = ref_more.salsa_dist(sg, mesh, max_iter=8)
        got = _twice(pool, dist_more.salsa_dist, _sharded(GRAPHS[name]),
                     MESH, max_iter=8)
        np.testing.assert_allclose(got[0], np.asarray(hub), **CLOSE)
        np.testing.assert_allclose(got[1], np.asarray(auth), **CLOSE)


def test_mis_dist(pool):
    p = pool.size
    csr = GRAPHS["undirected"]
    n = csr.num_nodes
    sg, mesh = _ref_sharded(csr, p)
    prio = np.zeros(sg.n_pad, np.int32)
    prio[:n] = np.random.default_rng(0).permutation(n)
    state, rounds = ref_more.mis_dist(sg, mesh, prio)
    got = pool.run(dist_more.mis_dist, _sharded(csr), MESH, prio)
    np.testing.assert_array_equal(_same(got, 0), np.asarray(state))
    assert _same(got, 1) == int(rounds)
    assert verify_mis(_port(csr), got[0][0][:n] == 1)


def test_topk_dist(pool):
    p = pool.size
    for name in _graphs(p):
        sg, mesh = _ref_sharded(GRAPHS[name], p)
        for k in (1, 10):
            ids, cent = ref_more.topk_dist(sg, mesh, k)
            got = pool.run(dist_more.topk_dist, _sharded(GRAPHS[name]), MESH,
                           k)
            np.testing.assert_array_equal(_same(got, 0), np.asarray(ids))
            np.testing.assert_array_equal(_same(got, 1), np.asarray(cent))


def test_dobfs_dist(pool):
    p = pool.size
    for name in _graphs(p):
        csr = GRAPHS[name]
        sg, mesh = _ref_sharded(csr, p)
        for alpha, beta in ((6.0, 2.0), (0.0, 2.0), (1e9, 0.1)):
            want = ref_more.dobfs_dist(sg, 0, mesh, alpha=alpha, beta=beta)
            got = pool.run(dist_more.dobfs_dist, _sharded(csr), 0, MESH,
                           alpha=alpha, beta=beta)
            np.testing.assert_array_equal(_same(got, 0), np.asarray(want[0]))
            np.testing.assert_array_equal(_same(got, 1), np.asarray(want[1]))
            assert (_same(got, 2), _same(got, 3)) == want[2:]


def test_bc_dist(pool):
    p = pool.size
    for name in _graphs(p):
        sg, mesh = _ref_sharded(GRAPHS[name], p)
        want = ref_more.bc_dist(sg, 3, mesh)
        got = _twice(pool, dist_more.bc_dist, _sharded(GRAPHS[name]), 3,
                     MESH)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got[1], np.asarray(want[1]), **CLOSE)
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))
        assert got[3] == want[3]


def test_mst_dist(pool):
    p = pool.size
    csr = ref_rmat(7, 8, undirected=True, seed=11, with_values=True)
    es, ed, w = ref_mst.canonical_edges(csr)
    in_mst, comp, rounds = ref_more.mst_dist(es, ed, w, csr.num_nodes,
                                             ref_mesh(p))
    got = pool.run(dist_more.mst_dist, es, ed, w, csr.num_nodes, MESH)
    np.testing.assert_array_equal(_same(got, 0), in_mst)
    np.testing.assert_array_equal(_same(got, 1), comp)
    assert _same(got, 2) == rounds
    assert abs(float(w[got[0][0]].sum())
               - mst_reference_weight(_port(csr))) < 1e-3


def test_wtf_dist(pool):
    p = pool.size
    for name in _graphs(p):
        sg, mesh = _ref_sharded(GRAPHS[name], p)
        rank, ppr = ref_more.wtf_dist(sg, mesh, src=0, alpha=0.2,
                                      cot_size=50)
        got = _twice(pool, dist_more.wtf_dist, _sharded(GRAPHS[name]), MESH,
                     src=0, alpha=0.2, cot_size=50)
        np.testing.assert_allclose(got[1], np.asarray(ppr), **CLOSE)
        np.testing.assert_allclose(got[0], np.asarray(rank), **CLOSE)


def test_fallback_pagerank_does_not_depend_on_rank_count():
    """At rmat-s16 the threshold-gated PR of the JAX package's fallback
    (float32 psums) differs between 1 and 4 devices in 31,792 of 65,536
    ranks by more than 1e-3; the port's psum (float64 partials, one
    rounding) keeps them allclose."""
    csr = rmat_graph_port(16, 16, undirected=True, seed=42)
    sg = call(shard_graph, call(DeviceGraph.build, csr, with_csc=False,
                                device="cpu"), MESH)
    ranks = []
    for p in (1, 4):
        with RankPool(p, device="cpu", deadline_s=120) as pool:
            ranks.append(_same(
                [(r,) for r in pool.run(dist.pagerank_push_dist, sg, MESH)],
                0))
    np.testing.assert_allclose(ranks[1], ranks[0], **CLOSE)
