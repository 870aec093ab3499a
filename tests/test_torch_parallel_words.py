"""Port parity: the word-exchange tier's partitions and frontier-only
primitives (gunrockinst_tpu_torch.parallel.dist_words: DstShardedGraph,
_src_owned_edges, BFS, DOBFS, SSSP, CC, PageRank) against the JAX
package's same calls on its virtual CPU mesh of the same size.

The port runs as P gloo ranks of a RankPool (device="cpu"), one pool per
P, each rank returning its shard; a P('e') output is the ranks' slices
concatenated in rank order, a P() output the same on every rank.

- bitwise: every partition field and slice (the JAX arrays reshaped to
  (P, m_loc)); labels, preds, distances, component ids, depth, rounds,
  pull levels and the modelled bytes;
- PageRank's ranks allclose (rtol 1e-4, atol 1e-6) and the same bits in
  two runs at the same P; on the undirected graph (no dangling chain)
  also allclose to the port's single-device pr.run at 6 iterations
  (pr.run's max_iter counts one more; much deeper, the threshold gate
  flips on last-bit differences between orders of summation);
- P in {1, 2, 8} on rmat(8, 8, undirected, seed 5) and rmat(9, 4,
  directed, seed 31), P = 3 (n_pad not a power of two) on the first;
  grid_graph(16) for the deep exchange (2*(side-1)+1 rounds), with the
  oracles the JAX tests use."""

import numpy as np
import pytest

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.lattice import grid_graph as ref_grid
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.parallel import dist_words as ref_dw
from gunrockinst_tpu.parallel import edge_mesh as ref_mesh

from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.oracles import (bfs_reference, cc_reference,
                                           sssp_reference)
from gunrockinst_tpu_torch.parallel import dist_words as dw
from gunrockinst_tpu_torch.parallel.mesh import MESH, RankPool, call
from gunrockinst_tpu_torch.primitives import pr

PS = (1, 2, 3, 8)


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
    """Both graphs, or the first only at P = 3."""
    return ["undirected"] if p == 3 else list(GRAPHS)


@pytest.fixture(scope="module", params=PS)
def pool(request):
    with RankPool(request.param, device="cpu", deadline_s=120) as p:
        yield p


def _cat(results, i):
    return np.concatenate([r[i] for r in results])


def _same(results, i):
    for r in results[1:]:
        np.testing.assert_array_equal(r[i], results[0][i])
    return results[0][i]


def _sharded(pool, name):
    return call(dw.shard_graph_by_dst, _port(GRAPHS[name]), MESH)


def test_shard_graph_by_dst_fields(pool):
    p = pool.size
    for name in _graphs(p):
        ref = ref_dw.shard_graph_by_dst(GRAPHS[name], ref_mesh(p))
        got = pool.run(dw.shard_graph_by_dst, _port(GRAPHS[name]), MESH)
        for r, g in enumerate(got):
            for k in ("n", "m", "n_loc", "m_loc", "n_devices"):
                assert g[k] == getattr(ref, k), k
            for k in ("edge_src", "edge_dst_l", "edge_w"):
                want = np.asarray(getattr(ref, k)).reshape(p, -1)[r]
                assert g[k].dtype == want.dtype
                np.testing.assert_array_equal(g[k], want)
            np.testing.assert_array_equal(
                g["out_degree"],
                np.asarray(ref.out_degree).reshape(p, -1)[r])


def test_src_owned_edges(pool):
    p = pool.size
    for name in _graphs(p):
        ref_g = ref_dw.shard_graph_by_dst(GRAPHS[name], ref_mesh(p))
        bs, bd, m2 = ref_dw._src_owned_edges(GRAPHS[name], ref_g.n_loc, p,
                                             ref_g.n, ref_mesh(p))
        got = pool.run(dw._src_owned_edges, _port(GRAPHS[name]),
                       ref_g.n_loc, p, ref_g.n, MESH)
        for r, (gs, gd, gm) in enumerate(got):
            assert gm == m2
            np.testing.assert_array_equal(gs, np.asarray(bs).reshape(p, -1)[r])
            np.testing.assert_array_equal(gd, np.asarray(bd).reshape(p, -1)[r])


def test_bfs_dist_words(pool):
    p = pool.size
    for name in _graphs(p):
        csr = GRAPHS[name]
        src = int(np.argmax(np.diff(csr.row_offsets)))
        for mark in (True, False):
            mesh = ref_mesh(p)
            labels, preds, depth, traffic = ref_dw.bfs_dist_words(
                ref_dw.shard_graph_by_dst(csr, mesh), src, mesh,
                mark_preds=mark)
            got = pool.run(dw.bfs_dist_words, _sharded(pool, name), src,
                           MESH, mark_preds=mark)
            np.testing.assert_array_equal(_cat(got, 0), np.asarray(labels))
            np.testing.assert_array_equal(_cat(got, 1), np.asarray(preds))
            assert _same(got, 2) == depth and _same(got, 3) == traffic
        ref_labels, ref_preds = bfs_reference(_port(csr), src)
        n = csr.num_nodes
        np.testing.assert_array_equal(_cat(got, 0)[:n], ref_labels)


def test_bfs_dist_words_grid_deep_exchange(pool):
    p = pool.size
    side = 16
    csr = ref_grid(side)
    mesh = ref_mesh(p)
    labels, preds, depth, traffic = ref_dw.bfs_dist_words(
        ref_dw.shard_graph_by_dst(csr, mesh), 0, mesh)
    got = pool.run(dw.bfs_dist_words,
                   call(dw.shard_graph_by_dst, _port(csr), MESH), 0, MESH)
    np.testing.assert_array_equal(_cat(got, 0), np.asarray(labels))
    np.testing.assert_array_equal(_cat(got, 1), np.asarray(preds))
    assert _same(got, 2) == depth == 2 * (side - 1) + 1
    assert _same(got, 3) == traffic
    ref_labels, ref_preds = bfs_reference(_port(csr), 0)
    np.testing.assert_array_equal(_cat(got, 1)[: csr.num_nodes], ref_preds)


def test_dobfs_dist_words(pool):
    p = pool.size
    for name in _graphs(p):
        csr = GRAPHS[name]
        src = int(np.argmax(np.diff(csr.row_offsets)))
        ref_labels, ref_preds = bfs_reference(_port(csr), src)
        # forced pull, forced push, the default switch, an early exit
        for alpha, beta in ((1e9, 2.0), (0.0, 2.0), (6.0, 2.0), (6.0, 1e9)):
            mesh = ref_mesh(p)
            want = ref_dw.dobfs_dist_words(
                ref_dw.shard_graph_by_dst(csr, mesh), src, mesh,
                alpha=alpha, beta=beta)
            got = pool.run(dw.dobfs_dist_words, _sharded(pool, name), src,
                           MESH, alpha=alpha, beta=beta)
            np.testing.assert_array_equal(_cat(got, 0), np.asarray(want[0]))
            np.testing.assert_array_equal(_cat(got, 1), np.asarray(want[1]))
            assert [_same(got, i) for i in (2, 3, 4)] == list(want[2:])
            n = csr.num_nodes
            np.testing.assert_array_equal(_cat(got, 0)[:n], ref_labels)
            np.testing.assert_array_equal(_cat(got, 1)[:n], ref_preds)
            if alpha == 1e9:
                assert _same(got, 3) == _same(got, 2)


def test_sssp_dist_words(pool):
    p = pool.size
    graphs = {"weighted": _weighted()}
    graphs.update({k: GRAPHS[k] for k in _graphs(p)})
    for name, csr in graphs.items():
        mesh = ref_mesh(p)
        dist, it, traffic = ref_dw.sssp_dist_words(
            ref_dw.shard_graph_by_dst(csr, mesh), 0, mesh)
        got = pool.run(dw.sssp_dist_words,
                       call(dw.shard_graph_by_dst, _port(csr), MESH), 0, MESH)
        np.testing.assert_array_equal(_cat(got, 0), np.asarray(dist))
        assert _same(got, 1) == it and _same(got, 2) == traffic
        ref, _ = sssp_reference(_port(csr), 0)
        np.testing.assert_array_equal(_cat(got, 0)[: csr.num_nodes], ref)


def test_cc_dist_words(pool):
    p = pool.size
    sym = RefCsr.from_coo(GRAPHS["directed"].to_coo(), undirected=True)
    for csr in ([GRAPHS["undirected"]] if p == 3
                else [GRAPHS["undirected"], sym]):
        mesh = ref_mesh(p)
        comp, it, traffic = ref_dw.cc_dist_words(
            ref_dw.shard_graph_by_dst(csr, mesh), mesh)
        got = pool.run(dw.cc_dist_words,
                       call(dw.shard_graph_by_dst, _port(csr), MESH), MESH)
        np.testing.assert_array_equal(_cat(got, 0), np.asarray(comp))
        assert _same(got, 1) == it and _same(got, 2) == traffic
        np.testing.assert_array_equal(_cat(got, 0)[: csr.num_nodes],
                                      cc_reference(_port(csr)))


def test_pagerank_dist_words(pool):
    p = pool.size
    for name in _graphs(p):
        mesh = ref_mesh(p)
        rank, traffic = ref_dw.pagerank_dist_words(
            ref_dw.shard_graph_by_dst(GRAPHS[name], mesh), mesh)
        runs = [pool.run(dw.pagerank_dist_words, _sharded(pool, name), MESH)
                for _ in range(2)]
        np.testing.assert_allclose(_cat(runs[0], 0), np.asarray(rank),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(_cat(runs[0], 0), _cat(runs[1], 0))
        assert _same(runs[0], 1) == traffic


def test_pagerank_dist_words_matches_pr_run(pool):
    csr = _port(GRAPHS["undirected"])
    got = pool.run(dw.pagerank_dist_words, _sharded(pool, "undirected"),
                   MESH, max_iter=6)
    want = pr.run(csr, max_iter=5, device="cpu").ranks
    np.testing.assert_allclose(_cat(got, 0)[: csr.num_nodes], want,
                               rtol=1e-4, atol=1e-6)
