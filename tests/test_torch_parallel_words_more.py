"""Port parity: the word-exchange tier's primitives on both partitions
(gunrockinst_tpu_torch.parallel.dist_words: BC, HITS, SALSA, MIS, TopK,
WTF, MST) against the JAX package's same calls on its virtual CPU mesh
of the same size, the port as P gloo ranks of a RankPool
(device="cpu").

- bitwise: the MIS state, TopK's ids and centralities, MST's mask and
  components, depth and rounds, and the modelled bytes (the same on
  every rank);
- BC, HITS, SALSA and WTF values allclose (rtol 1e-4, atol 1e-6), the
  same on every rank and the same bits in two runs at the same P;
- P in {1, 2, 8} on rmat(8, 8, undirected, seed 5) and rmat(9, 4,
  directed, seed 31), P = 3 on the first; MST on rmat(7, 8, with values,
  seed 11) and on a negative-weight graph; the oracles the JAX tests
  use (bc_reference, verify_mis, mst_reference_weight)."""

import numpy as np
import pytest

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.parallel import dist_words as ref_dw
from gunrockinst_tpu.parallel import edge_mesh as ref_mesh
from gunrockinst_tpu.primitives import mst as ref_mst

from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.oracles import (bc_reference,
                                           mst_reference_weight, verify_mis)
from gunrockinst_tpu_torch.parallel import dist_words as dw
from gunrockinst_tpu_torch.parallel.mesh import MESH, RankPool

PS = (1, 2, 3, 8)
CLOSE = dict(rtol=1e-4, atol=1e-6)


def _port(ref):
    return CsrGraph.from_arrays(ref.row_offsets, ref.col_indices,
                                ref.edge_values)


def _negative():
    rng = np.random.default_rng(3)
    n, m = 64, 400
    es, ed = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = es != ed
    es, ed = es[keep], ed[keep]
    w = (rng.random(es.shape[0]) * 4 - 2).astype(np.float32)
    return RefCsr.from_coo(RefCoo(n, es.astype(np.int64), ed.astype(np.int64),
                                  values=w), undirected=True)


GRAPHS = {
    "undirected": ref_rmat(8, 8, undirected=True, seed=5),
    "directed": ref_rmat(9, 4, undirected=False, seed=31),
}
MST_GRAPHS = {
    "rmat": ref_rmat(7, 8, undirected=True, seed=11, with_values=True),
    "negative": _negative(),
}


def _graphs(p):
    return ["undirected"] if p == 3 else list(GRAPHS)


@pytest.fixture(scope="module", params=PS)
def pool(request):
    with RankPool(request.param, device="cpu", deadline_s=120) as p:
        yield p


def _same(results, i):
    for r in results[1:]:
        np.testing.assert_array_equal(r[i], results[0][i])
    return results[0][i]


def _twice(pool, fn, *args, **kw):
    """Two runs; every output the same bits in both and on every rank."""
    a, b = (pool.run(fn, *args, **kw) for _ in range(2))
    for i in range(len(a[0])):
        np.testing.assert_array_equal(_same(a, i), _same(b, i))
    return a[0]


def test_bc_dist_words(pool):
    p = pool.size
    for name in _graphs(p):
        csr = GRAPHS[name]
        want, depth, traffic = ref_dw.bc_dist_words(csr, 3, ref_mesh(p))
        got = _twice(pool, dw.bc_dist_words, _port(csr), 3, MESH)
        assert got[0].dtype == np.float32
        np.testing.assert_allclose(got[0], want, **CLOSE)
        assert got[1:] == (depth, traffic)
        ref, _, _ = bc_reference(_port(csr), src=3)
        np.testing.assert_allclose(got[0], ref, rtol=1e-4, atol=1e-5)


def test_hits_dist_words(pool):
    p = pool.size
    for name in _graphs(p):
        csr = GRAPHS[name]
        hub, auth, traffic = ref_dw.hits_dist_words(csr, ref_mesh(p), src=0,
                                                    max_iter=10)
        got = _twice(pool, dw.hits_dist_words, _port(csr), MESH, src=0,
                     max_iter=10)
        np.testing.assert_allclose(got[0], np.asarray(hub), **CLOSE)
        np.testing.assert_allclose(got[1], np.asarray(auth), **CLOSE)
        assert got[2] == traffic


def test_salsa_dist_words(pool):
    p = pool.size
    for name in _graphs(p):
        csr = GRAPHS[name]
        hub, auth, traffic = ref_dw.salsa_dist_words(csr, ref_mesh(p),
                                                     max_iter=8)
        got = _twice(pool, dw.salsa_dist_words, _port(csr), MESH, max_iter=8)
        np.testing.assert_allclose(got[0], np.asarray(hub), **CLOSE)
        np.testing.assert_allclose(got[1], np.asarray(auth), **CLOSE)
        assert got[2] == traffic


def test_mis_dist_words(pool):
    p = pool.size
    csr = GRAPHS["undirected"]
    n = csr.num_nodes
    n_pad = ref_dw.shard_graph_by_dst(csr, ref_mesh(p)).n_pad
    prio = np.zeros(n_pad, np.int32)
    prio[:n] = np.random.default_rng(0).permutation(n)
    state, rounds, traffic = ref_dw.mis_dist_words(csr, ref_mesh(p), prio)
    got = pool.run(dw.mis_dist_words, _port(csr), MESH, prio)
    np.testing.assert_array_equal(_same(got, 0), np.asarray(state))
    assert (_same(got, 1), _same(got, 2)) == (rounds, traffic)
    assert verify_mis(_port(csr), got[0][0][:n] == 1)


def test_topk_dist_words(pool):
    p = pool.size
    for name in _graphs(p):
        csr = GRAPHS[name]
        for k in (1, 10, csr.num_nodes + 5):
            ids, cent, traffic = ref_dw.topk_dist_words(csr, ref_mesh(p), k)
            got = pool.run(dw.topk_dist_words, _port(csr), MESH, k)
            np.testing.assert_array_equal(_same(got, 0), np.asarray(ids))
            np.testing.assert_array_equal(_same(got, 1), np.asarray(cent))
            assert _same(got, 0).dtype == np.int32
            assert _same(got, 2) == traffic


def test_wtf_dist_words(pool):
    p = pool.size
    for name in _graphs(p):
        csr = GRAPHS[name]
        rank, ppr, traffic = ref_dw.wtf_dist_words(csr, ref_mesh(p), src=0,
                                                   alpha=0.2, cot_size=50)
        got = _twice(pool, dw.wtf_dist_words, _port(csr), MESH, src=0,
                     alpha=0.2, cot_size=50)
        np.testing.assert_allclose(got[1], np.asarray(ppr), **CLOSE)
        np.testing.assert_allclose(got[0], np.asarray(rank), **CLOSE)
        assert got[2] == traffic


def test_mst_dist_words(pool):
    p = pool.size
    for name, csr in MST_GRAPHS.items():
        es, ed, w = ref_mst.canonical_edges(csr)
        in_mst, comp, rounds, traffic = ref_dw.mst_dist_words(
            es, ed, w, csr.num_nodes, ref_mesh(p))
        got = pool.run(dw.mst_dist_words, es, ed, w, csr.num_nodes, MESH)
        np.testing.assert_array_equal(_same(got, 0), in_mst)
        np.testing.assert_array_equal(_same(got, 1), comp)
        assert (_same(got, 2), _same(got, 3)) == (rounds, traffic)
        got_w = float(w[got[0][0]].sum())
        assert abs(got_w - mst_reference_weight(_port(csr))) < 1e-3


def test_mst_weight_keys_match():
    w = np.array([-2.5, -0.0, 0.0, 1e-30, 3.0, np.inf, -np.inf], np.float32)
    keys = dw.mst_weight_keys(w)
    assert keys.dtype == np.int32
    assert list(np.argsort(keys, kind="stable")) == [6, 0, 1, 2, 3, 4, 5]
