"""Port parity: graph layer (gunrockinst_tpu_torch.graph) against the
JAX package's graph layer, on the same seeded inputs.  Every comparison
is bitwise."""

import numpy as np
import pytest

from gunrockinst_tpu.graph import relabel as ref_relabel
from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat

from gunrockinst_tpu_torch.graph import relabel
from gunrockinst_tpu_torch.graph.coo import CooGraph
from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.graph.rmat import rmat_graph


def _same_csr(a, b):
    np.testing.assert_array_equal(a.row_offsets, b.row_offsets)
    np.testing.assert_array_equal(a.col_indices, b.col_indices)
    assert a.row_offsets.dtype == b.row_offsets.dtype
    assert a.col_indices.dtype == b.col_indices.dtype
    if a.edge_values is None:
        assert b.edge_values is None
    else:
        np.testing.assert_array_equal(a.edge_values, b.edge_values)


def _path_graphs(n):
    u = np.arange(n - 1, dtype=np.int64)
    rows, cols = np.concatenate([u, u + 1]), np.concatenate([u + 1, u])
    return (CsrGraph.from_coo(CooGraph(n, rows, cols, None)),
            RefCsr.from_coo(RefCoo(n, rows, cols, None)))


@pytest.mark.parametrize("scale,ef,seed,undirected,values", [
    (12, 16, 42, True, False),
    (13, 8, 1, False, True),
    (14, 4, 7, True, False),
])
def test_rmat_same_edges(scale, ef, seed, undirected, values):
    _same_csr(rmat_graph(scale, ef, undirected=undirected, seed=seed,
                         with_values=values),
              ref_rmat(scale, ef, undirected=undirected, seed=seed,
                       with_values=values))


def test_from_coo_dedupe_loops_values():
    rng = np.random.default_rng(5)
    n, m = 300, 4000
    rows, cols = rng.integers(0, n, m), rng.integers(0, n, m)
    vals = rng.integers(1, 64, m).astype(np.float32)
    for undirected in (False, True):
        _same_csr(CsrGraph.from_coo(CooGraph(n, rows, cols, vals),
                                    undirected=undirected),
                  RefCsr.from_coo(RefCoo(n, rows, cols, vals),
                                  undirected=undirected))


def test_from_arrays_round_trips_reference_graph():
    ref = ref_rmat(12, 8, undirected=False, seed=3, with_values=True)
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices,
                                ref.edge_values)
    _same_csr(port, ref)
    _same_csr(port.transposed(), ref.transposed())
    np.testing.assert_array_equal(port.degrees, ref.degrees)
    assert port.average_degree() == ref.average_degree()
    assert port.row_offsets is not ref.row_offsets   # copies, not views


def test_from_arrays_rejects_malformed():
    with pytest.raises(ValueError):
        CsrGraph.from_arrays(np.array([0, 2, 1]), np.array([0]))
    with pytest.raises(ValueError):
        CsrGraph.from_arrays(np.array([0, 1, 2]), np.array([0, 5]))
    with pytest.raises(ValueError):
        CsrGraph.from_arrays(np.array([0, 1]), np.array([0]),
                             np.ones(2, np.float32))


@pytest.mark.parametrize("undirected", [True, False])
def test_degree_perm_and_reach_words(undirected):
    port = rmat_graph(13, 8, undirected=undirected, seed=9)
    ref = ref_rmat(13, 8, undirected=undirected, seed=9)
    np.testing.assert_array_equal(relabel.degree_perm(port),
                                  ref_relabel.degree_perm(ref))
    assert relabel.is_symmetric(port) == ref_relabel.is_symmetric(ref)
    n_words = 1024
    for src in (0, 17, 4000):
        np.testing.assert_array_equal(
            relabel.reach_words_for(port, src, n_words),
            ref_relabel.reach_words_for(ref, src, n_words))
    if undirected:
        np.testing.assert_array_equal(relabel.component_labels(port),
                                      ref_relabel.component_labels(ref))


def test_bfs_order_perm_deep_and_shallow():
    port, ref = _path_graphs(600)
    got = relabel.bfs_order_perm(port)
    assert got is not None
    np.testing.assert_array_equal(got, ref_relabel.bfs_order_perm(ref))
    shallow = rmat_graph(12, 8, undirected=True, seed=2)
    assert relabel.bfs_order_perm(shallow) is None
    assert ref_relabel.bfs_order_perm(
        ref_rmat(12, 8, undirected=True, seed=2)) is None


@pytest.mark.parametrize("mode", ["force", "1", "0"])
def test_relabeled_same_permutation(monkeypatch, mode):
    """Fresh graph objects under each GT_BFS_RELABEL mode: relabeled()
    caches per graph but reads the env at call time."""
    monkeypatch.setenv("GT_BFS_RELABEL", mode)
    port = rmat_graph(13, 4, undirected=True, seed=21)
    ref = ref_rmat(13, 4, undirected=True, seed=21)
    (pg, pperm), (rg, rperm) = relabel.relabeled(port), \
        ref_relabel.relabeled(ref)
    if mode == "force":
        assert pperm is not None
        np.testing.assert_array_equal(pperm, rperm)
    else:
        assert pperm is None and rperm is None
    _same_csr(pg, rg)
    assert relabel.relabeled(port)[0] is pg          # cached per graph
    assert relabel.worth_relabeling(port) == \
        ref_relabel.worth_relabeling(ref)
