"""Port parity: SSSP, CC and PR `mode="planes"`
(gunrockinst_tpu_torch.primitives) against the JAX package's planes
modes (Pallas interpret mode on the CPU) and the NumPy oracles: SSSP
distances bitwise and preds equal, CC ids equal, PR ranks allclose, with
equal round counts; with and without the internal relabeling.

device="cpu" runs the value kernel's plain version."""

import numpy as np
import pytest
import torch

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.primitives import cc as ref_cc
from gunrockinst_tpu.primitives import pr as ref_pr
from gunrockinst_tpu.primitives import sssp as ref_sssp

from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.oracles import (cc_reference,
                                           pagerank_reference,
                                           sssp_reference)
from gunrockinst_tpu_torch.primitives import cc, pr, sssp
from gunrockinst_tpu_torch.primitives.search_graph import search_graph


def _random(n, m, seed, undirected):
    # the small_random / small_random_ud fixtures (tests/conftest.py),
    # built anew so that no relabeling cached on a shared graph leaks in
    rng = np.random.default_rng(seed)
    return RefCsr.from_coo(RefCoo(n, rng.integers(0, n, m),
                                  rng.integers(0, n, m),
                                  rng.integers(1, 64, m).astype(np.float32)),
                           undirected=undirected)


GRAPHS = {
    # 200 vertices, directed, weights 1..63
    "random200_directed": lambda: _random(200, 1500, 7, False),
    # 150 vertices, undirected, weights 1..63
    "random150_undirected": lambda: _random(150, 900, 11, True),
    # rmat-s10 ef8 undirected, no weights (uniform: the const_w sweep)
    "rmat10": lambda: ref_rmat(10, 8, undirected=True, seed=10),
}
RELABEL = ["1", "force"]   # "1" leaves graphs this small as they are


def _pair(name, relabel, monkeypatch):
    """The same fresh graph in both packages, under GT_BFS_RELABEL."""
    monkeypatch.setenv("GT_BFS_RELABEL", relabel)
    ref = GRAPHS[name]()
    return ref, CsrGraph.from_arrays(ref.row_offsets, ref.col_indices,
                                     ref.edge_values)


@pytest.mark.parametrize("relabel", RELABEL)
@pytest.mark.parametrize("name,src", [("random200_directed", 0),
                                      ("rmat10", 1)])
def test_sssp_matches_reference(monkeypatch, relabel, name, src):
    ref, port = _pair(name, relabel, monkeypatch)
    got = sssp.run(port, src, mode="planes", device="cpu")
    want = ref_sssp.run(ref, src, mode="planes")
    np.testing.assert_array_equal(got.dist.view(np.int32),
                                  want.dist.view(np.int32))   # bitwise
    np.testing.assert_array_equal(got.preds, want.preds)
    assert got.stats.search_depth == want.stats.search_depth
    assert got.stats.nodes_visited == want.stats.nodes_visited
    assert got.stats.edges_visited == want.stats.edges_visited
    dist, preds = sssp_reference(port, src)
    np.testing.assert_array_equal(got.dist, dist)
    np.testing.assert_array_equal(got.preds, preds)
    perm = search_graph(port, torch.device("cpu")).perm
    assert (perm is None) == (relabel == "1")


@pytest.mark.parametrize("relabel", RELABEL)
@pytest.mark.parametrize("name", ["random200_directed",
                                  "random150_undirected"])
def test_cc_matches_reference(monkeypatch, relabel, name):
    ref, port = _pair(name, relabel, monkeypatch)
    got = cc.run(port, mode="planes", device="cpu")
    want = ref_cc.run(ref, mode="planes")
    np.testing.assert_array_equal(got.component_ids, want.component_ids)
    assert got.num_components == want.num_components
    assert got.stats.search_depth == want.stats.search_depth
    np.testing.assert_array_equal(got.component_ids, cc_reference(port))


@pytest.mark.parametrize("n", [0, 3])
def test_cc_edgeless_graphs_match_reference(n):
    """No vertex, or three with no edge: the round count tests the
    changed map before the first sweep, as the reference's loop does
    (0 rounds for 0 vertices, 1 for 3)."""
    none = np.zeros(0, np.int64)
    ref = RefCsr.from_coo(RefCoo(n, none, none, None))
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)
    got = cc.run(port, mode="planes", device="cpu")
    want = ref_cc.run(ref, mode="planes")
    assert got.stats.search_depth == want.stats.search_depth == min(n, 1)
    np.testing.assert_array_equal(got.component_ids, want.component_ids)
    np.testing.assert_array_equal(got.component_ids, np.arange(n))
    assert got.num_components == want.num_components == n


@pytest.mark.parametrize("relabel", RELABEL)
@pytest.mark.parametrize("name,src", [("rmat10", -1),
                                      ("random200_directed", 3)])
def test_pr_matches_reference(monkeypatch, relabel, name, src):
    ref, port = _pair(name, relabel, monkeypatch)
    got = pr.run(port, src=src, mode="planes", device="cpu")
    want = ref_pr.run(ref, src=src, mode="planes")
    np.testing.assert_allclose(got.ranks, want.ranks, rtol=1e-4,
                               atol=1e-6)
    assert got.stats.search_depth == want.stats.search_depth
    np.testing.assert_allclose(
        got.ranks, pagerank_reference(port, src=src), rtol=1e-4,
        atol=1e-6)
    order = np.lexsort((np.arange(port.num_nodes), -got.ranks))
    np.testing.assert_array_equal(got.node_ids, order)
    np.testing.assert_array_equal(got.sorted_ranks, got.ranks[order])
    norm = pr.run(port, src=src, normalize=True, mode="planes",
                  device="cpu")
    np.testing.assert_allclose(norm.ranks, got.ranks / got.ranks.sum(),
                               rtol=1e-6)


def test_value_paths_share_the_device_csc():
    """SSSP (uniform weights), CC on a symmetric graph and PR sweep the
    one CSC upload that BFS holds for the graph."""
    ref = ref_rmat(8, 4, undirected=True, seed=2)
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)
    dev = torch.device("cpu")
    g = search_graph(port, dev)
    for st in (sssp.get_sssp_planes(port, dev).stepper,
               cc.get_cc_planes(port, dev).stepper,
               pr.get_pr_planes(port, dev).stepper):
        assert st.offsets is g.stepper.offsets
        assert st.in_src is g.stepper.in_src


def test_unported_modes_and_bad_inputs_raise():
    """The modes that raised before this slice (SSSP "sparse", the
    default, "delta" and "bellman"; CC and PR "xla") now run and equal
    the JAX package's; bad inputs still raise."""
    ro, ci = np.array([0, 1, 2, 2]), np.array([1, 2])
    w = np.array([1.0, 2.0], np.float32)
    port = CsrGraph.from_arrays(ro, ci, w)
    ref = RefCsr(row_offsets=ro, col_indices=ci, edge_values=w)
    for mode in ("sparse", "delta", "bellman"):
        got = sssp.run(port, 0, delta=1.0, mode=mode, device="cpu")
        want = ref_sssp.run(ref, 0, delta=1.0, mode=mode)
        np.testing.assert_array_equal(got.dist, want.dist)
        np.testing.assert_array_equal(got.preds, want.preds)
        assert got.stats.search_depth == want.stats.search_depth
    got = sssp.run(port, 0, device="cpu")          # the default mode
    want = ref_sssp.run(ref, 0)
    np.testing.assert_array_equal(got.dist, want.dist)
    np.testing.assert_array_equal(got.preds, want.preds)
    got, want = cc.run(port, device="cpu"), ref_cc.run(ref)
    np.testing.assert_array_equal(got.component_ids, want.component_ids)
    got = pr.run(port, mode="xla", device="cpu")   # "pallas" was ported
    want = ref_pr.run(ref, mode="xla")
    np.testing.assert_allclose(got.ranks, want.ranks, rtol=1e-5, atol=1e-6)
    assert got.stats.search_depth == want.stats.search_depth
    for src in (-1, 3):
        with pytest.raises(ValueError):
            sssp.run(port, src, mode="planes", device="cpu")
    negative = CsrGraph.from_arrays(port.row_offsets, port.col_indices,
                                    np.array([1.0, -2.0], np.float32))
    for mode in ("planes", "sparse"):
        with pytest.raises(ValueError):
            sssp.run(negative, 0, mode=mode, device="cpu")
    with pytest.raises(ValueError):
        pr.run(port, src=3, mode="planes", device="cpu")


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    port = CsrGraph.from_arrays(np.array([0, 1, 1]), np.array([1]))
    with pytest.raises(RuntimeError, match="CUDA"):
        sssp.run(port, 0, mode="planes")
    with pytest.raises(RuntimeError, match="CUDA"):
        cc.run(port, mode="planes")
    with pytest.raises(RuntimeError, match="CUDA"):
        pr.run(port, mode="planes")
