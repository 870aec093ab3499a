"""Port parity: TopK and DOBFS (gunrockinst_tpu_torch.primitives.topk,
.dobfs) against the JAX package's same calls and the NumPy oracles.

- bitwise: TopK's four arrays (also over all n_pad slots of a graph
  built without the CSC); DOBFS labels, preds, pull_levels and stats,
  with alpha/beta at the defaults, a fractional pair (truncated to
  int32 as the reference truncates them) and pairs that pull early or
  never;
- the same errors for a graph without the CSC and a source out of
  range.

device="cpu" throughout; JAX runs on the CPU."""

import numpy as np
import pytest
import torch

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.csr import DeviceGraph as RefDevice
from gunrockinst_tpu.graph.lattice import grid_graph as ref_grid
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.primitives import dobfs as ref_dobfs
from gunrockinst_tpu.primitives import topk as ref_topk

from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph
from gunrockinst_tpu_torch.oracles import (bfs_reference,
                                           topk_degree_reference)
from gunrockinst_tpu_torch.primitives import dobfs, topk

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
    "random200": lambda: _random(200, 1500, 7, False),
    "random150_ud": lambda: _random(150, 900, 11, True),
    "rmat9_undirected": lambda: ref_rmat(9, 8, undirected=True, seed=5),
    "rmat10_directed": lambda: ref_rmat(10, 8, undirected=False, seed=2),
    "grid12": lambda: ref_grid(12),
    # a path 0-...-9 beside a star into 10 and the isolated vertex 31
    "path_star": lambda: _coo_graph(
        32, np.r_[np.arange(9), np.arange(11, 31)],
        np.r_[np.arange(1, 10), np.full(20, 10)]),
    # two undirected triangles and three isolated vertices
    "disconnected": lambda: _coo_graph(
        9, [0, 1, 2, 4, 5, 6], [1, 2, 0, 5, 6, 4], undirected=True),
}
SOURCES = {"random200": 0, "random150_ud": 3, "rmat9_undirected": 1,
           "rmat10_directed": 0, "grid12": 5, "path_star": 0,
           "disconnected": 4}


def _pair(name):
    ref = GRAPHS[name]()
    return ref, CsrGraph.from_arrays(ref.row_offsets, ref.col_indices,
                                     ref.edge_values)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_topk_matches_reference(name):
    ref, port = _pair(name)
    for k in (1, 10, ref.num_nodes + 5):
        got = topk.run(port, k, device="cpu")
        want = ref_topk.run(ref, k)
        for field in ("node_ids", "centralities", "in_degrees",
                      "out_degrees"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, field)
        oracle = topk_degree_reference(port, k)
        for a, b in zip((got.node_ids, got.centralities, got.in_degrees,
                         got.out_degrees), oracle):
            np.testing.assert_array_equal(a, b)
        assert (got.stats.nodes_visited, got.stats.edges_visited) == (
            want.stats.nodes_visited, want.stats.edges_visited)


@pytest.mark.parametrize("with_csc", [True, False])
@pytest.mark.parametrize("name", ["random200", "path_star"])
def test_topk_kernel_all_slots(name, with_csc):
    """Every n_pad slot, padding included; without the CSC the
    in-degrees come from the scatter that skips the padding edges."""
    ref, port = _pair(name)
    got = topk.topk_kernel(DeviceGraph.build(port, with_csc=with_csc,
                                             device=CPU))
    want = ref_topk.topk_kernel(RefDevice.build(ref, with_csc=with_csc))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a DeviceGraph goes through run as it is
    dg = DeviceGraph.build(port, with_csc=with_csc, device=CPU)
    r = topk.run(dg, 7, device="cpu")
    np.testing.assert_array_equal(
        r.node_ids, ref_topk.run(RefDevice.build(ref, with_csc=with_csc),
                                 7).node_ids)


ALPHA_BETA = [(6.0, 2.0), (6.5, 2.5), (1.0, 1.0), (0.5, 2.0),
              (1e6, 3.0)]


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_dobfs_matches_reference(name):
    ref, port = _pair(name)
    src = SOURCES[name]
    labels, preds = bfs_reference(port, src)
    pulls = set()
    for alpha, beta in ALPHA_BETA:
        for mark in (True, False):
            got = dobfs.run(port, src, alpha=alpha, beta=beta,
                            mark_preds=mark, device="cpu")
            want = ref_dobfs.run(ref, src, alpha=alpha, beta=beta,
                                 mark_preds=mark)
            tag = f"alpha={alpha} beta={beta} preds={mark}"
            np.testing.assert_array_equal(got.labels, want.labels, tag)
            np.testing.assert_array_equal(got.labels, labels, tag)
            if mark:
                np.testing.assert_array_equal(got.preds, want.preds, tag)
                np.testing.assert_array_equal(got.preds, preds, tag)
            else:
                assert got.preds is None and want.preds is None
            assert got.pull_levels == want.pull_levels, tag
            for f in ("search_depth", "nodes_visited", "edges_visited"):
                assert (getattr(got.stats, f)
                        == getattr(want.stats, f)), (tag, f)
            pulls.add(got.pull_levels)
    if name.startswith("rmat"):
        assert max(pulls) > 0 and min(pulls) == 0   # both directions ran


def test_dobfs_kernel_depth_and_pulls():
    ref, port = _pair("rmat9_undirected")
    got = dobfs.dobfs_kernel(DeviceGraph.build(port, device=CPU), 1, 6, 2)
    want = ref_dobfs.dobfs_kernel(RefDevice.build(ref), 1, np.int32(6),
                                  np.int32(2))
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got[2], got[3]) == (int(want[2]), int(want[3]))


def test_dobfs_errors_match_reference():
    ref, port = _pair("path_star")
    no_csc = DeviceGraph.build(port, with_csc=False, device=CPU)
    with pytest.raises(ValueError, match="with_csc=True"):
        dobfs.run(no_csc, 0, device="cpu")
    with pytest.raises(ValueError, match="with_csc=True"):
        ref_dobfs.run(RefDevice.build(ref, with_csc=False), 0)
    for src in (-1, ref.num_nodes):
        with pytest.raises(ValueError, match="out of range"):
            dobfs.run(port, src, device="cpu")
        with pytest.raises(ValueError, match="out of range"):
            ref_dobfs.run(ref, src)
