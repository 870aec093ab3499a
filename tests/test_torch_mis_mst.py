"""Port parity: MIS and MST (gunrockinst_tpu_torch.primitives.mis, .mst)
against the JAX package's same calls and the NumPy oracles.

- bitwise: MIS `mis_ids`, `in_set` and rounds, with the default host
  priorities and with given ones (ties included); MST `edge_mask`,
  `edges`, `total_weight` and rounds, with weights that tie and with
  none given (all ones);
- the oracles: `luby_rounds_reference` gives the MIS rounds and
  `verify_mis` accepts the set; the MST weight equals Kruskal's and
  `verify_spanning_tree` accepts the forest;
- the kernels' own outputs over all padded slots.

device="cpu" throughout; JAX runs on the CPU."""

import numpy as np
import pytest
import torch

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.csr import DeviceGraph as RefDevice
from gunrockinst_tpu.graph.lattice import grid_graph as ref_grid
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.primitives import mis as ref_mis
from gunrockinst_tpu.primitives import mst as ref_mst

from gunrockinst_tpu_torch.graph.coo import CooGraph
from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph
from gunrockinst_tpu_torch.oracles import (luby_rounds_reference,
                                           mst_reference_weight,
                                           verify_mis, verify_spanning_tree)
from gunrockinst_tpu_torch.primitives import mis, mst

CPU = torch.device("cpu")


def _coo_graph(n, rows, cols, values=None, undirected=False):
    return RefCsr.from_coo(RefCoo(n, np.asarray(rows, np.int64),
                                  np.asarray(cols, np.int64), values),
                           undirected=undirected)


def _random(n, m, seed, undirected, wmax=64):
    rng = np.random.default_rng(seed)
    return _coo_graph(n, rng.integers(0, n, m), rng.integers(0, n, m),
                      rng.integers(1, wmax, m).astype(np.float32),
                      undirected)


GRAPHS = {
    "random150_ud": lambda: _random(150, 900, 11, True),
    "random200": lambda: _random(200, 1500, 7, False),
    # weights 1..3: many ties in weight
    "random120_ties": lambda: _random(120, 700, 3, True, wmax=4),
    "rmat9_undirected": lambda: ref_rmat(9, 8, undirected=True, seed=5),
    "rmat10_undirected": lambda: ref_rmat(10, 4, undirected=True, seed=1),
    "grid12": lambda: ref_grid(12),
    # a path 0-...-9 beside a star into 10 and the isolated vertex 31
    "path": lambda: _coo_graph(
        32, np.r_[np.arange(9), np.arange(11, 31)],
        np.r_[np.arange(1, 10), np.full(20, 10)], undirected=True),
    # two triangles with weights, a weighted edge and isolated vertices
    "disconnected": lambda: _coo_graph(
        12, [0, 1, 2, 4, 5, 6, 8], [1, 2, 0, 5, 6, 4, 9],
        np.array([2, 2, 2, 1, 3, 1, 5], np.float32), undirected=True),
}
DIRECTED = {"random200"}


def _pair(name):
    ref = GRAPHS[name]()
    return ref, CsrGraph.from_arrays(ref.row_offsets, ref.col_indices,
                                     ref.edge_values)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_mis_matches_reference(name):
    ref, port = _pair(name)
    n = ref.num_nodes
    ties = np.random.default_rng(1).integers(0, 8, n).astype(np.int32)
    for kw in (dict(), dict(seed=3), dict(priorities=ties)):
        got = mis.run(port, device="cpu", **kw)
        want = ref_mis.run(ref, **kw)
        np.testing.assert_array_equal(got.mis_ids, want.mis_ids, str(kw))
        np.testing.assert_array_equal(got.in_set, want.in_set, str(kw))
        assert got.mis_ids.dtype == want.mis_ids.dtype
        assert got.in_set.dtype == want.in_set.dtype
        for f in ("search_depth", "nodes_visited", "edges_visited"):
            assert getattr(got.stats, f) == getattr(want.stats, f), (kw, f)
    got = mis.run(port, seed=0, device="cpu")
    prio = np.random.default_rng(0).permutation(n).astype(np.int32)
    np.testing.assert_array_equal(got.mis_ids,
                                  luby_rounds_reference(port, prio))
    if name not in DIRECTED:     # the validator reads edges both ways
        assert verify_mis(port, got.in_set)


@pytest.mark.parametrize("name", ["rmat9_undirected", "path"])
def test_mis_kernels_all_slots(name):
    ref, port = _pair(name)
    g, rg = DeviceGraph.build(port, device=CPU), RefDevice.build(ref)
    prio = np.full(g.n_pad, np.iinfo(np.int32).min, np.int32)
    prio[: g.n] = np.random.default_rng(4).permutation(g.n)
    for fn, ref_fn in ((mis.mis_kernel, ref_mis.mis_kernel),
                       (mis.luby_kernel, ref_mis.luby_kernel)):
        out, r = fn(g, torch.from_numpy(prio))
        rout, rr = ref_fn(rg, prio)
        np.testing.assert_array_equal(out.numpy(), np.asarray(rout))
        assert r == int(rr)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_mst_matches_reference(name):
    ref, port = _pair(name)
    got = mst.run(port, device="cpu")
    want = ref_mst.run(ref)
    np.testing.assert_array_equal(got.edge_mask, want.edge_mask)
    np.testing.assert_array_equal(got.edges, want.edges)
    assert got.edges.dtype == want.edges.dtype
    assert got.total_weight == want.total_weight
    for f in ("search_depth", "nodes_visited", "edges_visited"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert np.isclose(got.total_weight, mst_reference_weight(port),
                      rtol=1e-6)
    u, v, w = mst.canonical_edges(port)
    canon = CsrGraph.from_coo(CooGraph(port.num_nodes, u.astype(np.int64),
                                       v.astype(np.int64), w))
    assert verify_spanning_tree(canon, got.edge_mask)


@pytest.mark.parametrize("name", ["random120_ties", "disconnected"])
def test_mst_unweighted_ties(name):
    """No weights: every edge weighs 1, so the edge-id tie-break picks
    the whole forest."""
    ref, port = _pair(name)
    ref_u = RefCsr(row_offsets=ref.row_offsets, col_indices=ref.col_indices)
    port_u = CsrGraph.from_arrays(port.row_offsets, port.col_indices)
    got, want = mst.run(port_u, device="cpu"), ref_mst.run(ref_u)
    np.testing.assert_array_equal(got.edge_mask, want.edge_mask)
    assert got.total_weight == want.total_weight
    assert got.stats.search_depth == want.stats.search_depth


def test_mst_kernel_and_canonical_edges():
    ref, port = _pair("random120_ties")
    for a, b in zip(mst.canonical_edges(port), ref_mst.canonical_edges(ref)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    u, v, w = mst.canonical_edges(port)
    n_pad, m_pad = 128, 128 * (len(u) // 128 + 1)
    eu = np.full(m_pad, n_pad, np.int32)
    ev = np.full(m_pad, n_pad, np.int32)
    ew = np.full(m_pad, np.inf, np.float32)
    eu[: len(u)], ev[: len(u)], ew[: len(u)] = u, v, w
    got = mst.mst_kernel(*(torch.from_numpy(a) for a in (eu, ev, ew)),
                         n_pad)
    want = ref_mst.mst_kernel(eu, ev, ew, n_pad)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == int(want[2])


def test_mst_needs_a_host_graph():
    _, port = _pair("path")
    with pytest.raises(TypeError, match="host CsrGraph"):
        mst.run(DeviceGraph.build(port, device=CPU), device="cpu")
