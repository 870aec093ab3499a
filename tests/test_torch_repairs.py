"""The port's repairs against the JAX package:

- SSSP mode "delta" takes its default bucket width in the reference's
  arithmetic (a float32 sum of the padded weights, a float32 divide):
  bit for bit where the float32 sum is exact, within one float32 ulp
  where it is not (the summation order is each library's own), and the
  default call's distances, preds and rounds equal the JAX call's on
  graphs whose float32 weight sum is not exact;
- `bfs.run(traversal_mode="auto")` on a host graph keeps the kernel
  route at every size, where the reference drops to its operator layer
  above its VMEM threshold: with that threshold lowered, labels, preds,
  depth and visited counts still equal the JAX call's, and only
  `total_queued` (and the port's `route`) differ;
- `SearchGraph.min_preds` reads the stepper's own int32 sources and an
  int32 destination made for the call, never the cached `edge_dst`.

device="cpu" throughout; JAX runs on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrockinst_tpu.ops.pallas_mega as ref_pallas_mega
from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.csr import DeviceGraph as RefDevice
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.primitives import bfs as ref_bfs
from gunrockinst_tpu.primitives import sssp as ref_sssp

from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph
from gunrockinst_tpu_torch.ops.mega import MegaStepper
from gunrockinst_tpu_torch.oracles import bfs_reference, sssp_reference
from gunrockinst_tpu_torch.primitives import bfs, bfs_pallas, sssp

CPU = torch.device("cpu")


def _weighted(n, m, seed, undirected, weights):
    rng = np.random.default_rng(seed)
    return RefCsr.from_coo(RefCoo(n, rng.integers(0, n, m),
                                  rng.integers(0, n, m),
                                  weights(rng, m).astype(np.float32)),
                           undirected=undirected)


def _real(rng, m):        # float32 sums of these are not exact
    return rng.random(m) * 9.7 + 0.01


def _ints(rng, m):        # exact in float32 in any order
    return rng.integers(1, 64, m)


GRAPHS = {
    "real300": lambda: _weighted(300, 2400, 3, False, _real),
    "real200_ud": lambda: _weighted(200, 1100, 5, True, _real),
    "real1000": lambda: _weighted(1000, 9000, 9, False, _real),
    "tiny_real": lambda: _weighted(60, 150, 1, True,
                                   lambda rng, m: rng.random(m) * 1e-3),
    "ints400": lambda: _weighted(400, 3000, 2, True, _ints),
}


def _pair(name):
    ref = GRAPHS[name]()
    return ref, CsrGraph.from_arrays(ref.row_offsets, ref.col_indices,
                                     ref.edge_values)


def _ref_delta(rg):
    """The reference's default delta (sssp.py:298-302)."""
    return max(float(jnp.sum(rg.edge_w) / max(rg.m, 1)), 1e-6)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_default_delta_arithmetic(name):
    ref, port = _pair(name)
    got = sssp.default_delta(DeviceGraph.build(port, device=CPU))
    want = _ref_delta(RefDevice.build(ref))
    assert np.float32(got) == got and np.float32(want) == want
    if name.startswith("ints"):
        assert got == want
    else:
        assert abs(got - want) <= np.spacing(np.float32(want))
    zero = CsrGraph.from_arrays(port.row_offsets, port.col_indices,
                                np.zeros(port.num_edges, np.float32))
    assert sssp.default_delta(DeviceGraph.build(zero, device=CPU)) == 1e-6


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_default_delta_call_matches_reference(name):
    ref, port = _pair(name)
    for src in (0, 7):
        got = sssp.run(port, src, mode="delta", device="cpu")
        want = ref_sssp.run(ref, src, mode="delta")
        np.testing.assert_array_equal(got.dist.view(np.int32),
                                      want.dist.view(np.int32))
        np.testing.assert_array_equal(got.preds, want.preds)
        assert got.stats.search_depth == want.stats.search_depth
        dist, preds = sssp_reference(port, src)
        np.testing.assert_array_equal(got.dist, dist)
        np.testing.assert_array_equal(got.preds, preds)


@pytest.mark.parametrize("scale,undirected", [(9, True), (10, False)])
def test_auto_keeps_the_kernel_route(monkeypatch, scale, undirected):
    ref = ref_rmat(scale, 6, undirected=undirected, seed=scale)
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)
    # every graph is above the reference's threshold now
    monkeypatch.setattr(ref_pallas_mega, "VMEM_LIMIT_BYTES", 0)
    assert not ref_pallas_mega.sweep_fits(ref.num_nodes)
    got = bfs.run(port, 1, traversal_mode="auto", device="cpu")
    want = ref_bfs.run(ref, 1, traversal_mode="auto")
    sparse = bfs.run(port, 1, traversal_mode="auto", device="cpu",
                     max_depth=ref.num_nodes + 1)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.preds, want.preds)
    for f in ("search_depth", "nodes_visited", "edges_visited"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert got.stats.route == "step8" and sparse.stats.route == "auto"
    # the reference's operator-layer route counts queued items, the
    # kernel route the visited vertices' out-edges
    assert want.stats.total_queued == sparse.stats.total_queued
    assert got.stats.total_queued == got.stats.edges_visited
    assert got.stats.total_queued != want.stats.total_queued


def test_min_preds_keeps_no_edge_copy(monkeypatch):
    ref = ref_rmat(10, 6, undirected=False, seed=4)
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)
    g = bfs_pallas.search_graph(port, CPU)
    labels, preds = bfs_reference(port, 3)

    def no_edge_dst(self):
        raise AssertionError("min_preds read the cached edge_dst")
    monkeypatch.setattr(MegaStepper, "edge_dst", no_edge_dst)
    seen = {}
    lab = g.to_internal(torch.from_numpy(labels), np.iinfo(np.int32).max)

    def achieves(u, v):
        seen["dtypes"] = (u.dtype, v.dtype)
        seen["u_is_in_src"] = u.data_ptr() == g.stepper.in_src.data_ptr()
        lu = lab[u]
        return (lu != np.iinfo(np.int32).max) & (lab[v] == lu + 1)

    got = g.min_preds(achieves)
    got[3] = -1
    np.testing.assert_array_equal(got, preds)
    assert seen == {"dtypes": (torch.int32, torch.int32),
                    "u_is_in_src": True}
    monkeypatch.undo()      # the plain step version reads edge_dst
    r = bfs.run(port, 3, traversal_mode="mega", device="cpu")
    np.testing.assert_array_equal(r.preds, preds)
