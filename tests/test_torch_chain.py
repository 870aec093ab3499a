"""Port parity: the whole-search kernel's plain version
(gunrockinst_tpu_torch.ops.chain.ChainBfs on the CPU) against the JAX
package's `ChainBfs` in Pallas interpret mode, and the deep-search route
of `bfs_pallas_fused` against the JAX one and the NumPy oracle.  Planes,
visited words and depth are compared exactly."""

import functools

import numpy as np
import pytest
import torch

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.lattice import grid_graph as ref_grid
from gunrockinst_tpu.ops import pallas_mega as ref_mega
from gunrockinst_tpu.primitives import bfs_pallas as ref_bfs_pallas

from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.ops import chain
from gunrockinst_tpu_torch.ops.words import host_unpack_words
from gunrockinst_tpu_torch.oracles import bfs_reference
from gunrockinst_tpu_torch.primitives import bfs, bfs_pallas
from gunrockinst_tpu_torch.utils import trace

INF32 = np.iinfo(np.int32).max
CPU = torch.device("cpu")


def _path(n):
    u = np.arange(n - 1, dtype=np.int64)
    return RefCsr.from_coo(RefCoo(n, np.concatenate([u, u + 1]),
                                  np.concatenate([u + 1, u]), None))


def _directed(n, m, seed):
    rng = np.random.default_rng(seed)
    return RefCsr.from_coo(RefCoo(n, rng.integers(0, n, m),
                                  rng.integers(0, n, m), None))


GRAPHS = {
    "path600": lambda: _path(600),
    "grid12": lambda: ref_grid(12),
    "directed300": lambda: _directed(300, 900, 17),
}


def _port_of(ref):
    return CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX graph, port graph, JAX ChainBfs with full planes), built
    once per graph: each JAX ChainBfs compiles its kernel anew."""
    ref = GRAPHS[name]()
    n = ref.num_nodes
    csc = ref.transposed()
    plan = ref_mega.build_mega_plan(csc.row_offsets, csc.col_indices, n)
    return ref, _port_of(ref), ref_mega.ChainBfs(
        plan, (n + 1).bit_length(), interpret=True)


def _bits(words, n):
    return host_unpack_words(np.ascontiguousarray(np.asarray(words)), n)


@pytest.mark.parametrize("name,src", [("path600", 0), ("path600", 300),
                                      ("grid12", 13), ("grid12", 0),
                                      ("directed300", 5)])
def test_chain_matches_reference(monkeypatch, name, src):
    monkeypatch.setenv("GT_BFS_RELABEL", "1")   # no relabeling this small
    ref, port, ref_chain = _case(name)
    n = port.num_nodes
    planes = (n + 1).bit_length()
    g = bfs_pallas.search_graph(port, CPU)
    assert g.perm is None
    got_planes, got_vw, got_depth = chain.ChainBfs(g, planes)(src)
    want_planes, want_vw, want_depth = ref_chain(src)
    assert int(got_depth.item()) == int(np.asarray(want_depth)[0, 0])
    np.testing.assert_array_equal(_bits(got_vw.numpy(), n),
                                  _bits(want_vw, n))
    gp = got_planes.numpy().reshape(planes, -1)
    wp = np.asarray(want_planes).reshape(planes, -1)
    for b in range(planes):
        np.testing.assert_array_equal(_bits(gp[b], n), _bits(wp[b], n))
    # and against the oracle: labels from the planes, depth one past
    # the deepest label
    labels, _ = bfs_reference(port, src)
    visited = _bits(got_vw.numpy(), n).astype(bool)
    np.testing.assert_array_equal(visited, labels != INF32)
    got_labels = np.zeros(n, np.int64)
    for b in range(planes):
        got_labels |= _bits(gp[b], n).astype(np.int64) << b
    np.testing.assert_array_equal(got_labels[visited], labels[visited])
    assert int(got_depth.item()) == labels[visited].max() + 1


def test_chain_reference_stops_at_n_plus_one_levels():
    """max_depth = n + 1 bounds the plain version on any input; a path
    from its end needs n levels, the last one empty."""
    port = _port_of(_path(40))
    g = bfs_pallas.search_graph(port, CPU)
    st = g.stepper
    _, vw, depth = chain.chain_reference(st.offsets, st.in_src, 0, 6,
                                         g.rows)
    assert int(depth.item()) == 40
    assert _bits(vw.numpy(), 40).all()


def test_chain_rejects_bad_arguments():
    g = bfs_pallas.search_graph(_port_of(_path(10)), CPU)
    fn = chain.ChainBfs(g, 4)
    for src in (-1, 10):
        with pytest.raises(ValueError):
            fn(src)
    with pytest.raises(ValueError):
        chain.ChainBfs(g, 0)
    before = trace.totals().get("launch.chain_bfs", 0)
    fn(0)                        # the plain version: no kernel launch
    assert trace.totals().get("launch.chain_bfs", 0) == before


def test_fused_deep_search_takes_chain_route(monkeypatch):
    """A 600-vertex path is deeper than the 8 label planes: the first
    search goes deep, runs again on the chain kernel, and every later
    search goes there directly; labels and preds equal the JAX
    package's `bfs_pallas_fused` and the oracle."""
    monkeypatch.setenv("GT_BFS_RELABEL", "1")
    ref = _path(600)
    port = _port_of(ref)
    fn = bfs_pallas.get_fused_bfs(port, device="cpu")
    for src in (0, 300):
        labels, preds, depth, _ = bfs_pallas.bfs_pallas_fused(
            port, src, device="cpu")
        assert fn.route == "chain" and fn.went_deep
        want_labels, want_preds, want_depth, _ = \
            ref_bfs_pallas.bfs_pallas_fused(ref, src)
        np.testing.assert_array_equal(labels, want_labels)
        np.testing.assert_array_equal(preds, want_preds)
        assert depth == want_depth
        oracle_labels, oracle_preds = bfs_reference(port, src)
        np.testing.assert_array_equal(labels, oracle_labels)
        np.testing.assert_array_equal(preds, oracle_preds)
    res = bfs.run(port, 599, traversal_mode="auto", device="cpu")
    assert res.stats.route == "chain"
    np.testing.assert_array_equal(res.labels, bfs_reference(port, 599)[0])


@pytest.mark.parametrize("n_words,limit,widths", [
    (-1, 1024, None),
    (128, -1, None),
    (128, 1024, [3, -1]),
])
def test_layout_rejects_bad_arguments(n_words, limit, widths):
    with pytest.raises(ValueError):
        chain.layout(n_words, limit, None, widths)


@pytest.mark.parametrize("cap", [-1, True, 1.5, "0"])
def test_chain_rejects_bad_map_cap(cap):
    g = bfs_pallas.search_graph(_port_of(_path(10)), CPU)
    with pytest.raises(ValueError):
        chain.ChainBfs(g, 4, map_cap=cap)


@pytest.mark.parametrize("widths", [[-1], [True], [1.5], "9", [2, None]])
def test_chain_rejects_bad_widths(widths):
    g = bfs_pallas.search_graph(_port_of(_path(10)), CPU)
    with pytest.raises(ValueError):
        chain.ChainBfs(g, 4, widths=widths)


def test_chain_map_cap_keeps_the_result():
    """The cap changes where the kernel keeps its visited map, never the
    search: on the CPU both run the plain version, bit for bit."""
    g = bfs_pallas.search_graph(_port_of(_path(50)), CPU)
    whole = chain.ChainBfs(g, 6, widths=[1])(7)
    capped = chain.ChainBfs(g, 6, map_cap=0, widths=[1])(7)
    wide = chain.ChainBfs(g, 6)(7)
    for a, b, c in zip(whole, capped, wide):
        assert torch.equal(a, b)
        assert torch.equal(a, c)


N = chain.NARROW_LEVEL
S = chain.WIDE_SHARE
ROAD = [258] * 255            # grid-1024^2's first levels stay narrow


@pytest.mark.parametrize("n_words,limit,cap,widths,want", [
    (33792, 232432, None, ROAD, (1, 8192)),   # grid-1024^2: one block, 132 KB
    (33792, 232432, None, None, (8, 8192)),   # widths unknown: global map
    (33792, 232432, None, [], (8, 8192)),     # ... or none counted
    (33792, 232432, None, [N] * 255, (1, 8192)),   # narrow at the limit
    (33792, 232432, None, [N + 1] + [1] * (S - 1), (1, 8192)),  # 1 in S wide
    (33792, 232432, None, [N + 1] * 2 + [1] * (S - 1), (8, 8192)),  # more
    (41472, 232432, None, [1] * 63 + [9000] * 192, (8, 8192)),  # a 3-D lattice
    (41472, 232432, None, [64000, 138543, 3] + [1] * 252, (1, 8192)),  # core, tail
    (32768, 232432, None, [1], (1, 8192)),    # a path
    (56832, 232432, None, [1], (1, 638)),     # 1.8 M vertices: the map fills it
    (58112, 232432, None, [1], (8, 8192)),    # 1.86 M vertices: too big
    (33792, 232432, 0, ROAD, (8, 8192)),      # the cap forces global memory
    (33792, 232432, 135168, ROAD, (1, 8192)),   # a cap the map just fits
    (33792, 232432, 135167, ROAD, (8, 8192)),   # ... and one byte short of it
    (33792, 40000, None, ROAD, (8, 5000)),    # a card with less shared memory
    (1 << 20, 232432, None, [1], (8, 8192)),  # 32 M vertices
    (128, 232432, None, [0], (1, 8192)),
    (128, 520, None, [0], (1, 1)),
    (128, 0, None, [0], (8, 0)),              # no shared memory at all
    (0, 232432, None, [0], (8, 8192)),        # no word: nothing to hold
])
def test_layout_takes_one_block_or_global_memory(n_words, limit, cap,
                                                 widths, want):
    """A narrow search (its level widths known, at most one level in
    WIDE_SHARE wider than NARROW_LEVEL vertices) runs on one block with
    the visited map in its shared memory when the map fits the card's
    limit and the cap; any other on GLOBAL_CLUSTER blocks with the map
    in global memory.  The rest of a block's shared memory holds up to
    LIST_CAP entries of each frontier list."""
    assert chain.layout(n_words, limit, cap, widths) == want


def test_deep_route_passes_the_level_widths(monkeypatch):
    """The BFS route builds its chain kernel with the new vertices of
    each level its 8-plane host loop counted."""
    seen = {}
    real = chain.ChainBfs

    def spy(g, planes, map_cap=None, widths=None):
        seen["widths"] = list(widths)
        return real(g, planes, map_cap, widths)

    monkeypatch.setattr(bfs_pallas, "ChainBfs", spy)
    port = _port_of(_path(600))
    fn = bfs_pallas.get_fused_bfs(port, device="cpu")
    fn(0)
    assert fn.route == "chain"
    assert seen["widths"] == [1] * 255   # a path from its end: one a level
