"""Port parity: the touched sweep (gunrockinst_tpu_torch.ops.pull,
plain version on the CPU) against the JAX package's three sweepers in
Pallas interpret mode, and the grid-stepped BFS entry points (v1
`bfs_pallas`, `bfs.run(traversal_mode="pallas")`) against the JAX ones
and the NumPy oracle.  Every comparison is bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.primitives import bfs as ref_bfs
from gunrockinst_tpu.primitives import bfs_pallas as ref_bfs_pallas

from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.ops import pull
from gunrockinst_tpu_torch.ops.words import words_from_mask
from gunrockinst_tpu_torch.oracles import bfs_reference
from gunrockinst_tpu_torch.primitives import bfs, bfs_pallas
from gunrockinst_tpu_torch.utils import trace

import torch

HUB = 7          # in-degree HUB_DEGREE: scanned by the whole warp
HUB_DEGREE = 60


def _random(n, m, seed, undirected):
    """Seeded random graph plus HUB_DEGREE in-edges into vertex HUB."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n, m),
                           rng.choice(n, HUB_DEGREE, replace=False)])
    cols = np.concatenate([rng.integers(0, n, m),
                           np.full(HUB_DEGREE, HUB)])
    return RefCsr.from_coo(RefCoo(n, rows, cols, None),
                           undirected=undirected)


def _path(n):
    u = np.arange(n - 1, dtype=np.int64)
    return RefCsr.from_coo(RefCoo(n, np.concatenate([u, u + 1]),
                                  np.concatenate([u + 1, u]), None))


GRAPHS = {
    "undirected300": lambda: _random(300, 700, 5, True),
    "directed250": lambda: _random(250, 1200, 9, False),
    "path600": lambda: _path(600),
}
SWEEPERS = {
    "v1": (ref_bfs_pallas.get_pull_sweeper, bfs_pallas.get_pull_sweeper),
    "v2": (ref_bfs_pallas.get_pull_sweeper_v2,
           bfs_pallas.get_pull_sweeper_v2),
    "v3": (ref_bfs_pallas.get_pull_sweeper_v3,
           bfs_pallas.get_pull_sweeper_v3),
}


def _pair(name):
    ref = GRAPHS[name]()
    return ref, CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)


def _maps(n, n_words, seed):
    """Seeded frontier and visited word maps (frontier inside visited,
    as in a search)."""
    rng = np.random.default_rng(seed)
    fw = rng.random(n) < 0.1
    vw = fw | (rng.random(n) < 0.4)
    return words_from_mask(fw, n_words), words_from_mask(vw, n_words)


@pytest.mark.parametrize("which", sorted(SWEEPERS))
@pytest.mark.parametrize("name", ["undirected300", "directed250"])
def test_sweepers_match_reference(which, name):
    ref, port = _pair(name)
    assert int(np.diff(ref.transposed().row_offsets)[HUB]) >= HUB_DEGREE
    ref_get, port_get = SWEEPERS[which]
    rsw = ref_get(ref, interpret=True)
    sw = port_get(port, device="cpu")
    assert sw.n_words == rsw.n_words
    for seed in (0, 1):
        fw, vw = _maps(port.num_nodes, sw.n_words, seed)
        got = sw(torch.from_numpy(fw)).numpy()
        want = np.asarray(rsw(jnp.asarray(fw)))
        np.testing.assert_array_equal(got, want)
        assert got.any()
        fused = sw.sweep_fused(torch.from_numpy(fw),
                               torch.from_numpy(vw)).numpy()
        np.testing.assert_array_equal(fused, want & ~vw)
        if which == "v1":   # the reference's fused kernel takes ~visited
            np.testing.assert_array_equal(fused, np.asarray(
                rsw.sweep_fused_with(*rsw.tiles, jnp.asarray(fw),
                                     jnp.asarray(~vw))))


def test_three_entry_points_share_one_sweeper():
    _, port = _pair("undirected300")
    sws = {get(port, device="cpu") for _, get in SWEEPERS.values()}
    assert len(sws) == 1
    assert isinstance(sws.pop(), pull.PullSweeper)


def test_sweeper_rejects_bad_maps():
    _, port = _pair("directed250")
    sw = bfs_pallas.get_pull_sweeper(port, device="cpu")
    good = torch.zeros((sw.rows, 128), dtype=torch.int32)
    for bad in (torch.zeros((sw.rows, 64), dtype=torch.int32),
                torch.zeros((sw.rows, 128), dtype=torch.int64),
                torch.zeros((128, sw.rows), dtype=torch.int32).t()):
        with pytest.raises(ValueError):
            sw(bad)
        with pytest.raises(ValueError):
            sw.sweep_fused(good, bad)
    before = trace.totals().get("launch.touch_sweep", 0)
    sw(good)                     # the plain version: no kernel launch
    assert trace.totals().get("launch.touch_sweep", 0) == before


@pytest.mark.parametrize("max_depth", [None, 2])
@pytest.mark.parametrize("name,src", [("undirected300", 0),
                                      ("directed250", 3),
                                      ("path600", 10)])
def test_v1_bfs_pallas_matches_reference(name, src, max_depth):
    ref, port = _pair(name)
    labels, preds, depth = bfs_pallas.bfs_pallas(
        port, src, max_depth=max_depth, device="cpu")
    want_labels, want_preds, want_depth = ref_bfs_pallas.bfs_pallas(
        ref, src, max_depth=max_depth, interpret=True)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_array_equal(preds, want_preds)
    assert depth == want_depth
    oracle_labels, _ = bfs_reference(port, src)
    reached = oracle_labels != np.iinfo(np.int32).max
    if max_depth is None:
        np.testing.assert_array_equal(labels, oracle_labels)
        # the v1 convention: the last, empty level is not counted
        assert depth == oracle_labels[reached].max()
    else:
        assert depth == min(max_depth, oracle_labels[reached].max())
        cut = np.where(oracle_labels <= max_depth, oracle_labels,
                       np.iinfo(np.int32).max)
        np.testing.assert_array_equal(labels, cut)


@pytest.mark.parametrize("name,src", [("undirected300", 0),
                                      ("directed250", 3),
                                      ("path600", 0)])
def test_run_pallas_mode_matches_reference(name, src):
    ref, port = _pair(name)
    got = bfs.run(port, src, traversal_mode="pallas", device="cpu")
    want = ref_bfs.run(ref, src, traversal_mode="pallas")
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.preds, want.preds)
    assert got.stats.route == "sweep"
    for key in ("search_depth", "nodes_visited", "edges_visited"):
        assert getattr(got.stats, key) == getattr(want.stats, key)
    labels, preds = bfs_reference(port, src)
    np.testing.assert_array_equal(got.labels, labels)
    np.testing.assert_array_equal(got.preds, preds)
    # the grid-stepped search's depth counts the last, empty level
    fn = bfs_pallas.get_fused_bfs(port, use_mega=False, device="cpu")
    _, depth, _ = fn(src)
    assert depth == got.stats.search_depth + 1
