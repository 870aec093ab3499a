"""The traversed-edge count and both byte counts on graphs small enough to
count by hand."""

import torch

from portbench.graphs._csr import undirected_csr
from portbench.reference import bfs, sssp
from portbench.work import bfs as bfs_work
from portbench.work import sssp as sssp_work
from portbench.work import teps


def _graph(n, pairs, weighted=False):
    u = torch.tensor([a for a, _ in pairs])
    v = torch.tensor([b for _, b in pairs])
    w = torch.ones(len(pairs)) if weighted else None
    return undirected_csr(n, u, v, w).to("cpu")


def test_teps_counts_each_component_edge_once():
    # a path 0-1-2-3, a pair 4-5, an isolated 6
    g = _graph(7, [(0, 1), (1, 2), (2, 3), (5, 4)])
    assert teps.edges_per_vertex(g).tolist() == [3, 3, 3, 3, 1, 1, 0]


def test_bfs_bytes_path():
    # levels {0}, {1}, {2}, {3}; degrees 1, 2, 2, 1; n = 6
    # push per level 8, 12, 12, 8; pull 28, 16, 8, 0 -> 8 + 12 + 8 + 0
    g = _graph(6, [(0, 1), (1, 2), (2, 3), (4, 5)])
    assert bfs_work.bytes_of(g, bfs.solve(g, 0)) == 8 * 6 + 28


def test_bfs_bytes_star():
    g = _graph(5, [(0, 1), (0, 2), (0, 3), (0, 4)])
    # from the hub: push 20 then 32; pull 32 then 0
    assert bfs_work.bytes_of(g, bfs.solve(g, 0)) == 40 + 20
    # from a leaf: levels {1}, {0}, {2, 3, 4}; push 8, 20, 24; pull 32,
    # 24, 0
    assert bfs_work.bytes_of(g, bfs.solve(g, 1)) == 40 + 8 + 20


def test_sssp_bytes_component_edges_offsets_and_answer():
    g = _graph(6, [(0, 1), (1, 2), (2, 3), (4, 5)], weighted=True)
    # 6 edge slots and 4 vertices in 0's component; 6 vertices written
    assert sssp_work.bytes_of(g, sssp.solve(g, 0)) == 8 * 6 + 4 * 4 + 8 * 6
