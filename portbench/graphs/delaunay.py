"""DIMACS-10 `delaunay_n<k>`: the Delaunay triangulation of `points`
points drawn uniformly in the unit square from the seed, as an
undirected graph without weights (scipy's Qhull triangulation; vertex
ids are the points' order of drawing).

Qhull runs in a child process: its heap, gigabytes at 2^21 points, is
then never part of the process that is measured afterwards (in the
measuring process the query rate swung by a fifth between runs of one
seed)."""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from portbench.graphs._csr import BenchGraph, from_neighbour_lists


def neighbour_lists(n: int, seed: int):
    """(indptr, indices) of the triangulation's neighbour lists."""
    from scipy.spatial import Delaunay
    points = np.random.default_rng(seed).random((n, 2))
    indptr, indices = Delaunay(points).vertex_neighbor_vertices
    return indptr.astype(np.int64), indices.astype(np.int32)


def make(config: dict, seed: int, device) -> BenchGraph:
    with ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        indptr, indices = pool.submit(neighbour_lists, int(config["points"]),
                                      int(seed)).result()
    return from_neighbour_lists(indptr, indices, device)
