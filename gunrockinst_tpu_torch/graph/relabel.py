"""Degree-sorted internal relabeling + reachability masks.

A copy of the JAX package's `graph/relabel.py` (NumPy and scipy only):
the same graph gives the same permutations and reach masks, so word
maps compare bitwise inside a search.  The notes below are the
reference's own; the region skip they describe is the TPU kernel's,
and the port's step kernel (csrc/mega_step.cu) skips by destination
word instead.

Round-5 BFS redesign support (VERDICT r4 item 1): the mega kernel can
skip whole 32K-vertex super-regions on either the SOURCE side (no
frontier bit in the region — good on early levels) or the DESTINATION
side (no unvisited reachable vertex in the region — good on late
levels), but on the original R-MAT vertex order neither side ever goes
quiet: the frontier and the unvisited stragglers are both scattered
across the whole id space.

Renumbering vertices by descending degree fixes both sides at once
(measured, scripts/analyze_dst_skip.py, rmat-s20 src=top-degree):

  * late levels claim only low-degree vertices, which now live in
    high-id regions that own almost no edges — the per-level pull cost
    with best-of(src,dst) region skipping drops 4.21m -> 1.72m edge
    units (m = one full sweep);
  * ~1/3 of the super-regions end up entirely edge-free and are never
    built, DMA'd, or scanned;
  * consecutive ids get similar degrees, so tile cells fatten and the
    plan packs denser.

The relabeling is an internal coordinate change only: searches run in
permuted space and results are mapped back to input ids during
extraction (outside the Enact timing window, like the reference's
Extract step — tests/bfs/test_bfs.cu:402-431 stops the GpuTimer before
extraction; the reference itself reorders columns within each CSR row
the same spirit, csr.cuh:267-288 sort).

Reachability masks make the dst-side skip exact and effective: a
region may be skipped when every vertex the search could still claim
in it is already visited.  For undirected graphs "could claim" is the
connected component of the source (computed once per graph, host
side); for directed graphs the safe superset is "has at least one
in-edge".
"""

from __future__ import annotations

import os
import weakref
from typing import Optional, Tuple

import numpy as np

from gunrockinst_tpu_torch.graph.coo import CooGraph
from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.utils import trace


def degree_perm(csr: CsrGraph) -> np.ndarray:
    """perm[v] = new id of vertex v; descending degree, stable."""
    order = np.argsort(-csr.degrees.astype(np.int64), kind="stable")
    perm = np.empty(csr.num_nodes, np.int64)
    perm[order] = np.arange(csr.num_nodes)
    return perm.astype(np.int32)


def apply_perm(csr: CsrGraph, perm: np.ndarray) -> CsrGraph:
    """CsrGraph over the renamed vertices (edge (u,v) -> (perm[u],
    perm[v]); weights follow their edges)."""
    n = csr.num_nodes
    rows = perm[np.repeat(np.arange(n, dtype=np.int64),
                          np.diff(csr.row_offsets))]
    cols = perm[csr.col_indices.astype(np.int64)]
    coo = CooGraph(n, rows.astype(np.int32), cols.astype(np.int32),
                   None if csr.edge_values is None
                   else csr.edge_values.copy())
    # already loop-free/deduped if the input was; just re-sort
    return CsrGraph.from_coo(coo, dedupe=False,
                             remove_self_loops=False)


def worth_relabeling(csr: CsrGraph) -> bool:
    """Degree-sort only skewed graphs big enough to span several
    32K-vertex super-regions: on near-uniform graphs (grids, road
    networks) the input order is already the locality order and the
    permutation would only shuffle it."""
    mode = os.environ.get("GT_BFS_RELABEL", "1")
    if mode == "0":
        return False
    if mode == "force":       # tests: exercise the permuted path at
        return True           # scales where it wouldn't pay off
    n = csr.num_nodes
    if n < 2 * 65536:
        return False
    deg = csr.degrees
    if deg.size == 0:
        return False
    return int(deg.max()) >= 32 * max(1.0, csr.average_degree())


_relabel_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def bfs_order_perm(csr: CsrGraph) -> Optional[np.ndarray]:
    """Breadth-first (Cuthill-McKee-style) renumbering from the
    highest-degree vertex: wavefronts of a search become CONTIGUOUS id
    ranges, so the mega/chain kernels' source-region skip sees 1-2
    active regions per level instead of one vertex in every region
    (grid/road networks: the row-major anti-diagonal frontier touches
    every 32K block).  Classic sparse bandwidth reduction re-purposed
    for frontier locality.  Returns None when the graph is shallow
    (diameter <= 255: the scale-free regime, where the degree sort is
    the right order)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    n, m = csr.num_nodes, csr.num_edges
    a = csr_matrix((np.ones(m, np.int8), csr.col_indices,
                    csr.row_offsets), shape=(n, n))
    src = int(np.argmax(csr.degrees))
    dist = dijkstra(a, indices=src, unweighted=True, directed=False)
    finite = np.isfinite(dist)
    if not finite.any() or int(dist[finite].max()) <= 255:
        return None
    # level-sorted renumbering: all of level d ahead of level d+1;
    # unreached vertices go last
    key = np.where(finite, dist, np.inf)
    order = np.lexsort((np.arange(n), key))
    perm = np.empty(n, np.int64)
    perm[order] = np.arange(n)
    return perm.astype(np.int32)


def relabeled(csr: CsrGraph) -> Tuple[CsrGraph, Optional[np.ndarray]]:
    """(csr', perm) where csr' = apply_perm(csr, perm), or (csr, None)
    when relabeling isn't worthwhile.  Skewed graphs get the degree
    order (region skip + packing density); near-uniform DEEP graphs
    get the breadth-first order (wavefront locality).  Cached per
    CsrGraph (the permuted graph is itself the key for the downstream
    plan caches, so it must be stable)."""
    hit = _relabel_cache.get(csr)
    if hit is not None:
        return hit
    with trace.span("gt.setup.relabel"):
        if worth_relabeling(csr):
            perm = degree_perm(csr)
            out = (apply_perm(csr, perm), perm)
        else:
            perm = None
            if csr.num_nodes >= 2 * 65536 and os.environ.get(
                    "GT_BFS_RELABEL", "1") != "0":
                perm = bfs_order_perm(csr)
            out = ((apply_perm(csr, perm), perm) if perm is not None
                   else (csr, None))
    _relabel_cache[csr] = out
    return out


_comp_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def component_labels(csr: CsrGraph) -> np.ndarray:
    """(n,) int32 connected-component labels (undirected sense), host
    side, cached per graph (scipy's union-find)."""
    hit = _comp_cache.get(csr)
    if hit is not None:
        return hit
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    with trace.span("gt.setup.components"):
        n, m = csr.num_nodes, csr.num_edges
        a = csr_matrix((np.ones(m, np.int8), csr.col_indices,
                        csr.row_offsets), shape=(n, n))
        _, comp = connected_components(a, directed=False)
        comp = comp.astype(np.int32)
    _comp_cache[csr] = comp
    return comp


_sym_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def is_symmetric(csr: CsrGraph) -> bool:
    """True iff the adjacency equals its transpose.  Cached: the
    transpose build is an O(m log m) sort and callers probe this once
    per source."""
    hit = _sym_cache.get(csr)
    if hit is not None:
        return hit
    with trace.span("gt.setup.symmetry"):
        csc = csr.transposed()
        out = (csc.row_offsets.shape == csr.row_offsets.shape
               and bool(np.array_equal(csc.row_offsets, csr.row_offsets))
               and bool(np.array_equal(csc.col_indices, csr.col_indices)))
    _sym_cache[csr] = out
    return out


def reach_words_for(csr: CsrGraph, src: int, n_words: int) -> np.ndarray:
    """(n_words//128, 128) int32 word bitmap of the vertices a BFS from
    `src` could ever claim: the source's connected component when the
    graph is symmetric, else every vertex with an in-edge (safe
    superset).  Used for the destination-side region skip."""
    n = csr.num_nodes
    if is_symmetric(csr):
        comp = component_labels(csr)
        mask = comp == comp[int(src)]
    else:
        mask = np.zeros(n, bool)
        mask[csr.col_indices] = True
        mask[int(src)] = True
    bits = np.zeros(n_words * 32, np.uint8)
    bits[:n] = mask
    return np.packbits(bits, bitorder="little").view(
        np.int32).reshape(-1, 128)
