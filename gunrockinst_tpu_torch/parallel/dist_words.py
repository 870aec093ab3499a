"""Boundary-exchange distributed primitives: dst-owned partitioning.

Counterpart of the JAX package's `parallel/dist_words.py`, run SPMD:
every rank calls the same function with the same arguments and works on
its own shard.

  * vertices are range-partitioned by DESTINATION: rank k owns the dst
    range [k*n_loc, (k+1)*n_loc) and ALL in-edges of those dsts, so
    label/distance/rank updates of owned vertices complete locally: no
    scatter crosses ranks.
  * the only per-level exchange is the owned slice of the next frontier
    BITMAP (n_loc/32 words) or of a value vector (n_loc values), put
    together on every rank by one all_gather in rank order.  The
    modelled per-rank egress (`ici_bytes`, `traffic`) keeps the JAX
    package's formulas, counted here in Python ints (which do not wrap).

The rank primitives that accumulate into sources (BC's backward pass,
HITS, SALSA, MIS, WTF) also hold a SRC-owned copy of the edges over the
same ownership ranges (`_src_owned_edges`).  Loops are host loops whose
condition is read from state that every rank holds after the gather
(one host read a level or round).

Integer combines are order-free, so the integer outputs are the same at
every rank count P.  Float sums add each owned slot's real edges in CSR
order (`SlotSums`, the padding edges in a slot of their own), the same
items in the same order at every P: on the CPU the float outputs are
the same bits at every P; on the card they were for rmat-s20 undirected
and allclose for the directed graph.  Each rank returns
what the JAX output's `out_specs` give it: its owned n_loc slice for a
P('e') output, the replicated value for a P() one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.ops.segment import (SlotSums, scatter_max,
                                               scatter_min, scatter_or)
from gunrockinst_tpu_torch.ops.words import pack_bitmap
from gunrockinst_tpu_torch.parallel.mesh import EdgeMesh

INT_MAX = int(np.iinfo(np.int32).max)
INT_MIN = int(np.iinfo(np.int32).min)
MAXD = 64                   # BC's forward-level cap (asserted)
MST_ROUNDS = 64             # MST's round cap
EDGE_CHUNK = 1 << 22        # edges a partition builder streams at a time


@dataclasses.dataclass(frozen=True, eq=False)
class DstShardedGraph:
    """One rank's shard of the edges partitioned by destination owner:
    its m_loc edges (the JAX package's P('e') arrays, rank k's slice
    [k*m_loc, (k+1)*m_loc)), dummy-padded with (n -> n) edges (src n is
    never in a frontier; dst n maps to local slot n_loc-1)."""

    n: int
    m: int
    n_loc: int
    m_loc: int
    n_devices: int

    edge_src: torch.Tensor     # (m_loc,) int32 GLOBAL src ids
    edge_dst_l: torch.Tensor   # (m_loc,) int32 LOCAL dst ids [0, n_loc)
    edge_w: torch.Tensor       # (m_loc,) float32
    out_degree: torch.Tensor   # (n_loc,) int32 out-degree of owned verts

    @property
    def n_pad(self) -> int:
        return self.n_loc * self.n_devices

    @property
    def n_words(self) -> int:
        return self.n_pad // 32


def _pad_loc(count: int) -> int:
    return -(-max(count, 1) // 128) * 128


def _col_chunks(csr: CsrGraph, dev: torch.device):
    """(first edge id, col ids) of `csr`'s edges, EDGE_CHUNK at a time,
    each chunk copied to `dev` as the caller asks for the next."""
    col = np.asarray(csr.col_indices)
    for e0 in range(0, col.shape[0], EDGE_CHUNK):
        yield e0, torch.from_numpy(col[e0: e0 + EDGE_CHUNK]).to(dev)


def shard_graph_by_dst(csr: CsrGraph, mesh: EdgeMesh) -> DstShardedGraph:
    """This rank's shard of `csr` partitioned by dst range.  n_loc is
    lane-and-word aligned (a multiple of 128*32 = 4096) so each rank's
    frontier slice packs to whole words.  The rank's edges are those
    whose dst it owns, in CSR order (the JAX package's stable sort by
    owner, taken one owner at a time).  The col ids stream through the
    rank's device EDGE_CHUNK at a time, twice (the owners' counts, then
    the rank's edges), so its device holds its m_loc edges, the row
    offsets and one chunk's temporaries, never all m edges."""
    d, me, dev = mesh.size, mesh.rank, mesh.device
    n, m = csr.num_nodes, csr.num_edges
    n_loc = -(-(n + 1) // (4096 * d)) * 4096
    counts = torch.zeros(d, dtype=torch.int64, device=dev)
    for _, col in _col_chunks(csr, dev):
        counts += torch.bincount(col // n_loc, minlength=d)
    m_loc = _pad_loc(int(counts.max()))
    ro = torch.from_numpy(np.asarray(csr.row_offsets, np.int64)).to(dev)
    vals = (None if csr.edge_values is None
            else np.asarray(csr.edge_values))
    es = torch.full((m_loc,), n, dtype=torch.int32, device=dev)
    ed = torch.full((m_loc,), n_loc - 1, dtype=torch.int32, device=dev)
    ew = torch.zeros(m_loc, dtype=torch.float32, device=dev)
    c = 0
    for e0, col in _col_chunks(csr, dev):
        sel = torch.nonzero(col // n_loc == me).squeeze(1)
        k = sel.shape[0]
        es[c: c + k] = torch.searchsorted(ro, sel + e0, right=True) - 1
        ed[c: c + k] = col[sel] - me * n_loc
        if vals is not None:
            w = torch.from_numpy(vals[e0: e0 + EDGE_CHUNK]).to(dev)
            ew[c: c + k] = w.to(torch.float32)[sel]
        c += k
    if vals is None:
        ew[:c] = 1.0
    lo, hi = min(me * n_loc, n), min((me + 1) * n_loc, n)
    deg = torch.zeros(n_loc, dtype=torch.int32, device=dev)
    deg[: hi - lo] = ro[lo + 1: hi + 1] - ro[lo: hi]
    return DstShardedGraph(n=n, m=m, n_loc=n_loc, m_loc=m_loc, n_devices=d,
                           edge_src=es, edge_dst_l=ed, edge_w=ew,
                           out_degree=deg)


def _pack_words(bits: torch.Tensor, n_words_loc: int) -> torch.Tensor:
    """(n_loc,) bool -> (n_words_loc,) int32 little-endian bit words."""
    return pack_bitmap(bits, n_words_loc).reshape(-1)


def _frontier_bit(words: torch.Tensor, vids: torch.Tensor) -> torch.Tensor:
    """Replicated word map -> per-item bit (0/1) for GLOBAL ids."""
    return (words[vids >> 5] >> (vids & 31)) & 1


def _start_words(n_words: int, s: int, dev) -> torch.Tensor:
    """The word map holding only vertex s (bit 31 makes a word
    negative)."""
    fw = torch.zeros(n_words, dtype=torch.int32, device=dev)
    fw[s >> 5] = int(np.array([1 << (s & 31)], np.uint32).view(np.int32)[0])
    return fw


def _owned_start(n_loc: int, s: int, me: int, hit, miss, dtype, dev):
    """(n_loc,) `miss` with `hit` at the source's slot if this rank owns
    it."""
    out = torch.full((n_loc,), miss, dtype=dtype, device=dev)
    if s // n_loc == me:
        out[s % n_loc] = hit
    return out


def _owned_sums(ids: torch.Tensor, pad: torch.Tensor, n_loc: int):
    """Fixed-order float sums into the n_loc owned slots; the padding
    edges (`pad`) sum into a slot of their own, so each owned slot adds
    exactly its real edges, in CSR order, at every rank count."""
    sums = SlotSums(torch.where(pad, n_loc, ids), n_loc + 1)
    return lambda vals: sums(vals)[:n_loc]


def _check(graph, mesh: EdgeMesh) -> None:
    if graph.n_devices != mesh.size:
        raise ValueError(f"the graph was partitioned for {graph.n_devices} "
                         f"ranks, the mesh has {mesh.size}")


def bfs_dist_words(graph: DstShardedGraph, src: int, mesh: EdgeMesh,
                   mark_preds: bool = True):
    """Distributed BFS with bitmap-only boundary exchange.

    Per level, per rank: gather frontier bits for local edges' srcs from
    the replicated word map, scatter-max into OWNED dst labels, pack the
    owned `new` bits to words, all_gather the word slices.  Returns
    (labels (n_loc,) owned, preds (n_loc,) owned, depth, ici_bytes: the
    modelled per-rank egress)."""
    _check(graph, mesh)
    n_loc, n_words, dev = graph.n_loc, graph.n_words, mesh.device
    nwl = n_loc // 32
    esrc, edst_l = graph.edge_src, graph.edge_dst_l
    labels = _owned_start(n_loc, src, mesh.rank, 0, INT_MAX, torch.int32,
                          dev)
    preds = torch.full((n_loc,), -1, dtype=torch.int32, device=dev)
    fw = _start_words(n_words, src, dev)
    no_label = torch.full((n_loc,), INT_MAX, dtype=torch.int32, device=dev)
    none = torch.zeros(n_loc, dtype=torch.bool, device=dev)
    depth = traffic = 0
    while depth <= graph.n and bool(fw.any()):
        active = _frontier_bit(fw, esrc).to(torch.bool)
        cand = active & (labels[edst_l] == INT_MAX)
        touched = scatter_or(none, edst_l, cand)
        newf = touched & (labels == INT_MAX)
        labels = torch.where(newf, depth + 1, labels)
        if mark_preds:
            pmin = scatter_min(no_label, edst_l,
                               torch.where(cand, esrc, INT_MAX))
            preds = torch.where(newf, pmin, preds)
        # the ONLY cross-rank exchange: owned new-frontier words
        fw = mesh.gather(_pack_words(newf, nwl))
        depth += 1
        traffic += nwl * 4
    return labels, preds, depth, traffic


def dobfs_dist_words(graph: DstShardedGraph, src: int, mesh: EdgeMesh,
                     alpha: float = 6.0, beta: float = 2.0,
                     mark_preds: bool = True):
    """Distributed direction-optimized BFS with a real pull.

      * push: gather frontier bits for edge SOURCES, scatter-max/min
        into owned dsts (the bfs_dist_words advance).
      * pull: a segment-min over the in-edges of each OWNED dst (min
        frontier parent), masked to the unvisited ones: no scatter into
        a frontier, the reference's backward kernel's shape
        (edge_map_backward/cta.cuh:91-331).

    The Beamer switch compares the alpha-weighted frontier out-edge
    volume with the unvisited in-edge volume (dobfs_enactor.cuh:397);
    once in pull it stays there while the frontier holds at least
    nodes/beta vertices, and a pull->push exit is final (:569).  The
    three volumes are summed over the ranks in int64 (exact) and
    compared in float32 as the JAX package compares its float32 sums;
    that one reduce a level is also the loop's condition (the frontier
    is empty iff its count is 0).  Labels and preds equal
    bfs_dist_words' in both directions (min-id tie-break).

    Returns (labels, preds, depth, pull_levels, ici_bytes/rank)."""
    _check(graph, mesh)
    n_loc, n_words, dev, me = graph.n_loc, graph.n_words, mesh.device, \
        mesh.rank
    nwl = n_loc // 32
    esrc, edst_l = graph.edge_src, graph.edge_dst_l
    lid = torch.arange(n_loc, dtype=torch.int32, device=dev)
    labels = _owned_start(n_loc, src, me, 0, INT_MAX, torch.int32, dev)
    preds = torch.full((n_loc,), -1, dtype=torch.int32, device=dev)
    fw = _start_words(n_words, src, dev)
    # in-degree of owned dsts (dummy edges excluded)
    indeg_own = torch.zeros(n_loc, dtype=torch.int64, device=dev).index_add_(
        0, edst_l, (esrc != graph.n).to(torch.int64))
    outdeg_own = graph.out_degree.to(torch.int64)
    no_label = torch.full((n_loc,), INT_MAX, dtype=torch.int32, device=dev)
    none = torch.zeros(n_loc, dtype=torch.bool, device=dev)
    f32 = np.float32
    depth = pulls = traffic = 0
    was_pull = left_pull = False
    while depth <= graph.n:
        unvis = labels == INT_MAX
        own_w = mesh.own(fw, nwl)
        fbit = ((own_w[lid >> 5] >> (lid & 31)) & 1) == 1
        stats = torch.stack((torch.where(fbit, outdeg_own, 0).sum(),
                             torch.where(unvis, indeg_own, 0).sum(),
                             fbit.sum().to(torch.int64)))
        f_edges, u_edges, n_front = mesh.reduce(stats, "sum").tolist()
        if n_front == 0:
            break
        use_pull = not left_pull and (
            f32(f_edges) * f32(alpha) > f32(u_edges)
            or (was_pull and f32(n_front) >= f32(graph.n) / f32(beta)))
        if use_pull:
            # per OWNED dst: min frontier in-parent, no scatter
            pv = torch.where(_frontier_bit(fw, esrc) == 1, esrc, INT_MAX)
            seg = scatter_min(no_label, edst_l, pv)
            pmin = torch.where(unvis, seg, INT_MAX)
            touched = pmin != INT_MAX
        else:
            active = _frontier_bit(fw, esrc).to(torch.bool)
            cand = active & unvis[edst_l]
            touched = scatter_or(none, edst_l, cand)
            pmin = scatter_min(no_label, edst_l,
                               torch.where(cand, esrc, INT_MAX))
        newf = touched & unvis
        labels = torch.where(newf, depth + 1, labels)
        if mark_preds:
            preds = torch.where(newf, pmin, preds)
        fw = mesh.gather(_pack_words(newf, nwl))
        depth += 1
        pulls += int(use_pull)
        left_pull = left_pull or (was_pull and not use_pull)
        was_pull = use_pull
        traffic += nwl * 4
    return labels, preds, depth, pulls, traffic


def sssp_dist_words(graph: DstShardedGraph, src: int, mesh: EdgeMesh):
    """Distributed SSSP: local scatter-min relaxations into owned
    distances, then an all_gather of the owned DISTANCE slices (n_loc*4
    bytes a rank).  Bitwise equal to the single-device Bellman fixpoint.
    A round changed something iff the gathered vector differs from the
    last one.  Returns (dist (n_loc,) owned, rounds, ici_bytes/rank)."""
    _check(graph, mesh)
    n_loc, n_pad, dev = graph.n_loc, graph.n_pad, mesh.device
    esrc, edst_l, w = graph.edge_src, graph.edge_dst_l, graph.edge_w
    inf = float("inf")
    dist_g = torch.full((n_pad,), inf, dtype=torch.float32, device=dev)
    dist_g[src] = 0.0
    far = torch.full((n_loc,), inf, dtype=torch.float32, device=dev)
    dummy = esrc == graph.n
    changed, it, traffic = True, 0, 0
    while changed and it < 4 * graph.n + 8:
        vals = torch.where(dummy, inf, dist_g[esrc] + w)
        relaxed = scatter_min(far, edst_l, vals)
        new_own = torch.minimum(mesh.own(dist_g, n_loc), relaxed)
        # exchange: owned distance slices only
        new_g = mesh.gather(new_own)
        changed = bool((new_g != dist_g).any())
        dist_g = new_g
        it += 1
        traffic += n_loc * 4
    return mesh.own(dist_g, n_loc), it, traffic


def cc_dist_words(graph: DstShardedGraph, mesh: EdgeMesh):
    """Distributed CC: min-label propagation with owned-slice exchange.

    Pass a SYMMETRIZED graph.  Per round, per rank: candidates only from
    sources whose label changed last round (changed-word gating, exact:
    min is monotone), scatter-min into owned labels, then all_gather of
    the owned label slices and the owned changed words (n_loc*4 +
    n_loc/8 bytes a rank).  Converges to the min vertex id per
    component.  Returns (comp (n_loc,) owned, rounds, ici_bytes/rank)."""
    _check(graph, mesh)
    n_loc, n_pad, dev = graph.n_loc, graph.n_pad, mesh.device
    nwl = n_loc // 32
    esrc, edst_l = graph.edge_src, graph.edge_dst_l
    comp_g = torch.arange(n_pad, dtype=torch.int32, device=dev)
    cw = torch.full((graph.n_words,), -1, dtype=torch.int32, device=dev)
    no_label = torch.full((n_loc,), INT_MAX, dtype=torch.int32, device=dev)
    real = esrc != graph.n
    it = traffic = 0
    while it < graph.n + 2 and bool(cw.any()):
        active = _frontier_bit(cw, esrc).to(torch.bool)
        cand = torch.where(active & real, comp_g[esrc], INT_MAX)
        relaxed = scatter_min(no_label, edst_l, cand)
        own = mesh.own(comp_g, n_loc)
        new_own = torch.minimum(own, relaxed)
        changed_own = new_own < own
        comp_g = mesh.gather(new_own)
        cw = mesh.gather(_pack_words(changed_own, nwl))
        it += 1
        traffic += n_loc * 4 + nwl * 4
    return mesh.own(comp_g, n_loc), it, traffic


def _src_owned_edges(csr: CsrGraph, n_loc: int, d: int, gn: int,
                     mesh: EdgeMesh):
    """This rank's SRC-owned copy of the edges over the same ownership
    ranges as `shard_graph_by_dst`: rank k holds the out-edges of
    vertices [k*n_loc, (k+1)*n_loc) as (local src id, GLOBAL dst id), a
    contiguous range of the CSR.  Dummy padding: local src slot n_loc-1,
    global dst id `gn`; kernels must mask on `dst != gn` before
    accumulating into the local src slot.
    Returns (src_local (m_loc2,), dst_global (m_loc2,), m_loc2)."""
    if d != mesh.size:
        raise ValueError(f"{d} owners on a mesh of {mesh.size} ranks")
    n, me, dev = csr.num_nodes, mesh.rank, mesh.device
    ro = np.asarray(csr.row_offsets, dtype=np.int64)
    bounds = np.minimum(np.arange(d + 1, dtype=np.int64) * n_loc, n)
    counts = ro[bounds[1:]] - ro[bounds[:-1]]
    m_loc2 = _pad_loc(int(counts.max()))
    v0, v1 = int(bounds[me]), int(bounds[me + 1])
    e0, e1 = int(ro[v0]), int(ro[v1])
    deg = torch.from_numpy(np.diff(ro[v0: v1 + 1])).to(dev)
    bs = torch.full((m_loc2,), n_loc - 1, dtype=torch.int32, device=dev)
    bd = torch.full((m_loc2,), gn, dtype=torch.int32, device=dev)
    bs[: e1 - e0] = torch.repeat_interleave(
        torch.arange(v1 - v0, dtype=torch.int32, device=dev), deg,
        output_size=e1 - e0)
    bd[: e1 - e0] = torch.from_numpy(
        np.ascontiguousarray(csr.col_indices[e0:e1])).to(dev, torch.int32)
    return bs, bd, m_loc2


def bc_dist_words(csr: CsrGraph, src: int, mesh: EdgeMesh):
    """Distributed betweenness centrality with word exchange in BOTH
    passes.  Forward (Brandes sigma counts) on the dst-owned partition:
    exchange = owned sigma slices + frontier words a level.  Backward
    (delta accumulation into SOURCES) on the src-owned copy: exchange =
    owned delta slices a level.  The forward pass is capped at MAXD
    levels and asserted below it.
    Returns (bc (n,) np.float32 on every rank, depth, ici_bytes/rank)."""
    g = shard_graph_by_dst(csr, mesh)
    n_loc, n_pad, n_words = g.n_loc, g.n_pad, g.n_words
    nwl = n_loc // 32
    n, GN, me, dev = csr.num_nodes, g.n, mesh.rank, mesh.device
    bsrc_loc, bdst_glob, _ = _src_owned_edges(csr, n_loc, g.n_devices, GN,
                                              mesh)
    esrc, edst_l = g.edge_src, g.edge_dst_l
    sums_d = _owned_sums(edst_l, esrc == GN, n_loc)
    sums_b = _owned_sums(bsrc_loc, bdst_glob == GN, n_loc)
    own_src = src // n_loc == me

    # ---- forward: levels of sigma accumulation ----
    labels = _owned_start(n_loc, src, me, 0, INT_MAX, torch.int32, dev)
    sigma_g = mesh.gather(_owned_start(n_loc, src, me, 1.0, 0.0,
                                       torch.float32, dev))
    fw = _start_words(n_words, src, dev)
    none = torch.zeros(n_loc, dtype=torch.bool, device=dev)
    depth = traffic = 0
    while depth < MAXD and bool(fw.any()):
        active = _frontier_bit(fw, esrc).to(torch.bool)
        cand = active & (labels[edst_l] == INT_MAX)
        touched = scatter_or(none, edst_l, cand)
        newf = touched & (labels == INT_MAX)
        labels = torch.where(newf, depth + 1, labels)
        part = sums_d(torch.where(cand, sigma_g[esrc], 0.0))
        sig_own = torch.where(newf, part, mesh.own(sigma_g, n_loc))
        sigma_g = mesh.gather(sig_own)
        fw = mesh.gather(_pack_words(newf, nwl))
        depth += 1
        traffic += nwl * 4 + n_loc * 4

    # ---- backward: delta accumulation on the src-owned shard ----
    labels_g = mesh.gather(labels)
    traffic += n_loc * 4   # one labels exchange
    bdst_c = torch.clamp(bdst_glob, max=n_pad - 1)
    src_g_ids = me * n_loc + bsrc_loc
    lsrc_g = labels_g[src_g_ids]
    ldst_g = torch.where(bdst_glob == GN, INT_MAX, labels_g[bdst_c])
    sig_src, sig_dst = sigma_g[src_g_ids], sigma_g[bdst_c]
    ratio = torch.where(sig_dst > 0,
                        sig_src / torch.clamp(sig_dst, min=1.0), 0.0)
    delta_g = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    for lvl in range(depth - 1, -1, -1):
        on = (lsrc_g == lvl) & (ldst_g == lvl + 1)
        contrib = torch.where(on, ratio * (1.0 + delta_g[bdst_c]), 0.0)
        d_own = mesh.own(delta_g, n_loc) + sums_b(contrib)
        delta_g = mesh.gather(d_own)
        traffic += n_loc * 4
    d_own = mesh.own(delta_g, n_loc)
    # Brandes excludes the source's own dependency (bc.py:89)
    if own_src:
        d_own = d_own.clone()
        d_own[src % n_loc] = 0.0
    if depth >= MAXD:
        raise AssertionError("bc_dist_words: depth exceeded MAXD")
    bc = mesh.gather(d_own)[:n].cpu().numpy() * np.float32(0.5)
    return bc.astype(np.float32), depth, traffic


def pagerank_dist_words(graph: DstShardedGraph, mesh: EdgeMesh,
                        delta: float = 0.85, threshold: float = 0.01,
                        max_iter: int = 50):
    """Distributed Gunrock-semantics PageRank: owned-dst partial sums
    complete locally; one all_gather of the owned rank slices and one of
    the owned active words an iteration.  Returns (rank (n_loc,) owned,
    ici_bytes/rank)."""
    _check(graph, mesh)
    n_loc, n_pad, n, dev = graph.n_loc, graph.n_pad, graph.n, mesh.device
    nwl = n_loc // 32
    esrc, edst_l, deg_own = graph.edge_src, graph.edge_dst_l, \
        graph.out_degree
    sums = _owned_sums(edst_l, esrc == n, n_loc)
    gid = mesh.rank * n_loc + torch.arange(n_loc, dtype=torch.int32,
                                           device=dev)
    real_own = gid < n
    # the global degree map for src-side contrib reads (one-time)
    deg_g = mesh.gather(deg_own)
    degf_g = torch.clamp(deg_g.to(torch.float32), min=1.0)
    real_g = torch.arange(n_pad, dtype=torch.int32, device=dev) < n
    rank_g = torch.where(real_g, 1.0 - delta, 0.0).to(torch.float32)
    aw = mesh.gather(_pack_words((deg_own > 0) & real_own, nwl))
    src_ok = (deg_g[esrc] > 0) & (esrc != n)
    live_own = deg_own > 0
    it = traffic = 0
    while it < max_iter and bool(aw.any()):
        contrib_g = torch.where(deg_g > 0, rank_g / degf_g, 0.0)
        ok = _frontier_bit(aw, esrc).to(torch.bool) & src_ok
        part = sums(torch.where(ok, contrib_g[esrc], 0.0))
        part = torch.where(live_own, part, 0.0)  # dead-end filter
        nxt_own = torch.where(real_own, delta * part + (1.0 - delta), 0.0)
        old_own = mesh.own(rank_g, n_loc)
        act_own = ((nxt_own - old_own).abs() > threshold) & real_own
        # exchange: owned rank slice + owned active words
        rank_g = mesh.gather(nxt_own)
        aw = mesh.gather(_pack_words(act_own, nwl))
        it += 1
        traffic += n_loc * 4 + nwl * 4
    return mesh.own(rank_g, n_loc), traffic


# --------------------------------------------------------------------
# word/slice exchange for the rest of the primitives (HITS / SALSA /
# WTF / MIS / TopK / MST).  Rank primitives accumulate into BOTH
# endpoints, so each rank holds the dst-owned shard AND a src-owned
# shard over the same ownership ranges: every scatter lands in owned
# state and the only exchange is an all_gather of owned n_loc slices
# (or n_loc/32 words).
# --------------------------------------------------------------------


def _both(csr: CsrGraph, mesh: EdgeMesh):
    g = shard_graph_by_dst(csr, mesh)
    bsrc_loc, bdst_glob, _ = _src_owned_edges(csr, g.n_loc, g.n_devices,
                                              g.n, mesh)
    return g, bsrc_loc, bdst_glob


def _indeg_own(g: DstShardedGraph) -> torch.Tensor:
    return torch.zeros(g.n_loc, dtype=torch.int32,
                       device=g.edge_src.device).index_add_(
        0, g.edge_dst_l, (g.edge_src != g.n).to(torch.int32))


def hits_dist_words(csr: CsrGraph, mesh: EdgeMesh, src: int = 0,
                    delta: float = 0.85, max_iter: int = 50):
    """Distributed HITS with owned-slice exchange (primitives/hits.py
    semantics).  Per iteration: auth partial sums on the dst-owned shard,
    all_gather of the owned auth; hub partial sums on the src-owned
    shard, all_gather of the owned hub (2*n_loc*4 bytes a rank).
    Returns (hub (n_pad,), auth (n_pad,), ici_bytes/rank), replicated."""
    g, bsrc_loc, bdst_glob = _both(csr, mesh)
    n_loc, n_pad, GN, dev = g.n_loc, g.n_pad, g.n, mesh.device
    esrc, edst_l = g.edge_src, g.edge_dst_l
    sums_d = _owned_sums(edst_l, esrc == GN, n_loc)
    sums_b = _owned_sums(bsrc_loc, bdst_glob == GN, n_loc)
    # one-time replicated degree maps (counted in the byte model)
    so_g = torch.clamp(mesh.gather(g.out_degree).to(torch.float32), min=1.0)
    si_g = torch.clamp(mesh.gather(_indeg_own(g)).to(torch.float32),
                       min=1.0)
    src_g_ids = mesh.rank * n_loc + bsrc_loc
    is_src_e = (src_g_ids == src).to(torch.float32)
    valid_b = bdst_glob != GN
    bdst_c = torch.clamp(bdst_glob, max=n_pad - 1)
    real_d = esrc != GN
    so_src = so_g[esrc]
    jump = is_src_e * delta / so_g[src_g_ids]
    si_dst = si_g[bdst_c]
    hub_g = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    traffic = 2 * n_loc * 4
    for _ in range(max_iter):
        # auth sweep: all in-edges of owned dsts are local
        auth_g = mesh.gather(sums_d(torch.where(
            real_d, hub_g[esrc] / so_src, 0.0)))
        # hub sweep: all out-edges of owned srcs are local
        per_edge = jump + (1.0 - delta) * auth_g[bdst_c] / si_dst
        hub_g = mesh.gather(sums_b(torch.where(valid_b, per_edge, 0.0)))
        traffic += 2 * n_loc * 4
    if max_iter == 0:
        auth_g = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    return hub_g, auth_g, traffic


def salsa_dist_words(csr: CsrGraph, mesh: EdgeMesh, max_iter: int = 50):
    """Distributed SALSA with owned-slice exchange (primitives/
    salsa.py).  Four partial sums an iteration, two into dsts (dst-owned
    shard), two into srcs (src-owned shard), each followed by an
    owned-slice all_gather: 4*n_loc*4 bytes a rank an iteration.
    Returns (hub (n_pad,), auth (n_pad,), ici_bytes/rank), replicated."""
    g, bsrc_loc, bdst_glob = _both(csr, mesh)
    n_loc, n_pad, GN, dev = g.n_loc, g.n_pad, g.n, mesh.device
    esrc, edst_l = g.edge_src, g.edge_dst_l
    sums_d = _owned_sums(edst_l, esrc == GN, n_loc)
    sums_b = _owned_sums(bsrc_loc, bdst_glob == GN, n_loc)
    outdeg_g = mesh.gather(g.out_degree).to(torch.float32)
    indeg_g = mesh.gather(_indeg_own(g)).to(torch.float32)
    so, si = torch.clamp(outdeg_g, min=1.0), torch.clamp(indeg_g, min=1.0)
    out_nodes = torch.clamp((outdeg_g > 0).to(torch.float32).sum(), min=1.0)
    in_nodes = torch.clamp((indeg_g > 0).to(torch.float32).sum(), min=1.0)
    ar = torch.arange(n_pad, device=dev)
    # strictly < GN: the dummy vertex GN keeps pad state 0
    hub = torch.where(ar < GN, 1.0 / out_nodes, 0.0).to(torch.float32)
    auth = torch.where(ar < GN, 1.0 / in_nodes, 0.0).to(torch.float32)
    valid_b = bdst_glob != GN
    bdst_c = torch.clamp(bdst_glob, max=n_pad - 1)
    real_d = esrc != GN
    so_src, si_dst = so[esrc], si[bdst_c]
    traffic = 2 * n_loc * 4
    for _ in range(max_iter):
        x = mesh.gather(sums_d(torch.where(real_d, hub[esrc] / so_src,
                                           0.0)))
        new_hub = mesh.gather(sums_b(torch.where(valid_b, x[bdst_c] / si_dst,
                                                 0.0)))
        y = mesh.gather(sums_b(torch.where(valid_b, auth[bdst_c] / si_dst,
                                           0.0)))
        new_auth = mesh.gather(sums_d(torch.where(real_d, y[esrc] / so_src,
                                                  0.0)))
        hub = torch.where(outdeg_g > 0, new_hub, 0.0)
        auth = torch.where(indeg_g > 0, new_auth, 0.0)
        traffic += 4 * n_loc * 4
    return hub, auth, traffic


def mis_dist_words(csr: CsrGraph, mesh: EdgeMesh, priorities):
    """Distributed Luby MIS with owned-slice exchange (primitives/
    mis.py luby_kernel).  Per round: neighbour-max partials land in owned
    SRC state (src-owned shard), exclusion bits in both endpoints (one
    partial per shard, OR'd locally since both are owned): exchange =
    one n_loc*4 slice + one n_loc/32-word bitmap.  `priorities` is
    (n_pad,) int32.
    Returns (state (n_pad,) {0 undecided, 1 in, 2 out} replicated,
    rounds, ici_bytes/rank)."""
    g, bsrc_loc, bdst_glob = _both(csr, mesh)
    n_loc, n_pad, GN, dev = g.n_loc, g.n_pad, g.n, mesh.device
    nwl = n_loc // 32
    esrc, edst_l = g.edge_src, g.edge_dst_l
    prio = torch.as_tensor(priorities, dtype=torch.int32, device=dev)
    ar = torch.arange(n_pad, dtype=torch.int32, device=dev)
    state = torch.where(ar < GN, 0, 2).to(torch.int32)
    valid_b = bdst_glob != GN
    bdst_c = torch.clamp(bdst_glob, max=n_pad - 1)
    src_g_ids = mesh.rank * n_loc + bsrc_loc
    esrc_c = torch.clamp(esrc, max=n_pad - 1)
    prio_dst = prio[bdst_c]
    lowest = torch.full((n_loc,), INT_MIN, dtype=torch.int32, device=dev)
    none = torch.zeros(n_loc, dtype=torch.bool, device=dev)
    r = traffic = 0
    while r <= GN and bool((state == 0).any()):
        und = state == 0
        # neighbour max into owned srcs (src-owned shard, local)
        cand_b = valid_b & und[src_g_ids] & und[bdst_c]
        nbmax_g = mesh.gather(scatter_max(
            lowest, bsrc_loc, torch.where(cand_b, prio_dst, INT_MIN)))
        join = und & (prio >= nbmax_g)
        # exclusion: join[src] excludes dst (dst-owned, local) and
        # join[dst] excludes src (src-owned, local)
        cand_d = (esrc != GN) & und[esrc_c]
        excl_dst = scatter_or(none, edst_l, cand_d & join[esrc_c])
        excl_src = scatter_or(none, bsrc_loc, cand_b & join[bdst_c])
        ew = mesh.gather(_pack_words(excl_dst | excl_src, nwl))
        excl = _frontier_bit(ew, ar) == 1
        state = torch.where(join, 1, torch.where(und & excl, 2, state)).to(
            torch.int32)
        r += 1
        traffic += n_loc * 4 + nwl * 4
    return state, r, traffic


def _two_key_order(key: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The order of (key, id) pairs, both int32 and ids >= 0, as one
    int64 key (the JAX package's two-key sort)."""
    return torch.argsort((key.to(torch.int64) << 32) | ids.to(torch.int64))


def topk_dist_words(csr: CsrGraph, mesh: EdgeMesh, k: int):
    """Distributed top-K degree centrality with candidate exchange
    (primitives/topk.py).  In-degrees of owned dsts are local; each rank
    sorts its OWNED centrality slice by (-centrality, id) and exchanges
    only its top-k candidates: 8k bytes a rank.  The union of the
    owners' top-k holds the global top-k.
    Returns (ids (k,), centralities (k,), ici_bytes/rank), replicated."""
    g = shard_graph_by_dst(csr, mesh)
    n_loc, GN, dev = g.n_loc, g.n, mesh.device
    kk = min(k, n_loc)
    gid = mesh.rank * n_loc + torch.arange(n_loc, dtype=torch.int32,
                                           device=dev)
    # negated key directly: padding gets INT_MAX so it sorts last
    negc = torch.where(gid < GN, -(_indeg_own(g) + g.out_degree), INT_MAX)
    # the slots are in id order, so a stable sort keeps ties by id
    order = torch.sort(negc, stable=True).indices[:kk]
    cand_c = mesh.gather(negc[order])
    cand_i = mesh.gather(gid[order])
    fin = _two_key_order(cand_c, cand_i)
    return cand_i[fin][:k], (-cand_c[fin])[:k], kk * 8


def wtf_dist_words(csr: CsrGraph, mesh: EdgeMesh, src: int = 0,
                   alpha: float = 0.2, delta: float = 0.85,
                   threshold: float = 0.01, cot_size: int = 1000,
                   max_iter: int = 50):
    """Distributed Who-To-Follow with owned-slice exchange (primitives/
    wtf.py phases).  The dangling-degree fixpoint and SALSA rank_next
    accumulate into srcs (src-owned shard); personalized PR and ref_next
    into dsts (dst-owned shard); every round exchanges only the owned
    n_loc slice.  The circle of trust is sorted on every rank from the
    gathered PPR vector, by (-ppr, id).
    Returns (rank (n_pad,), ppr (n_pad,), ici_bytes/rank), replicated."""
    g, bsrc_loc, bdst_glob = _both(csr, mesh)
    n_loc, n_pad, GN, me, dev = g.n_loc, g.n_pad, g.n, mesh.rank, \
        mesh.device
    esrc, edst_l = g.edge_src, g.edge_dst_l
    sums_d = _owned_sums(edst_l, esrc == GN, n_loc)
    sums_b = _owned_sums(bsrc_loc, bdst_glob == GN, n_loc)
    salsa_iters = int(1.0 / alpha)
    ar = torch.arange(n_pad, dtype=torch.int32, device=dev)
    real = ar < GN
    valid_b = bdst_glob != GN
    bdst_c = torch.clamp(bdst_glob, max=n_pad - 1)
    src_g_ids = me * n_loc + bsrc_loc
    esrc_c = torch.clamp(esrc, max=n_pad - 1)
    outdeg_g = mesh.gather(g.out_degree)
    so = torch.clamp(outdeg_g.to(torch.float32), min=1.0)

    # dangling-removal fixpoint (pr.effective_degrees): out-degree
    # recounts accumulate into owned srcs -> slice exchange
    deg_g, changed, traffic = outdeg_g, True, n_loc * 4
    while changed:
        live = valid_b & (deg_g[bdst_c] > 0) & (deg_g[src_g_ids] > 0)
        nd_own = torch.zeros(n_loc, dtype=torch.int32, device=dev).index_add_(
            0, bsrc_loc, live.to(torch.int32))
        nd_own = torch.where(mesh.own(deg_g, n_loc) > 0, nd_own, 0)
        nd_g = mesh.gather(nd_own)
        changed = bool((nd_g != deg_g).any())
        deg_g = nd_g
        traffic += n_loc * 4
    degf = torch.clamp(deg_g.to(torch.float32), min=1.0)

    # phase 1: personalized PR, partials into owned dsts
    personal = (ar == src).to(torch.float32)
    ppr_g = torch.where(real, 1.0 - delta, 0.0).to(torch.float32)
    active = (deg_g > 0) & real
    ok = (esrc != GN) & (deg_g[esrc_c] > 0)
    gid = me * n_loc + torch.arange(n_loc, dtype=torch.int32, device=dev)
    live_own = mesh.own(deg_g, n_loc) > 0
    personal_own = personal[torch.clamp(gid, max=n_pad - 1)]
    it = 0
    while it <= max_iter and bool(active.any()):
        contrib = torch.where(active, ppr_g / degf, 0.0)
        part = sums_d(torch.where(ok, contrib[esrc_c], 0.0))
        part = torch.where(live_own, part, 0.0)
        nxt_own = torch.where(
            gid < GN, delta * part + (1.0 - delta) * personal_own, 0.0)
        nxt_g = mesh.gather(nxt_own)
        active = ((nxt_g - ppr_g).abs() > threshold) & real
        ppr_g = nxt_g
        it += 1
        traffic += n_loc * 4

    # phase 2: circle of trust, by (-ppr, id): a stable sort over slots
    # in id order
    sorted_ids = torch.sort(-ppr_g, stable=True).indices
    rank_pos = torch.empty(n_pad, dtype=torch.int64, device=dev)
    rank_pos[sorted_ids] = torch.arange(n_pad, device=dev)
    in_cot = (rank_pos < cot_size) & real

    # phases 3+4: CoT in-degree (dst-owned) + auth/hub loop
    cot_d = (esrc != GN) & in_cot[esrc_c]
    ci_own = torch.zeros(n_loc, dtype=torch.int32, device=dev).index_add_(
        0, edst_l, cot_d.to(torch.int32))
    ci_g = mesh.gather(ci_own)
    traffic += n_loc * 4
    si = torch.clamp(ci_g.to(torch.float32), min=1.0)
    is_src_b = (src_g_ids == src).to(torch.float32)
    cot_b = valid_b & in_cot[src_g_ids]
    jump = is_src_b * alpha / so[src_g_ids]
    si_dst, so_src = si[bdst_c], so[esrc_c]
    z = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    rank_curr, ref_curr, ref_next = z, z, z
    for _ in range(salsa_iters):
        per_edge = jump + (1.0 - alpha) * ref_curr[bdst_c] / si_dst
        rank_next = mesh.gather(sums_b(torch.where(cot_b, per_edge, 0.0)))
        ref_next2 = mesh.gather(sums_d(torch.where(
            cot_d, rank_curr[esrc_c] / so_src, 0.0)))
        rank_curr, ref_curr, ref_next = rank_next, ref_next, ref_next2
        traffic += 2 * n_loc * 4
    return rank_curr, ppr_g, traffic


def mst_weight_keys(w_np: np.ndarray) -> np.ndarray:
    """Order-preserving int32 keys of float32 weights: the sign bit
    flipped for non-negatives, all bits for negatives, so that an
    integer compare is the float compare and a min stays exact."""
    wb = np.ascontiguousarray(w_np, np.float32).view(np.uint32)
    mono = np.where(wb >> 31, ~wb, wb | np.uint32(0x80000000))
    return (mono.astype(np.int64) - 0x80000000).astype(np.int32)


def edge_slice(a: np.ndarray, fill: int, m_loc: int, me: int, dtype,
                dev) -> torch.Tensor:
    out = np.full(m_loc, fill, dtype)
    part = a[me * m_loc: (me + 1) * m_loc]
    out[: part.shape[0]] = part
    return torch.from_numpy(out).to(dev)


def mst_dist_words(esrc_np, edst_np, w_np, n: int, mesh: EdgeMesh):
    """Distributed Boruvka MST with byte-accounted exchange
    (primitives/mst.py semantics over canonical undirected edges).
    Component ids migrate across ownership ranges every contraction, so
    the per-round min-weight/min-edge merge is a replicated exchange:
    pmins over order-preserving int32 weight keys (`mst_weight_keys`),
    each counted at the ring all-reduce cost 2*n_pad*4*(d-1)/d.  A
    compress step's change test reads the replicated labels (no
    collective).  Returns (in_mst (m,) bool, comp (n_pad,), rounds,
    ici_bytes/rank), the arrays as NumPy on every rank."""
    d, me, dev = mesh.size, mesh.rank, mesh.device
    n_pad = -(-(n + 1) // 128) * 128
    m = len(w_np)
    m_loc = -(-max(m, 1) // (128 * d)) * 128
    esrc = edge_slice(np.asarray(esrc_np), n_pad, m_loc, me, np.int32, dev)
    edst = edge_slice(np.asarray(edst_np), n_pad, m_loc, me, np.int32, dev)
    wkv = edge_slice(mst_weight_keys(w_np), INT_MAX, m_loc, me, np.int32,
                      dev)
    rr_bytes = int(2 * n_pad * 4 * max(d - 1, 1) / d)  # per collective
    real_e = esrc < n_pad
    geids = me * m_loc + torch.arange(m_loc, dtype=torch.int32, device=dev)
    cs_idx = torch.clamp(esrc, 0, n_pad - 1)
    cd_idx = torch.clamp(edst, 0, n_pad - 1)
    top = torch.full((n_pad,), INT_MAX, dtype=torch.int32, device=dev)

    comp = torch.arange(n_pad, dtype=torch.int32, device=dev)
    in_mst = torch.zeros(m_loc, dtype=torch.bool, device=dev)
    rounds, go, traffic = 0, True, 0
    while go and rounds < MST_ROUNDS:
        c1, c2 = comp[cs_idx], comp[cd_idx]
        cross = (c1 != c2) & real_e
        wq = torch.where(cross, wkv, INT_MAX)
        minw = mesh.reduce(scatter_min(scatter_min(top, c1, wq), c2, wq),
                           "min")
        at1, at2 = wkv == minw[c1], wkv == minw[c2]
        ach = cross & (at1 | at2)
        sel_l = scatter_min(top, c1, torch.where(ach & at1, geids, INT_MAX))
        sel_l = scatter_min(sel_l, c2, torch.where(ach & at2, geids, INT_MAX))
        sel = mesh.reduce(sel_l, "min")
        in_mst = in_mst | (sel[c1] == geids) | (sel[c2] == geids)
        traffic += 2 * rr_bytes
        # compress: hook and jump over the selected edges to a fixpoint
        while True:
            cs = torch.where(in_mst, comp[cs_idx], INT_MAX)
            cd = torch.where(in_mst, comp[cd_idx], INT_MAX)
            nc = mesh.reduce(scatter_min(scatter_min(comp, cd_idx, cs),
                                         cs_idx, cd), "min")
            nc = nc[nc]
            nc = nc[nc]
            traffic += rr_bytes
            changed = bool((nc != comp).any())
            comp = nc
            if not changed:
                break
        go = bool(mesh.reduce(cross.any().to(torch.int32).reshape(1),
                              "max").item())
        rounds += 1
    in_all = mesh.gather(in_mst.to(torch.uint8)).cpu().numpy()
    return (in_all[:m].astype(bool), comp.cpu().numpy(), rounds, traffic)

