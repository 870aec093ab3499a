"""Distributed versions of the remaining primitives, replicated state.

Counterpart of the JAX package's `parallel/dist_more.py`: over the same
1-D edge partition as `dist.py` (`ShardedGraph`), each is the map of its
single-device kernel with the rank-local scatter-combines merged by one
collective a round.  Integer combines are order-free, so those results
do not depend on the rank count; a float psum (`dist.psum_f32`) sums
in float64 and rounds once, so those are allclose across rank counts
(and nearly always bitwise equal).
Loops are host loops whose condition is read from replicated state.
"""

from __future__ import annotations

import numpy as np
import torch

from gunrockinst_tpu_torch.ops.segment import (SlotSums, scatter_max,
                                               scatter_min, scatter_or)
from gunrockinst_tpu_torch.parallel.dist import psum_f32
from gunrockinst_tpu_torch.parallel.dist_words import MST_ROUNDS, edge_slice
from gunrockinst_tpu_torch.parallel.mesh import EdgeMesh
from gunrockinst_tpu_torch.parallel.partition import ShardedGraph

INT_MAX = 2**31 - 1
INT_MIN = -2**31


def _indeg(mesh: EdgeMesh, esrc, edst, n_pad, dummy):
    part = torch.zeros(n_pad, dtype=torch.int32, device=mesh.device)
    part.index_add_(0, edst, (esrc != dummy).to(torch.int32))
    return mesh.reduce(part, "sum")


def hits_dist(graph: ShardedGraph, mesh: EdgeMesh, src: int = 0,
              delta: float = 0.85, max_iter: int = 50):
    """Distributed HITS (primitives/hits.py semantics): the auth and hub
    scatter-adds are local partials + one psum each an iteration.
    Returns (hub, auth), replicated."""
    n_pad, dev = graph.n_pad, mesh.device
    esrc, edst = graph.edge_src, graph.edge_dst
    sums_d, sums_s = SlotSums(edst, n_pad), SlotSums(esrc, n_pad)
    so = torch.clamp(graph.out_degree.to(torch.float32), min=1.0)
    si = torch.clamp(_indeg(mesh, esrc, edst, n_pad, graph.dummy).to(
        torch.float32), min=1.0)
    jump = (esrc == src).to(torch.float32) * delta / so[esrc]
    so_src, si_dst = so[esrc], si[edst]
    hub = auth = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    for _ in range(max_iter):
        auth = psum_f32(mesh, sums_d, hub[esrc] / so_src)
        per_edge = jump + (1.0 - delta) * auth[edst] / si_dst
        hub = psum_f32(mesh, sums_s, per_edge)
    return hub, auth


def salsa_dist(graph: ShardedGraph, mesh: EdgeMesh, max_iter: int = 50):
    """Distributed SALSA (primitives/salsa.py): four scatter-adds an
    iteration, each a local partial + a psum.  Returns (hub, auth),
    replicated."""
    n_pad, dev = graph.n_pad, mesh.device
    esrc, edst = graph.edge_src, graph.edge_dst
    sums_d, sums_s = SlotSums(edst, n_pad), SlotSums(esrc, n_pad)
    outdeg = graph.out_degree.to(torch.float32)
    indeg = _indeg(mesh, esrc, edst, n_pad, graph.dummy).to(torch.float32)
    so, si = torch.clamp(outdeg, min=1.0), torch.clamp(indeg, min=1.0)
    out_nodes = torch.clamp((outdeg > 0).to(torch.float32).sum(), min=1.0)
    in_nodes = torch.clamp((indeg > 0).to(torch.float32).sum(), min=1.0)
    ar = torch.arange(n_pad, device=dev)
    hub = torch.where(ar <= graph.n, 1.0 / out_nodes, 0.0).to(torch.float32)
    auth = torch.where(ar <= graph.n, 1.0 / in_nodes, 0.0).to(torch.float32)
    so_src, si_dst = so[esrc], si[edst]
    for _ in range(max_iter):
        x = psum_f32(mesh, sums_d, hub[esrc] / so_src)
        new_hub = psum_f32(mesh, sums_s, x[edst] / si_dst)
        y = psum_f32(mesh, sums_s, auth[edst] / si_dst)
        new_auth = psum_f32(mesh, sums_d, y[esrc] / so_src)
        hub = torch.where(outdeg > 0, new_hub, 0.0)
        auth = torch.where(indeg > 0, new_auth, 0.0)
    return hub, auth


def mis_dist(graph: ShardedGraph, mesh: EdgeMesh, priorities):
    """Distributed Luby MIS (primitives/mis.py luby_kernel): the
    neighbour-max and exclusion scatters merge by pmax.  `priorities` is
    (n_pad,) int32.  Returns (state {0,1,2}, rounds), replicated."""
    n_pad, dev = graph.n_pad, mesh.device
    esrc, edst = graph.edge_src, graph.edge_dst
    prio = torch.as_tensor(priorities, dtype=torch.int32, device=dev)
    real = torch.arange(n_pad, dtype=torch.int32, device=dev) < graph.n
    state = torch.where(real, 0, 2).to(torch.int32)
    lowest = torch.full((n_pad,), INT_MIN, dtype=torch.int32, device=dev)
    none = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    prio_dst = prio[edst]
    r = 0
    while r <= graph.n and bool((state == 0).any()):
        und = state == 0
        cand_e = und[esrc] & und[edst]
        nbmax = mesh.reduce(scatter_max(
            lowest, esrc, torch.where(cand_e, prio_dst, INT_MIN)), "max")
        join = und & (prio >= nbmax)
        excl_l = scatter_or(scatter_or(none, edst, join[esrc]), esrc,
                            join[edst])
        excl = mesh.reduce(excl_l.to(torch.int32), "max") > 0
        state = torch.where(join, 1, torch.where(und & excl, 2, state)).to(
            torch.int32)
        r += 1
    return state, r


def topk_dist(graph: ShardedGraph, mesh: EdgeMesh, k: int):
    """Distributed top-K degree centrality (primitives/topk.py): psum
    the in-degree partials, sort the replicated centrality vector by
    (-centrality, id), a stable sort over slots in id order.
    Returns (ids (k,), centralities (k,)), replicated."""
    in_deg = _indeg(mesh, graph.edge_src, graph.edge_dst, graph.n_pad,
                    graph.dummy)
    cent = in_deg + graph.out_degree
    neg_sorted, ids = torch.sort(-cent, stable=True)
    return ids.to(torch.int32)[:k], (-neg_sorted)[:k]


def dobfs_dist(graph: ShardedGraph, src: int, mesh: EdgeMesh,
               alpha: float = 6.0, beta: float = 2.0):
    """Distributed direction-optimized BFS (primitives/dobfs.py): the
    Beamer alpha/beta switch on replicated frontier/unvisited degree
    sums (exact integer sums compared in float32, as the JAX package's
    int32 sums are); both directions run the same edge-centric advance,
    merged by pmax/pmin, so labels and preds do not depend on the rank
    count.  Returns (labels, preds, depth, pull_levels)."""
    n_pad, dev = graph.n_pad, mesh.device
    esrc, edst = graph.edge_src, graph.edge_dst
    outdeg = graph.out_degree.to(torch.int64)
    indeg = _indeg(mesh, esrc, edst, n_pad, graph.dummy).to(torch.int64)
    labels = torch.full((n_pad,), INT_MAX, dtype=torch.int32, device=dev)
    labels[src] = 0
    preds = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    frontier = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    frontier[src] = True
    zero = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    no_label = torch.full((n_pad,), INT_MAX, dtype=torch.int32, device=dev)
    f32 = np.float32
    depth = pulls = 0
    while depth <= graph.n:
        unvisited = labels == INT_MAX
        f_edges, u_edges, f_n = torch.stack((
            torch.where(frontier, outdeg, 0).sum(),
            torch.where(unvisited, indeg, 0).sum(),
            frontier.sum().to(torch.int64))).tolist()
        if f_n == 0:
            break
        use_pull = (f32(f_edges) * f32(alpha) > f32(u_edges)) and (
            f32(f_n) * f32(beta) > f32(1))
        # edge-centric form: push and pull scan the same shard edges;
        # the switch is kept for the pull-levels stat
        cand = frontier[esrc] & (labels[edst] == INT_MAX)
        touched = mesh.reduce(scatter_max(zero, edst, cand.to(torch.int32)),
                              "max") > 0
        pmin = mesh.reduce(scatter_min(
            no_label, edst, torch.where(cand, esrc, INT_MAX)), "min")
        newf = touched & (labels == INT_MAX)
        labels = torch.where(newf, depth + 1, labels)
        preds = torch.where(newf, pmin, preds)
        frontier = newf
        depth += 1
        pulls += int(use_pull)
    return labels, preds, depth, pulls


def bc_dist(graph: ShardedGraph, src: int, mesh: EdgeMesh):
    """Distributed single-source Brandes BC (primitives/bc.py): forward
    sigma partials psum'd a level, backward delta partials psum'd a
    countdown step.  Returns (delta*0.5 bc partial, sigma, labels,
    depth), replicated."""
    n_pad, dev = graph.n_pad, mesh.device
    esrc, edst = graph.edge_src, graph.edge_dst
    sums_d, sums_s = SlotSums(edst, n_pad), SlotSums(esrc, n_pad)
    labels = torch.full((n_pad,), INT_MAX, dtype=torch.int32, device=dev)
    labels[src] = 0
    sigma = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    sigma[src] = 1.0
    frontier = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    frontier[src] = True
    zero = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    depth = 0
    while depth <= graph.n and bool(frontier.any()):
        cand = frontier[esrc] & (labels[edst] == INT_MAX)
        touched = mesh.reduce(scatter_max(zero, edst, cand.to(torch.int32)),
                              "max") > 0
        newf = touched & (labels == INT_MAX)
        labels = torch.where(newf, depth + 1, labels)
        sadd = psum_f32(mesh, sums_d, torch.where(cand, sigma[esrc], 0.0))
        sigma = torch.where(newf, sadd, sigma)
        frontier = newf
        depth += 1

    inv = torch.where(sigma > 0.0,
                      1.0 / torch.where(sigma > 0.0, sigma, 1.0), 0.0)
    lab_s, lab_d = labels[esrc], labels[edst]
    sig_s, inv_d = sigma[esrc], inv[edst]
    delta = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    for d in range(depth - 1, 0, -1):
        mask_e = (lab_s == d - 1) & (lab_d == d)
        contrib = torch.where(mask_e, sig_s * inv_d * (1.0 + delta[edst]),
                              0.0)
        delta = psum_f32(mesh, sums_s, contrib) + delta
    delta[src] = 0.0
    return delta * 0.5, sigma, labels, depth


def mst_dist(esrc_np, edst_np, w_np, n: int, mesh: EdgeMesh):
    """Distributed Boruvka MST (primitives/mst.py mst_kernel) over the
    CANONICAL undirected edge list (primitives.mst.canonical_edges).
    Edges are contiguously sharded; per round the component min-weight
    and min-edge-id scatter-mins merge by pmin (a float min is exact);
    each rank marks its own selected edges.  Returns (in_mst (m,) bool
    in canonical order, comp (n_pad,), rounds), the arrays as NumPy on
    every rank."""
    d, me, dev = mesh.size, mesh.rank, mesh.device
    n_pad = -(-(n + 1) // 128) * 128
    m = len(w_np)
    m_loc = -(-max(m, 1) // (128 * d)) * 128
    esrc = edge_slice(np.asarray(esrc_np), n_pad, m_loc, me, np.int32, dev)
    edst = edge_slice(np.asarray(edst_np), n_pad, m_loc, me, np.int32, dev)
    wv = edge_slice(np.asarray(w_np, np.float32), 0.0, m_loc, me,
                     np.float32, dev)
    inf = float("inf")
    real_e = esrc < n_pad
    geids = me * m_loc + torch.arange(m_loc, dtype=torch.int32, device=dev)
    cs_idx = torch.clamp(esrc, 0, n_pad - 1)
    cd_idx = torch.clamp(edst, 0, n_pad - 1)
    top_w = torch.full((n_pad,), inf, dtype=torch.float32, device=dev)
    top = torch.full((n_pad,), INT_MAX, dtype=torch.int32, device=dev)

    comp = torch.arange(n_pad, dtype=torch.int32, device=dev)
    in_mst = torch.zeros(m_loc, dtype=torch.bool, device=dev)
    rounds, go = 0, True
    while go and rounds < MST_ROUNDS:
        c1, c2 = comp[cs_idx], comp[cd_idx]
        cross = (c1 != c2) & real_e
        wq = torch.where(cross, wv, inf)
        minw = mesh.reduce(scatter_min(scatter_min(top_w, c1, wq), c2, wq),
                           "min")
        at1, at2 = wv == minw[c1], wv == minw[c2]
        ach = cross & (at1 | at2)
        sel_l = scatter_min(top, c1, torch.where(ach & at1, geids, INT_MAX))
        sel_l = scatter_min(sel_l, c2, torch.where(ach & at2, geids, INT_MAX))
        sel = mesh.reduce(sel_l, "min")
        # each rank marks its own edges selected by either endpoint
        in_mst = in_mst | (sel[c1] == geids) | (sel[c2] == geids)
        while True:
            cs = torch.where(in_mst, comp[cs_idx], INT_MAX)
            cd = torch.where(in_mst, comp[cd_idx], INT_MAX)
            nc = mesh.reduce(scatter_min(scatter_min(comp, cd_idx, cs),
                                         cs_idx, cd), "min")
            nc = nc[nc]
            nc = nc[nc]
            changed = bool((nc != comp).any())
            comp = nc
            if not changed:
                break
        go = bool(mesh.reduce(cross.any().to(torch.int32).reshape(1),
                              "max").item())
        rounds += 1
    in_all = mesh.gather(in_mst.to(torch.uint8)).cpu().numpy()
    return in_all[:m].astype(bool), comp.cpu().numpy(), rounds


def wtf_dist(graph: ShardedGraph, mesh: EdgeMesh, src: int = 0,
             alpha: float = 0.2, delta: float = 0.85,
             threshold: float = 0.01, cot_size: int = 1000,
             max_iter: int = 50):
    """Distributed Who-To-Follow (primitives/wtf.py): personalized-PR
    partials psum'd an iteration (with the dangling-removal degree
    fixpoint, pr.effective_degrees); the circle of trust = the top
    `cot_size` by (rank desc, id asc) of the replicated PPR ranks; the
    personalized-SALSA auth/hub advances psum'd an iteration with the
    reference's swap placement.  Returns (rank, ppr), replicated."""
    n_pad, dev = graph.n_pad, mesh.device
    esrc, edst = graph.edge_src, graph.edge_dst
    sums_d, sums_s = SlotSums(edst, n_pad), SlotSums(esrc, n_pad)
    salsa_iters = int(1.0 / alpha)
    outdeg_i = graph.out_degree
    so = torch.clamp(outdeg_i.to(torch.float32), min=1.0)
    ar = torch.arange(n_pad, dtype=torch.int32, device=dev)
    real = ar < graph.n

    # dangling-removal fixpoint (pr.effective_degrees, psum'd)
    deg, changed = outdeg_i, True
    while changed:
        live_edge = (deg[edst] > 0) & (deg[esrc] > 0)
        part = torch.zeros_like(deg).index_add_(0, esrc,
                                                live_edge.to(deg.dtype))
        newdeg = torch.where(deg > 0, mesh.reduce(part, "sum"), 0)
        changed = bool((newdeg != deg).any())
        deg = newdeg
    degf = torch.clamp(deg.to(torch.float32), min=1.0)

    # phase 1: personalized PR (pr_kernel semantics, psum'd)
    personal = (ar == src).to(torch.float32)
    rank = torch.where(real, 1.0 - delta, 0.0).to(torch.float32)
    active = (deg > 0) & real
    ok = (deg[esrc] > 0) & (deg[edst] > 0)
    it = 0
    while it <= max_iter and bool(active.any()):
        contrib = torch.where(active, rank / degf, 0.0)
        nxt = psum_f32(mesh, sums_d, torch.where(ok, contrib[esrc], 0.0))
        nxt = torch.where(real, delta * nxt + (1.0 - delta) * personal, 0.0)
        active = ((nxt - rank).abs() > threshold) & real
        rank = nxt
        it += 1
    ppr = rank

    # phase 2: circle of trust = top cot_size by (rank desc, id asc)
    sorted_ids = torch.sort(-ppr, stable=True).indices
    rank_pos = torch.empty(n_pad, dtype=torch.int64, device=dev)
    rank_pos[sorted_ids] = torch.arange(n_pad, device=dev)
    in_cot = (rank_pos < cot_size) & real

    # phases 3+4: CoT in-degree + auth/hub loop (wtf_salsa_kernel)
    cot_edge = in_cot[esrc]
    cot_indeg = mesh.reduce(torch.zeros(n_pad, dtype=torch.int32,
                                        device=dev).index_add_(
        0, edst, cot_edge.to(torch.int32)), "sum")
    si = torch.clamp(cot_indeg.to(torch.float32), min=1.0)
    jump = (esrc == src).to(torch.float32) * alpha / so[esrc]
    si_dst, so_src = si[edst], so[esrc]
    z = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    rank_curr, ref_curr, ref_next = z, z, z
    for _ in range(salsa_iters):
        per_edge = jump + (1.0 - alpha) * ref_curr[edst] / si_dst
        rank_next = psum_f32(mesh, sums_s,
                             torch.where(cot_edge, per_edge, 0.0))
        ref_next2 = psum_f32(mesh, sums_d, torch.where(
            cot_edge, rank_curr[esrc] / so_src, 0.0))
        rank_curr, ref_curr, ref_next = rank_next, ref_next, ref_next2
    return rank_curr, ppr
