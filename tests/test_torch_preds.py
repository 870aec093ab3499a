"""The min-id predecessor pass (gunrockinst_tpu_torch/ops/preds.py):

- on the CPU, the plain version `min_preds_reference` (what the pass
  runs there) against the oracles' preds, through the BFS and SSSP
  entries, with and without the degree relabeling: per-edge and
  constant weights, several parents at one level or distance where the
  least input id differs from the least search id, a float32 add that
  rounds onto the distance, unreached vertices and the source, a hub of
  many chunks; the chunk plan tiling every long in-list once; the
  wrapper's errors;
- on the CPU, the labels the pass is fed on the card: the plain decode
  of a search's label planes (`plane_labels`) against the host's label
  assembly moved to search ids, over step-8 and chain searches,
  relabeled and unrelabeled graphs, a depth that is a power of two and
  stale bits in the planes it must not read; the preds of the mega and
  planes routes (fed from the card) against those of the host values'
  upload; the counters that say which way each pass was fed;
- on the card (`card` marker, skipped without CUDA), the kernel against
  the plain version bit for bit at rmat-s20 and on a Kronecker graph
  made by the benchmark's generator, one `launch.min_preds` per
  call that marks preds, and the decode kernel against its plain
  version on the same graphs, after a step-8 and a chain search.

No JAX here: the card tests run on a machine without it
(`python -m pytest tests/test_torch_preds.py --noconftest -m card`)."""

import numpy as np
import pytest
import torch

from gunrockinst_tpu_torch.graph.coo import CooGraph
from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.graph.rmat import rmat_graph
from gunrockinst_tpu_torch.ops import preds as preds_op
from gunrockinst_tpu_torch.ops.chain import ChainBfs
from gunrockinst_tpu_torch.oracles import bfs_reference, sssp_reference
from gunrockinst_tpu_torch.device import download, upload
from gunrockinst_tpu_torch.primitives import bfs, bfs_pallas, sssp
from gunrockinst_tpu_torch.primitives.search_graph import search_graph
from gunrockinst_tpu_torch.utils import trace

CPU = torch.device("cpu")
INF32 = np.iinfo(np.int32).max
RELABEL = ["1", "force"]   # "1" leaves graphs this small as they are


def _coo_graph(n, src, dst, w=None, undirected=False):
    coo = CooGraph(n, np.asarray(src, np.int32), np.asarray(dst, np.int32),
                   None if w is None else np.asarray(w, np.float32))
    return CsrGraph.from_coo(coo, undirected=undirected)


def _random(n, m, seed, undirected, weights):
    rng = np.random.default_rng(seed)
    w = {"int": lambda: rng.integers(1, 8, m).astype(np.float32),
         "unit": lambda: rng.random(m, dtype=np.float32),
         "const": lambda: np.full(m, 0.5, np.float32),
         "none": lambda: None}[weights]()
    return _coo_graph(n, rng.integers(0, n, m), rng.integers(0, n, m), w,
                      undirected)


def _star_hub(leaves=1000):
    """Vertex 0 reached from `leaves` sources at level 1 (and the sources
    from a root one level up): an in-list of many chunks."""
    root = leaves + 1
    src = [root] * leaves + list(range(1, leaves + 1))
    dst = list(range(1, leaves + 1)) + [0] * leaves
    return _coo_graph(leaves + 2, src, dst), root


def _bfs_preds(csr, src):
    labels, _ = bfs_reference(csr, src)
    return bfs_pallas._preds(csr, CPU, labels, src)


def _uploaded_sssp_preds(csr, dist, src):
    """The preds of host distances `dist` in input ids, uploaded, with
    the weights the planes route reads."""
    st = sssp.get_sssp_planes(csr, CPU).stepper
    return search_graph(csr, CPU).preds_of(dist, src, float("inf"),
                                           st.weights, st.const_w)


def _sssp_preds(csr, src):
    dist, _ = sssp_reference(csr, src)
    return _uploaded_sssp_preds(csr, dist, src)


@pytest.mark.parametrize("relabel", RELABEL)
@pytest.mark.parametrize("undirected", [False, True])
def test_bfs_preds_match_the_oracle(monkeypatch, relabel, undirected):
    monkeypatch.setenv("GT_BFS_RELABEL", relabel)
    csr = _random(300, 2400, 5, undirected, "none")
    for src in (0, 17, int(np.argmax(csr.degrees))):
        np.testing.assert_array_equal(_bfs_preds(csr, src),
                                      bfs_reference(csr, src)[1])


@pytest.mark.parametrize("relabel", RELABEL)
@pytest.mark.parametrize("weights", ["int", "unit", "const", "none"])
def test_sssp_preds_match_the_oracle(monkeypatch, relabel, weights):
    monkeypatch.setenv("GT_BFS_RELABEL", relabel)
    csr = _random(250, 2000, 9, True, weights)
    planes = sssp.get_sssp_planes(csr, CPU)
    assert (planes.stepper.weights is None) == (weights in ("const",
                                                            "none"))
    for src in (0, 42):
        np.testing.assert_array_equal(_sssp_preds(csr, src),
                                      sssp_reference(csr, src)[1])


def test_least_input_id_wins_over_least_search_id(monkeypatch):
    """Vertex 9 has parents 1 and 2 at level 1; 2 has the larger degree,
    so the degree relabeling gives it the smaller search id.  The pass
    answers in input ids: 1."""
    monkeypatch.setenv("GT_BFS_RELABEL", "force")
    src = [0, 0, 1, 2, 2, 2, 2, 2]
    dst = [1, 2, 9, 9, 3, 4, 5, 6]
    csr = _coo_graph(10, src, dst, undirected=True)
    g = search_graph(csr, CPU)
    assert g.perm[2] < g.perm[1]
    got = _bfs_preds(csr, 0)
    assert got[9] == 1
    np.testing.assert_array_equal(got, bfs_reference(csr, 0)[1])


def test_sssp_parents_tie_where_the_add_rounds_onto_the_distance(
        monkeypatch):
    """dist 1 reaches vertex 4 from vertex 1 over a weight of 2^-25
    (1 + 2^-25 rounds to 1 in float32) and from vertex 2 at 0.5 + 0.5:
    both are parents, and the least id, 1, wins."""
    monkeypatch.setenv("GT_BFS_RELABEL", "force")
    tiny = float(np.float32(2.0 ** -25))
    csr = _coo_graph(5, [0, 0, 1, 2, 3], [1, 2, 4, 4, 4],
                     [1.0, 0.5, tiny, 0.5, 3.0])
    dist, want = sssp_reference(csr, 0)
    assert dist[4] == np.float32(1.0) and want[4] == 1
    got = _sssp_preds(csr, 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_unreached_vertices_and_the_source_get_no_parent(kind):
    # two components: 0-1-2 and 3-4; 5 isolated
    csr = _coo_graph(6, [0, 1, 3], [1, 2, 4], [1.0, 2.0, 1.0],
                     undirected=True)
    got = _bfs_preds(csr, 1) if kind == "bfs" else _sssp_preds(csr, 1)
    np.testing.assert_array_equal(got, [1, -1, 1, -1, -1, -1])


def test_hub_of_many_chunks():
    csr, root = _star_hub()
    got = _bfs_preds(csr, root)
    assert got[0] == 1
    np.testing.assert_array_equal(got, bfs_reference(csr, root)[1])
    g = search_graph(csr, CPU)
    p = preds_op.plan(g.stepper.offsets, g._perm, chunk=64)
    hub = int(g.internal(0))
    i = int(np.nonzero(p.long_v.numpy() == hub)[0][0])
    first, last = p.long_chunk[i].item(), p.long_chunk[i + 1].item()
    assert last - first == 1000 // 64 + 1
    assert i in p.multi.tolist()


@pytest.mark.parametrize("long_degree,chunk", [(32, 32), (32, 7),
                                               (40, 256), (64, 1)])
def test_plan_tiles_every_long_in_list_once(long_degree, chunk):
    csr, _ = _star_hub(300)
    rng = np.random.default_rng(3)
    extra = _random(400, 6000, 4, False, "none")   # a few long lists too
    for graph in (csr, extra):
        offsets = torch.from_numpy(np.asarray(graph.transposed().row_offsets,
                                              np.int32))
        n = offsets.shape[0] - 1
        perm = torch.from_numpy(rng.permutation(n))
        p = preds_op.plan(offsets, perm, long_degree, chunk)
        deg = np.diff(offsets.numpy())
        assert p.long_v.tolist() == np.nonzero(deg > long_degree)[0].tolist()
        assert p.input_id[perm].tolist() == list(range(n))
        begin, end = p.chunk_begin.numpy(), p.chunk_end.numpy()
        assert (end > begin).all() and (end - begin <= chunk).all()
        covered = np.zeros(offsets[-1].item(), np.int32)
        for c in range(begin.shape[0]):
            covered[begin[c]:end[c]] += 1
        owner = np.repeat(np.arange(n), deg)
        assert (covered == (deg[owner] > long_degree)).all()
        assert (owner[begin] == p.chunk_v.numpy()).all()
        per_v = np.diff(p.long_chunk.numpy())
        assert p.multi.tolist() == np.nonzero(per_v > 1)[0].tolist()
        for t in (p.input_id, p.long_v, p.long_chunk, begin, end, p.chunk_v,
                  p.multi):
            assert torch.as_tensor(t).dtype == torch.int32


def test_wrapper_rejects_bad_inputs():
    csr = _random(100, 600, 2, False, "unit")
    g = search_graph(csr, CPU)
    st = g.stepper
    p = preds_op.plan(st.offsets)
    n, m = st.n, st.in_src.shape[0]
    labels = torch.zeros(n, dtype=torch.int32)
    dist = torch.zeros(n, dtype=torch.float32)
    w = torch.ones(m, dtype=torch.float32)
    call = preds_op.min_preds
    with pytest.raises(ValueError, match="int32 labels or float32"):
        call(st.offsets, st.in_src, labels.long(), p)
    with pytest.raises(ValueError, match="int32 labels or float32"):
        call(st.offsets, st.in_src, dist.double(), p, const_w=1.0)
    with pytest.raises(ValueError, match="at least"):
        call(st.offsets, st.in_src, labels[: n - 1], p)
    with pytest.raises(ValueError, match="1-D"):
        call(st.offsets, st.in_src, labels.reshape(1, n), p)
    with pytest.raises(ValueError, match="at least"):
        call(st.offsets, st.in_src, labels.to("meta"), p)
    with pytest.raises(ValueError, match="int32 tensor"):
        call(st.offsets.long(), st.in_src, labels, p)
    with pytest.raises(ValueError, match="no weights"):
        call(st.offsets, st.in_src, labels, p, w)
    with pytest.raises(ValueError, match="one of the two"):
        call(st.offsets, st.in_src, dist, p)
    with pytest.raises(ValueError, match="one of the two"):
        call(st.offsets, st.in_src, dist, p, w, 1.0)
    with pytest.raises(ValueError, match="shaped like in_src"):
        call(st.offsets, st.in_src, dist, p, w[1:])
    with pytest.raises(ValueError, match="shaped like in_src"):
        call(st.offsets, st.in_src, dist, p, w.double())
    other = preds_op.plan(torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="plan"):
        call(st.offsets, st.in_src, labels, other)
    with pytest.raises(ValueError, match="long_degree"):
        preds_op.plan(st.offsets, long_degree=16)
    with pytest.raises(ValueError, match="chunk"):
        preds_op.plan(st.offsets, chunk=0)
    with pytest.raises(ValueError, match="perm"):
        preds_op.plan(st.offsets, torch.arange(n - 1))
    trace.reset_totals()
    call(st.offsets, st.in_src, labels, p)      # the plain version
    assert trace.totals().get("launch.min_preds", 0) == 0


# ---- the labels and distances the pass is fed on the card ---------------

def _strip(length, width=3):
    """A width x length strip of a square mesh: more than 255 levels
    deep from a corner, so the mega branch takes the chain kernel."""
    ids = np.arange(width * length).reshape(length, width)
    src = np.concatenate([ids[:, :-1].ravel(), ids[:-1].ravel()])
    dst = np.concatenate([ids[:, 1:].ravel(), ids[1:].ravel()])
    return _coo_graph(width * length, src, dst, undirected=True)


def _path(n):
    return _coo_graph(n, np.arange(n - 1), np.arange(1, n), undirected=True)


def _plant_stale_bits(planes, vw, n_bits, rows, seed):
    """Random bits, in place, in every plane from `n_bits` up and in the
    read planes at the vertices the search did not visit: what a decode
    must not read."""
    gen = torch.Generator().manual_seed(seed)
    noise = torch.randint(-2**31, 2**31, planes.shape, generator=gen,
                          dtype=torch.int64).to(torch.int32)
    noise = noise.to(planes.device)
    planes[n_bits * rows:] = noise[n_bits * rows:]
    for b in range(n_bits):
        planes[b * rows:(b + 1) * rows] |= (noise[b * rows:(b + 1) * rows]
                                            & ~vw)


# (graph, source, GT_BFS_RELABEL, route, depth of the search)
DECODE = {
    "step8-relabeled": (lambda: rmat_graph(10, 8, undirected=True, seed=3),
                        0, "force", "step8", None),
    "step8-unrelabeled": (lambda: rmat_graph(10, 8, undirected=True,
                                             seed=3), 0, "0", "step8", None),
    "step8-depth-8": (lambda: _path(8), 0, "force", "step8", 8),
    "chain-relabeled": (lambda: _strip(300), 0, "force", "chain", None),
    "chain-unrelabeled": (lambda: _strip(300), 1, "0", "chain", None),
    "chain-depth-512": (lambda: _path(600), 88, "0", "chain", 512),
}


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("case", sorted(DECODE))
def test_plane_decode_matches_the_host_assembly(monkeypatch, case, stale):
    make, src, relabel, route, want_depth = DECODE[case]
    monkeypatch.setenv("GT_BFS_RELABEL", relabel)
    csr = make()
    fn = bfs_pallas.get_fused_bfs(csr, True, CPU)
    fn(src)
    labels, depth, _ = fn(src)
    assert fn.route == route
    g = fn.g
    assert (g.perm is None) == (relabel == "0")
    if want_depth is not None:
        assert depth == want_depth
    planes, vw, _, psrc, _ = fn._last
    n_planes = planes.shape[0] // g.rows
    n_bits = min(max(depth, 1).bit_length(), n_planes)
    if stale:
        planes = planes.clone()
        _plant_stale_bits(planes, vw, n_bits, g.rows, seed=len(case))
        labels = bfs_pallas._labels(planes, vw, depth, n_planes, g.n,
                                    g.perm, src)
    np.testing.assert_array_equal(labels, bfs_reference(csr, src)[0])
    got = preds_op.plane_labels(planes, vw, g.n, depth, psrc)
    want = g.to_internal(torch.from_numpy(labels), INF32)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_plane_decode_rejects_bad_inputs():
    planes = torch.zeros((3 * 8, 128), dtype=torch.int32)
    vw = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="whole planes"):
        preds_op.plane_labels(planes[:20], vw, 100, 3, 0)
    with pytest.raises(ValueError, match="int32"):
        preds_op.plane_labels(planes.long(), vw, 100, 3, 0)
    with pytest.raises(ValueError, match="int32"):
        preds_op.plane_labels(planes, vw.reshape(-1), 100, 3, 0)
    with pytest.raises(ValueError, match="does not fit"):
        preds_op.plane_labels(planes, vw, 8 * 128 * 32 + 1, 3, 0)
    with pytest.raises(ValueError, match="does not fit"):
        preds_op.plane_labels(planes, vw, 100, 3, 100)
    trace.reset_totals()
    preds_op.plane_labels(planes, vw, 100, 3, 0)        # the plain version
    assert trace.totals().get("launch.plane_labels", 0) == 0


BFS_GRAPHS = {
    "kronecker": (lambda: rmat_graph(11, 16, undirected=True, seed=7),
                  "force"),
    "mesh": (lambda: _strip(300), "1"),
    "unrelabeled": (lambda: _random(400, 3000, 6, True, "none"), "0"),
}


@pytest.mark.parametrize("name", sorted(BFS_GRAPHS))
def test_mega_preds_fed_from_the_card_match_the_uploaded(monkeypatch,
                                                         name):
    make, relabel = BFS_GRAPHS[name]
    monkeypatch.setenv("GT_BFS_RELABEL", relabel)
    csr = make()
    for src in (0, int(np.argmax(csr.degrees))):
        res = bfs.run(csr, src, traversal_mode="mega", mark_preds=True,
                      device=CPU)
        if name == "mesh":
            assert res.stats.route == "chain"
        want = bfs_pallas._preds(csr, CPU, res.labels, src)
        np.testing.assert_array_equal(res.preds, want)
        np.testing.assert_array_equal(res.preds, bfs_reference(csr, src)[1])


@pytest.mark.parametrize("relabel", RELABEL)
@pytest.mark.parametrize("weights", ["unit", "const"])
def test_planes_preds_fed_from_the_card_match_the_uploaded(monkeypatch,
                                                           relabel,
                                                           weights):
    monkeypatch.setenv("GT_BFS_RELABEL", relabel)
    csr = _random(300, 2400, 11, True, weights)
    fn = sssp.get_sssp_planes(csr, CPU)
    assert (fn.stepper.weights is None) == (weights == "const")
    for src in (0, 77):
        res = sssp.run(csr, src, mode="planes", mark_preds=True, device=CPU)
        assert fn.dists.dtype == torch.float32
        assert torch.isinf(fn.dists[fn.g.n:]).all()
        np.testing.assert_array_equal(res.preds,
                                      _uploaded_sssp_preds(csr, res.dist,
                                                           src))
        np.testing.assert_array_equal(res.preds,
                                      sssp_reference(csr, src)[1])


def _preds_counts(call):
    """The counts of a call's `gt.entry.preds` span and the spans under
    it, summed."""
    (top,) = [s for s in call.spans if s.name == "gt.entry.preds"]
    under, counts = {top.id}, {}
    for s in call.spans:
        if s.id in under or s.parent in under:
            under.add(s.id)
            for k, v in s.counts.items():
                counts[k] = counts.get(k, 0) + v
    return counts


@pytest.mark.parametrize("route", ["mega", "planes", "pallas", "v1"])
def test_each_pass_counts_where_its_values_came_from(route):
    """On a graph whose set-up is done (its first call builds what the
    pass reads): one pass a call, counted by where its values came
    from, and nothing uploaded for a pass fed from the card."""
    csr = _random(200, 1600, 13, True, "unit")
    for src in (5, 3):
        trace.clear()
        trace.reset_totals()
        if route == "planes":
            sssp.run(csr, src, mode="planes", mark_preds=True, device=CPU)
        elif route == "v1":
            bfs_pallas.bfs_pallas(csr, src, mark_preds=True, device=CPU)
        else:
            bfs.run(csr, src, traversal_mode=route, mark_preds=True,
                    device=CPU)
    totals = trace.totals()
    on_card = route in ("mega", "planes")
    assert totals.get("preds.card_values", 0) == int(on_card)
    assert totals.get("preds.host_values", 0) == int(not on_card)
    if route == "v1":
        return
    (call,) = trace.calls()
    counts = _preds_counts(call)
    if on_card:
        assert counts["preds.card_values"] == 1
        assert counts.get("copy.h2d_bytes", 0) == 0
    else:
        assert counts["preds.host_values"] == 1
        assert counts["copy.h2d_bytes"] == 4 * csr.num_nodes


# ---- on the card ---------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kron(scale, seed):
    """A Kronecker graph from the benchmark's generator and its
    configuration's parameters, with its weights."""
    from portbench.graphs import kronecker
    cfg = {"scale": scale, "edgefactor": 16, "A": 0.57, "B": 0.19,
           "C": 0.19}
    bg = kronecker.make(cfg, seed, torch.device("cuda"))
    return CsrGraph.from_arrays(*bg.port_arrays(weighted=True))


@pytest.fixture(scope="module")
def card_graphs(card):
    return {"rmat20": rmat_graph(20, 16, undirected=True, seed=20,
                                 with_values=True),
            "kron17": _kron(17, 1700000017)}


PLANS = [{}, {"chunk": 32}, {"long_degree": 64, "chunk": 1000}]


@pytest.mark.card
@pytest.mark.parametrize("name", ["rmat20", "kron17"])
@pytest.mark.parametrize("kind", ["bfs", "sssp_w", "sssp_c"])
def test_kernel_matches_plain_bitwise(card, card_graphs, name, kind):
    csr = card_graphs[name]
    g = search_graph(csr, card)
    st = g.stepper
    src = int(np.argsort(-csr.degrees, kind="stable")[3])
    weights, const_w = None, None
    if kind == "bfs":
        res = bfs.run(csr, src, traversal_mode="auto", mark_preds=False,
                      device=card)
        vals = g.to_internal(torch.from_numpy(res.labels).to(card), INF32)
    else:
        if kind == "sssp_w":
            weights = sssp.get_sssp_planes(csr, card).stepper.weights
            res = sssp.run(csr, src, mode="planes", mark_preds=False,
                           device=card)
        else:
            const_w = 1.0
            plain = CsrGraph.from_arrays(csr.row_offsets, csr.col_indices)
            res = sssp.run(plain, src, mode="planes", mark_preds=False,
                           device=card)
        vals = g.to_internal(torch.from_numpy(res.dist).to(card),
                             float("inf"))
    want = preds_op.min_preds_reference(st.offsets, st.in_src, vals,
                                        preds_op.plan(st.offsets,
                                                      g._perm).input_id,
                                        weights, const_w)
    assert int((want >= 0).sum()) > 1000
    for kw in PLANS:
        p = preds_op.plan(st.offsets, g._perm, **kw)
        got = preds_op.min_preds(st.offsets, st.in_src, vals, p, weights,
                                 const_w)
        torch.cuda.synchronize()
        assert torch.equal(got, want), kw


@pytest.mark.card
@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_one_launch_per_call_that_marks_preds(card, card_graphs, kind):
    csr = card_graphs["rmat20"]
    src = int(np.argmax(csr.degrees))

    def launches(mark):
        trace.reset_totals()
        if kind == "bfs":
            bfs.run(csr, src, traversal_mode="auto", mark_preds=mark,
                    device=card)
        else:
            sssp.run(csr, src, mode="planes", mark_preds=mark, device=card)
        return trace.totals().get("launch.min_preds", 0)

    assert launches(True) == 1
    assert launches(False) == 0


@pytest.mark.card
@pytest.mark.parametrize("name", ["rmat20", "kron17"])
@pytest.mark.parametrize("route", ["step8", "chain"])
def test_decode_kernel_matches_plain_bitwise(card, card_graphs, name,
                                             route):
    csr = card_graphs[name]
    g = search_graph(csr, card)
    psrc = g.internal(int(np.argsort(-csr.degrees, kind="stable")[5]))
    planes_full = (g.n + 1).bit_length()
    if route == "step8":
        planes, vw, depth, _ = g.search(psrc, g.reach(psrc), 8, 255)
    else:
        planes, vw, depth = ChainBfs(g, planes_full)(psrc)
        depth = int(depth.item())
    n_planes = planes.shape[0] // g.rows
    n_bits = min(max(depth, 1).bit_length(), n_planes)
    assert n_bits < n_planes
    _plant_stale_bits(planes, vw, n_bits, g.rows, seed=depth)
    got = preds_op.plane_labels(planes, vw, g.n, depth, psrc)
    want = preds_op.plane_labels_reference(planes, vw, g.n, n_bits, psrc)
    torch.cuda.synchronize()
    assert int((want != INF32).sum()) > 1000
    assert torch.equal(got, want)


def test_download_and_upload_count_and_keep_values():
    x = np.arange(1000, dtype=np.int32) * 3 - 7
    trace.reset_totals()
    back = download(upload(x, torch.device("cpu")))
    totals = trace.totals()
    assert np.array_equal(back, x) and back.dtype == np.int32
    assert totals["copy.h2d_bytes"] == totals["copy.d2h_bytes"] == x.nbytes
    assert totals["host_read"] == 1


@pytest.mark.card
def test_pinned_copies_are_the_callers_own(card):
    a = np.arange(1 << 20, dtype=np.int32)
    b = a[::-1].copy()
    on_card = upload(a, card)
    assert on_card.device.type == "cuda"
    first = download(on_card)
    second = download(upload(b, card))
    assert np.array_equal(first, a) and np.array_equal(second, b)
    assert first.flags.writeable and first.ctypes.data != second.ctypes.data
    first[0] = -5
    assert download(upload(b, card))[0] == b[0]
