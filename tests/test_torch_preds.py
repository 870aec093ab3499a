"""The min-id predecessor pass (gunrockinst_tpu_torch/ops/preds.py):

- on the CPU, the plain version `min_preds_reference` (what the pass
  runs there) against the oracles' preds, through the BFS and SSSP
  entries, with and without the degree relabeling: per-edge and
  constant weights, several parents at one level or distance where the
  least input id differs from the least search id, a float32 add that
  rounds onto the distance, unreached vertices and the source, a hub of
  many chunks; the chunk plan tiling every long in-list once; the
  wrapper's errors;
- on the card (`card` marker, skipped without CUDA), the kernel against
  the plain version bit for bit at rmat-s20 and on a Kronecker graph
  made by the benchmark's generator, and one `launch.min_preds` per
  call that marks preds.

No JAX here: the card tests run on a machine without it
(`python -m pytest tests/test_torch_preds.py --noconftest -m card`)."""

import numpy as np
import pytest
import torch

from gunrockinst_tpu_torch.graph.coo import CooGraph
from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.graph.rmat import rmat_graph
from gunrockinst_tpu_torch.ops import preds as preds_op
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


def _sssp_preds(csr, src):
    dist, _ = sssp_reference(csr, src)
    return sssp.get_sssp_planes(csr, CPU).preds(dist, src)


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
