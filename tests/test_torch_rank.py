"""Port parity: HITS, SALSA and WTF `mode="planes"`
(gunrockinst_tpu_torch.primitives) against the JAX package's planes
modes (Pallas interpret mode on the CPU) and the NumPy oracles, on
directed and undirected graphs, with and without the internal
relabeling; the reverse device CSC they sweep; and the new entry
points with JAX made unimportable.

device="cpu" runs the value kernel's plain version."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.oracles.ranking import hits_reference as ref_hits_oracle
from gunrockinst_tpu.oracles.wtf import wtf_reference as ref_wtf_oracle
from gunrockinst_tpu.primitives import hits as ref_hits
from gunrockinst_tpu.primitives import salsa as ref_salsa
from gunrockinst_tpu.primitives import wtf as ref_wtf

from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.oracles import (hits_reference, salsa_reference,
                                           wtf_reference)
from gunrockinst_tpu_torch.primitives import bfs_pallas, hits, salsa, wtf

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
GRAPHS = {
    "rmat8_undirected": lambda: ref_rmat(8, 8, undirected=True, seed=5),
    "rmat8_directed": lambda: ref_rmat(8, 8, undirected=False, seed=9),
    # 600 vertices, 4200 random directed edges
    "random600": lambda: RefCsr.from_coo(RefCoo(
        600, *np.random.default_rng(21).integers(0, 600, (2, 4200)),
        None)),
}
# "1" leaves graphs this small as they are; under "force" the port runs
# relabeled and is held against the oracles (the JAX package's relabeled
# planes compile anew for every graph, at a cost the oracles save)
RELABEL = ["1", "force"]


def _pair(name, relabel, monkeypatch):
    """The same fresh graph in both packages, under GT_BFS_RELABEL."""
    monkeypatch.setenv("GT_BFS_RELABEL", relabel)
    ref = GRAPHS[name]()
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)
    perm = bfs_pallas.search_graph(port, CPU).perm
    assert (perm is None) == (relabel == "1")
    return ref, port


@pytest.mark.parametrize("relabel", RELABEL)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_hits_matches_reference(monkeypatch, name, relabel):
    ref, port = _pair(name, relabel, monkeypatch)
    got = hits.run(port, src=2, max_iter=10, mode="planes", device="cpu")
    hub, auth = hits_reference(port, 2, max_iter=10)
    np.testing.assert_allclose(got.hub_ranks, hub, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.auth_ranks, auth, rtol=1e-4, atol=1e-6)
    assert got.stats.search_depth == 10
    if relabel == "1":
        want = ref_hits.run(ref, src=2, max_iter=10, mode="planes")
        for a, b in ((got.hub_ranks, want.hub_ranks),
                     (got.auth_ranks, want.auth_ranks)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        assert got.stats.edges_visited == want.stats.edges_visited


@pytest.mark.parametrize("relabel", RELABEL)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_salsa_matches_reference(monkeypatch, name, relabel):
    ref, port = _pair(name, relabel, monkeypatch)
    got = salsa.run(port, max_iter=8, mode="planes", device="cpu")
    if relabel == "1":
        want = ref_salsa.run(ref, max_iter=8, mode="planes")
        for a, b in ((got.hub_ranks, want.hub_ranks),
                     (got.auth_ranks, want.auth_ranks)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    hub, auth = salsa_reference(port, max_iter=8)
    np.testing.assert_allclose(got.hub_ranks, hub, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.auth_ranks, auth, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("relabel", RELABEL)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_wtf_matches_reference(monkeypatch, name, relabel):
    ref, port = _pair(name, relabel, monkeypatch)
    src = 2
    got = wtf.run(port, src=src, alpha=0.2, cot_size=50, mode="planes",
                  device="cpu")
    _, cot, ppr = wtf_reference(port, src, alpha=0.2, cot_size=50)
    np.testing.assert_allclose(got.ppr_ranks, ppr, rtol=1e-3, atol=1e-6)
    # PPR ties permute the CoT; hold it score-equivalent per position
    np.testing.assert_allclose(ppr[got.cot], ppr[cot], rtol=1e-3,
                               atol=1e-6)
    # phases 3 and 4 against the oracle pinned to the port's CoT
    pinned, _, _ = wtf_reference(port, src, alpha=0.2, cot_size=50,
                                 cot=got.cot)
    np.testing.assert_allclose(got.wtf_ranks, pinned, rtol=1e-3, atol=1e-6)
    assert got.stats.search_depth == 5
    assert set(got.phases) == {"ppr_ms", "ppr_iters", "cot_sort_ms",
                               "salsa_ms"}
    if relabel == "1":
        want = ref_wtf.run(ref, src=src, alpha=0.2, cot_size=50,
                           mode="planes")
        np.testing.assert_allclose(got.ppr_ranks, want.ppr_ranks,
                                   rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(ppr[got.cot], ppr[want.cot], rtol=1e-3,
                                   atol=1e-6)
        ref_pinned, _, _ = ref_wtf_oracle(ref, src, alpha=0.2, cot_size=50,
                                          cot=got.cot)
        np.testing.assert_allclose(got.wtf_ranks, ref_pinned, rtol=1e-3,
                                   atol=1e-6)
        if np.array_equal(np.sort(got.cot), np.sort(want.cot)):
            np.testing.assert_allclose(got.wtf_ranks, want.wtf_ranks,
                                       rtol=1e-3, atol=1e-6)
        assert want.stats.search_depth == 5
        assert set(got.phases) == set(want.phases)
        assert got.phases["ppr_iters"] == want.phases["ppr_iters"]


def test_relabeled_ids_do_not_show(monkeypatch):
    """Forced relabeling of a fresh directed graph: every result is in
    input ids (the reverse sweeps share the forward sweep's ids)."""
    ref, port = _pair("rmat8_directed", "force", monkeypatch)
    assert not np.array_equal(bfs_pallas.search_graph(port, CPU).perm,
                              np.arange(port.num_nodes))
    got = hits.run(port, src=7, max_iter=6, mode="planes", device="cpu")
    hub, auth = ref_hits_oracle(ref, 7, max_iter=6)
    np.testing.assert_allclose(got.hub_ranks, hub, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.auth_ranks, auth, rtol=1e-4, atol=1e-6)
    got = salsa.run(port, max_iter=6, mode="planes", device="cpu")
    hub, auth = salsa_reference(port, max_iter=6)
    np.testing.assert_allclose(got.hub_ranks, hub, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.auth_ranks, auth, rtol=1e-4, atol=1e-6)
    got = wtf.run(port, src=7, cot_size=40, mode="planes", device="cpu")
    pinned, _, ppr = wtf_reference(port, 7, cot_size=40, cot=got.cot)
    np.testing.assert_allclose(got.ppr_ranks, ppr, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got.wtf_ranks, pinned, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("relabel", RELABEL)
def test_reverse_csc_shares_or_uploads(monkeypatch, relabel):
    """A symmetric graph is its own reverse: its reverse steppers sweep
    the forward CSC's tensors.  A directed graph uploads its relabeled
    CSR once, as the CSC of the reverse graph in the same ids."""
    _, und = _pair("rmat8_undirected", relabel, monkeypatch)
    g = bfs_pallas.search_graph(und, CPU)
    assert g.reverse()[1] is g.stepper.in_src
    for gated in (False, True):
        fwd = bfs_pallas.add_stepper(g, gated=gated)
        rev = bfs_pallas.add_stepper(g, reverse=True, gated=gated)
        assert fwd is not rev and fwd.use_active == rev.use_active == gated
        assert rev.in_src.data_ptr() == fwd.in_src.data_ptr()
        assert rev.offsets.data_ptr() == fwd.offsets.data_ptr()
        assert bfs_pallas.add_stepper(g, True, gated) is rev
    _, dig = _pair("rmat8_directed", relabel, monkeypatch)
    g = bfs_pallas.search_graph(dig, CPU)
    offsets, in_src = g.reverse()
    assert g.reverse()[1] is in_src
    assert in_src.data_ptr() != g.stepper.in_src.data_ptr()
    np.testing.assert_array_equal(offsets.numpy(), g.csr_p.row_offsets)
    np.testing.assert_array_equal(in_src.numpy(), g.csr_p.col_indices)
    rev = bfs_pallas.add_stepper(g, reverse=True)
    assert rev.in_src is in_src
    # the reverse sweep sums over out-edges, in search ids
    x = torch.arange(g.n_words * 32, dtype=torch.float32) % 7
    x[g.n:] = 0
    got = bfs_pallas.add_sweep(rev, x)[: g.n].numpy()
    esrc = np.repeat(np.arange(g.n), np.diff(g.csr_p.row_offsets))
    want = np.bincount(esrc, weights=x.numpy()[g.csr_p.col_indices],
                       minlength=g.n)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_rank_paths_share_the_add_steppers():
    ref = ref_rmat(8, 4, undirected=False, seed=3)
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)
    from gunrockinst_tpu_torch.primitives import pr
    g = bfs_pallas.search_graph(port, CPU)
    fwd = bfs_pallas.add_stepper(g)
    rev = bfs_pallas.add_stepper(g, reverse=True)
    assert pr.get_pr_planes(port, CPU).stepper is fwd
    for fn in (hits.get_hits_planes(port, CPU),
               salsa.get_salsa_planes(port, CPU),
               wtf.get_wtf_planes(port, CPU)):
        assert fn.fwd is fwd and fn.rev is rev
    assert fwd.offsets is g.stepper.offsets


def test_unported_modes_and_bad_inputs_raise():
    """The default modes that raised before this slice (HITS, SALSA and
    WTF "xla") now run and equal the JAX package's; bad inputs still
    raise."""
    ro, ci = np.array([0, 1, 2, 2]), np.array([1, 2])
    port = CsrGraph.from_arrays(ro, ci)
    ref = RefCsr(row_offsets=ro, col_indices=ci)
    pairs = ((hits.run(port, device="cpu"), ref_hits.run(ref)),
             (salsa.run(port, device="cpu"), ref_salsa.run(ref)))
    for got, want in pairs:
        np.testing.assert_allclose(got.hub_ranks, want.hub_ranks,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.auth_ranks, want.auth_ranks,
                                   rtol=1e-5, atol=1e-6)
    got, want = wtf.run(port, 0, device="cpu"), ref_wtf.run(ref, 0)
    np.testing.assert_array_equal(got.cot, want.cot)
    np.testing.assert_allclose(got.wtf_ranks, want.wtf_ranks, rtol=1e-5,
                               atol=1e-6)
    for src in (-1, 3):
        with pytest.raises(ValueError):
            wtf.run(port, src, mode="planes", device="cpu")
    with pytest.raises(TypeError):
        hits.run(object(), mode="planes", device="cpu")


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    port = CsrGraph.from_arrays(np.array([0, 1, 1]), np.array([1]))
    for call in (lambda: hits.run(port, mode="planes"),
                 lambda: salsa.run(port, mode="planes"),
                 lambda: wtf.run(port, 0, mode="planes"),
                 lambda: hits.get_hits_planes(port)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_new_primitives_run_with_jax_and_reference_unimportable():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'gunrockinst_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from gunrockinst_tpu_torch.graph.rmat import rmat_graph\n"
        "from gunrockinst_tpu_torch.primitives import bc, hits, pr, salsa,"
        " wtf\n"
        "from gunrockinst_tpu_torch import oracles as o\n"
        "import chip_smoke\n"
        "g = rmat_graph(8, 4, undirected=False, seed=1)\n"
        "kw = dict(rtol=1e-4, atol=1e-6)\n"
        "r = pr.run(g, max_iter=5, mode='pallas', device='cpu')\n"
        "assert np.allclose(r.ranks, o.pagerank_reference(g, max_iter=5),"
        " **kw)\n"
        "r = hits.run(g, src=1, max_iter=4, mode='planes', device='cpu')\n"
        "assert np.allclose(r.hub_ranks, o.hits_reference(g, 1, "
        "max_iter=4)[0], **kw)\n"
        "r = salsa.run(g, max_iter=4, mode='planes', device='cpu')\n"
        "assert np.allclose(r.auth_ranks, o.salsa_reference(g, "
        "max_iter=4)[1], **kw)\n"
        "r = wtf.run(g, 1, cot_size=20, mode='planes', device='cpu')\n"
        "assert np.allclose(r.wtf_ranks, o.wtf_reference(g, 1, "
        "cot_size=20, cot=r.cot)[0], rtol=1e-3, atol=1e-6)\n"
        "r = bc.run(g, 1, mode='planes', device='cpu')\n"
        "want = o.bc_reference(g, 1)\n"
        "assert np.allclose(r.bc_values, want[0], **kw)\n"
        "assert np.array_equal(r.sigmas, want[1])\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
