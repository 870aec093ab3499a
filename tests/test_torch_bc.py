"""Port parity: single-source BC `mode="planes"`
(gunrockinst_tpu_torch.primitives.bc) against the JAX package's
`bc.run(mode="planes")` (Pallas interpret mode on the CPU) and the
Brandes oracles: sigma and labels exact, values allclose, with and
without the internal relabeling; a search deeper than the reference's
level cap; a disconnected graph; two calls bit for bit.

device="cpu" runs the value kernel's plain version."""

import numpy as np
import pytest
import torch

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.primitives import bc as ref_bc

from gunrockinst_tpu_torch.graph.coo import CooGraph
from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.oracles import bc_reference, bc_reference_fast
from gunrockinst_tpu_torch.ops import value
from gunrockinst_tpu_torch.primitives import bc
from gunrockinst_tpu_torch.primitives.search_graph import (add_stepper,
                                                           search_graph)

CPU = torch.device("cpu")
INF32 = np.iinfo(np.int32).max
GRAPHS = {
    "rmat8_undirected": lambda: ref_rmat(8, 8, undirected=True, seed=5),
    "rmat8_directed": lambda: ref_rmat(8, 8, undirected=False, seed=9),
    # 600 vertices, 4500 random edges, undirected
    "random600": lambda: RefCsr.from_coo(RefCoo(
        600, *np.random.default_rng(13).integers(0, 600, (2, 4500)),
        None), undirected=True),
}


def _pair(name, relabel, monkeypatch):
    """The same fresh graph in both packages, under GT_BFS_RELABEL."""
    monkeypatch.setenv("GT_BFS_RELABEL", relabel)
    ref = GRAPHS[name]()
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)
    perm = search_graph(port, CPU).perm
    assert (perm is None) == (relabel == "1")
    return ref, port


def _oracle_labels(labels):
    """The port's labels with the oracles' -1 for unreached vertices."""
    return np.where(labels == INF32, -1, labels)


def _check_oracles(got, port, src):
    want_bc, want_sigma, want_labels = bc_reference(port, src)
    np.testing.assert_allclose(got.bc_values, want_bc, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.sigmas, want_sigma)
    np.testing.assert_array_equal(_oracle_labels(got.labels), want_labels)
    fast_bc, fast_sigma, fast_labels = bc_reference_fast(port, src)
    np.testing.assert_allclose(got.bc_values, fast_bc, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(got.sigmas, fast_sigma)
    np.testing.assert_array_equal(_oracle_labels(got.labels), fast_labels)
    assert got.stats.search_depth == max(int(want_labels.max()), 0)


@pytest.mark.parametrize("relabel", ["1", "force"])
@pytest.mark.parametrize("src", [0, 99])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bc_matches_reference(monkeypatch, name, src, relabel):
    ref, port = _pair(name, relabel, monkeypatch)
    got = bc.run(port, src=src, mode="planes", device="cpu")
    want = ref_bc.run(ref, src=src, mode="planes")
    np.testing.assert_allclose(got.bc_values, want.bc_values, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(got.sigmas, want.sigmas)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.stats.search_depth == want.stats.search_depth
    assert got.labels[src] == 0 and got.bc_values[src] == 0
    _check_oracles(got, port, src)


def test_bc_deeper_than_the_reference_level_cap():
    """A 200-vertex path from vertex 0: 199 levels, past the reference's
    level_cap of 64 (which it meets by rerunning with a larger cap)."""
    n = 200
    u = np.arange(n - 1, dtype=np.int64)
    coo = (n, np.concatenate([u, u + 1]), np.concatenate([u + 1, u]), None)
    ref = RefCsr.from_coo(RefCoo(*coo))
    port = CsrGraph.from_coo(CooGraph(*coo))
    got = bc.run(port, src=0, mode="planes", device="cpu")
    want = ref_bc.run(ref, src=0, mode="planes")
    assert got.stats.search_depth == want.stats.search_depth == n - 1
    np.testing.assert_array_equal(got.labels, np.arange(n))
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.sigmas, want.sigmas)
    np.testing.assert_allclose(got.bc_values, want.bc_values, rtol=1e-4,
                               atol=1e-6)
    _check_oracles(got, port, 0)


def test_bc_disconnected():
    """Unreached vertices: sigma 0, label INF32, value 0."""
    u = np.array([0, 1, 2, 4], dtype=np.int64)
    v = np.array([1, 2, 3, 5], dtype=np.int64)
    coo = (6, np.concatenate([u, v]), np.concatenate([v, u]), None)
    ref = RefCsr.from_coo(RefCoo(*coo))
    port = CsrGraph.from_coo(CooGraph(*coo))
    got = bc.run(port, src=0, mode="planes", device="cpu")
    want = ref_bc.run(ref, src=0, mode="planes")
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.labels[4:], [INF32, INF32])
    np.testing.assert_allclose(got.bc_values, want.bc_values, rtol=1e-5,
                               atol=1e-7)
    assert np.all(got.sigmas[4:] == 0) and np.all(got.bc_values[4:] == 0)
    _check_oracles(got, port, 0)


@pytest.mark.parametrize("relabel", ["1", "force"])
def test_bc_bitwise_deterministic(monkeypatch, relabel):
    """Two calls give the same bits (the reference's
    tests/test_determinism.py holds its BC to the same, on a dataset)."""
    _, port = _pair("rmat8_directed", relabel, monkeypatch)
    a = bc.run(port, src=3, mode="planes", device="cpu")
    b = bc.run(port, src=3, mode="planes", device="cpu")
    for x, y in ((a.bc_values, b.bc_values), (a.sigmas, b.sigmas)):
        np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))
    np.testing.assert_array_equal(a.labels, b.labels)


def test_bc_sweeps_are_gated_add_sweeps_on_both_cscs(monkeypatch):
    _, port = _pair("rmat8_directed", "force", monkeypatch)
    fn = bc.get_bc_planes(port, CPU)
    g = search_graph(port, CPU)
    assert fn.fwd is add_stepper(g, gated=True)
    assert fn.rev is add_stepper(g, reverse=True, gated=True)
    assert fn.fwd.offsets is g.stepper.offsets
    assert fn.rev.in_src is g.reverse()[1]
    for st in (fn.fwd, fn.rev):
        assert isinstance(st, value.ValueStepper)
        assert (st.mode, st.f32, st.use_active) == ("add", True, True)


def test_bc_unported_modes_and_bad_inputs_raise():
    """The modes that raised before this slice (all sources, the
    default, and one source, both "xla") now run and equal the JAX
    package's; bad inputs still raise."""
    ro, ci = np.array([0, 1, 2, 2]), np.array([1, 2])
    port = CsrGraph.from_arrays(ro, ci)
    ref = RefCsr(row_offsets=ro, col_indices=ci)
    for got, want in ((bc.run(port, device="cpu"), ref_bc.run(ref)),
                      (bc.run(port, src=0, mode="xla", device="cpu"),
                       ref_bc.run(ref, src=0, mode="xla"))):
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.sigmas, want.sigmas)
        np.testing.assert_allclose(got.bc_values, want.bc_values,
                                   rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError):
        bc.run(port, src=-1, mode="planes", device="cpu")
    with pytest.raises(ValueError):
        bc.run(port, src=3, mode="planes", device="cpu")
    with pytest.raises(TypeError):
        bc.run(object(), src=0, mode="planes", device="cpu")


def test_bc_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    port = CsrGraph.from_arrays(np.array([0, 1, 1]), np.array([1]))
    with pytest.raises(RuntimeError, match="CUDA"):
        bc.run(port, src=0, mode="planes")
    with pytest.raises(RuntimeError, match="CUDA"):
        bc.get_bc_planes(port)
