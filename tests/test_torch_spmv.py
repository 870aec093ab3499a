"""Port parity: the pull-SpMV (`ops/spmv.py::SpmvSweeper`) and PageRank
`mode="pallas"` against the JAX package's `SpmvSweeper` (Pallas
interpret mode on the CPU), its `pr.run(mode="pallas")` and the NumPy
oracle.

device="cpu" runs the kernel's plain version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.ops.pallas_spmv import SpmvSweeper as RefSweeper
from gunrockinst_tpu.ops.pallas_spmv import build_spmv_plan
from gunrockinst_tpu.primitives import pr as ref_pr

from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.ops import spmv, value
from gunrockinst_tpu_torch.oracles import pagerank_reference
from gunrockinst_tpu_torch.primitives import pr
from gunrockinst_tpu_torch.utils import trace

CPU = torch.device("cpu")
GRAPHS = {
    "rmat8_undirected": lambda: ref_rmat(8, 8, undirected=True, seed=5),
    "rmat8_directed": lambda: ref_rmat(8, 8, undirected=False, seed=9),
    # 600 vertices, 4200 random directed edges
    "random600": lambda: RefCsr.from_coo(RefCoo(
        600, *np.random.default_rng(21).integers(0, 600, (2, 4200)),
        None)),
}


def _pair(name):
    ref = GRAPHS[name]()
    return ref, CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)


def _contrib(n, n_pad, seed):
    c = np.zeros(n_pad, np.float32)
    c[:n] = np.random.default_rng(seed).random(n, dtype=np.float32)
    return c


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sweeper_matches_reference(name):
    ref, port = _pair(name)
    n = ref.num_nodes
    csc = ref.transposed()      # as the reference's get_spmv_sweeper
    plan = build_spmv_plan(csc.row_offsets, csc.col_indices, n)
    want = np.asarray(RefSweeper(plan, interpret=True)(
        jnp.asarray(_contrib(n, plan.out_rows * 128, 3))))[:n]
    sw = pr.get_spmv_sweeper(port, CPU)
    before = trace.totals().get("launch.spmv", 0)
    got = sw(torch.from_numpy(_contrib(n, sw.n_pad, 3)))
    # the plain version counts none
    assert trace.totals().get("launch.spmv", 0) == before
    assert got.dtype == torch.float32 and got.shape == (sw.n_pad,)
    np.testing.assert_allclose(got[:n].numpy(), want, rtol=1e-5, atol=1e-6)
    assert not got[n:].any()
    # the f64 sum over the input graph's in-edges
    c = _contrib(n, sw.n_pad, 3)
    esrc = np.repeat(np.arange(n), np.diff(ref.row_offsets))
    exact = np.bincount(ref.col_indices, weights=c[esrc].astype(np.float64),
                        minlength=n)
    np.testing.assert_allclose(got[:n].numpy(), exact, rtol=1e-5,
                               atol=1e-6)
    again = sw(torch.from_numpy(c), out=torch.empty(sw.n_pad))
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))


def test_sweeper_reads_the_unrelabeled_csc(monkeypatch):
    """Forced relabeling changes the BFS search graph, not the SpMV:
    it sweeps the input graph's own CSC, cached per graph and device."""
    monkeypatch.setenv("GT_BFS_RELABEL", "force")
    ref, port = _pair("rmat8_directed")
    sw = pr.get_spmv_sweeper(port, CPU)
    csc = ref.transposed()
    np.testing.assert_array_equal(sw.offsets.numpy(), csc.row_offsets)
    np.testing.assert_array_equal(sw.in_src.numpy(), csc.col_indices)
    assert pr.get_spmv_sweeper(port, "cpu") is sw
    c = torch.from_numpy(_contrib(port.num_nodes, sw.n_pad, 4))
    assert torch.equal(sw(c), spmv.sweep_reference(sw.offsets, sw.in_src,
                                                   c))


@pytest.mark.parametrize("src", [-1, 3])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pr_pallas_matches_reference(name, src):
    ref, port = _pair(name)
    got = pr.run(port, src=src, mode="pallas", device="cpu")
    want = ref_pr.run(ref, src=src, mode="pallas")
    np.testing.assert_allclose(got.ranks, want.ranks, rtol=1e-4, atol=1e-6)
    assert got.stats.search_depth == want.stats.search_depth
    np.testing.assert_allclose(got.ranks, pagerank_reference(port, src=src),
                               rtol=1e-4, atol=1e-6)
    # the same update rule as the planes route, on another CSC
    planes = pr.run(port, src=src, mode="planes", device="cpu")
    np.testing.assert_allclose(got.ranks, planes.ranks, rtol=1e-5,
                               atol=1e-6)
    order = np.lexsort((np.arange(port.num_nodes), -got.ranks))
    np.testing.assert_array_equal(got.node_ids, order)
    again = pr.run(port, src=src, mode="pallas", device="cpu")
    np.testing.assert_array_equal(again.ranks.view(np.int32),
                                  got.ranks.view(np.int32))


def test_pr_pallas_bad_inputs_raise():
    port = CsrGraph.from_arrays(np.array([0, 1, 2, 2]), np.array([1, 2]))
    with pytest.raises(ValueError):
        pr.run(port, src=3, mode="pallas", device="cpu")
    with pytest.raises(TypeError):
        pr.run(object(), mode="pallas", device="cpu")
    sw = pr.get_spmv_sweeper(port, CPU)
    with pytest.raises(ValueError):
        sw(torch.zeros(sw.n_pad, dtype=torch.int32))
    with pytest.raises(ValueError):
        sw(torch.zeros(sw.n_pad + 1))
    x = torch.zeros(sw.n_pad)
    with pytest.raises(ValueError):
        sw(x, out=x)


def test_sweeper_is_the_value_kernels_ungated_add_sweep():
    ref, port = _pair("random600")
    sw = pr.get_spmv_sweeper(port, CPU)
    st = sw.stepper
    assert (st.mode, st.f32, st.use_active) == ("add", True, False)
    assert st.offsets is sw.offsets and st.in_src is sw.in_src
    assert isinstance(st, value.ValueStepper)


def test_pr_pallas_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    port = CsrGraph.from_arrays(np.array([0, 1, 1]), np.array([1]))
    with pytest.raises(RuntimeError, match="CUDA"):
        pr.run(port, mode="pallas")
    with pytest.raises(RuntimeError, match="CUDA"):
        pr.get_spmv_sweeper(port)
    with pytest.raises(RuntimeError, match="CUDA"):
        pr.pr_pallas(port)
