"""Port parity: the level step (gunrockinst_tpu_torch.ops.mega) against
the JAX package's MegaStepper in Pallas interpret mode, for every level
of a search, bitwise.

The port's CUDA kernel runs only on the card; here the wrapper takes
its plain PyTorch version, `step_reference`, because the tensors lie
on the CPU.  chip_smoke.py holds the kernel against the same plain
version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.relabel import reach_words_for as ref_reach
from gunrockinst_tpu.graph.relabel import relabeled as ref_relabeled
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.ops import pallas_mega as pm

from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.graph.relabel import reach_words_for, relabeled
from gunrockinst_tpu_torch.ops import mega
from gunrockinst_tpu_torch.ops.words import word_rows
from gunrockinst_tpu_torch.utils import trace


def _two_components():
    # tests/test_bfs.py: 0-1-2 chain and a 3-4 pair
    u = np.array([0, 1, 3], dtype=np.int64)
    v = np.array([1, 2, 4], dtype=np.int64)
    return RefCsr.from_coo(RefCoo(5, np.concatenate([u, v]),
                                  np.concatenate([v, u]), None))


CASES = {
    # rmat-s16: n + 1 > 65536, three 32K-vertex regions
    "rmat16_multiregion": (lambda: ref_rmat(16, 2, undirected=True,
                                            seed=11), "1", (0, 40000)),
    "rmat13_directed_relabeled": (lambda: ref_rmat(13, 8, undirected=False,
                                                   seed=5),
                                  "force", (0, 777)),
    "two_components": (_two_components, "1", (0, 3)),
}


def _words_of(src, rows):
    fw = np.zeros(rows * 128, np.uint32)
    fw[src >> 5] = np.uint32(1) << np.uint32(src & 31)
    return fw.view(np.int32).reshape(rows, 128)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_reference_every_level(monkeypatch, case):
    make, relabel_mode, sources = CASES[case]
    monkeypatch.setenv("GT_BFS_RELABEL", relabel_mode)
    ref = make()
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)
    ref_p, ref_perm = ref_relabeled(ref)
    port_p, port_perm = relabeled(port)
    assert (ref_perm is None) == (relabel_mode != "force")
    if ref_perm is not None:
        np.testing.assert_array_equal(port_perm, ref_perm)
    n = ref.num_nodes
    rows = word_rows(n)
    ref_csc = ref_p.transposed()
    plan = pm.build_mega_plan(ref_csc.row_offsets, ref_csc.col_indices, n)
    assert plan.n_words == rows * 128
    ref_step = pm.MegaStepper(plan, planes=8, interpret=True)
    port_csc = port_p.transposed()
    stepper = mega.MegaStepper(port_csc.row_offsets, port_csc.col_indices,
                               "cpu")

    for src in sources:
        psrc = src if ref_perm is None else int(ref_perm[src])
        reach = reach_words_for(port_p, psrc, rows * 128)
        np.testing.assert_array_equal(
            reach, ref_reach(ref_p, psrc, rows * 128))
        fw = vw = _words_of(psrc, rows)
        pln = np.zeros((8 * rows, 128), np.int32)
        # in-place wrapper state, carried alongside
        w_vw = torch.from_numpy(vw.copy())
        w_pln = torch.from_numpy(pln.copy())
        w_fw = torch.from_numpy(fw.copy())
        reach_t = torch.from_numpy(reach)
        levels = 0
        for d in range(1, n + 1):
            want = [np.array(a) for a in ref_step.step_with(
                ref_step.hub_args, ref_step.pk_args, jnp.asarray(fw),
                jnp.asarray(vw), jnp.asarray(pln), d)]
            nfw, vw2, pln2, n_new = mega.step_reference(
                stepper.offsets, stepper.in_src, torch.from_numpy(fw),
                torch.from_numpy(vw), torch.from_numpy(pln), d, reach_t)
            for got, exp in zip((nfw, vw2, pln2), want):
                np.testing.assert_array_equal(got.numpy(), exp)
            assert int(n_new) == int(np.unpackbits(
                want[0].view(np.uint8)).sum())
            w_nfw, w_new = stepper.step(w_fw, w_vw, w_pln, d, reach_t)
            np.testing.assert_array_equal(w_nfw.numpy(), want[0])
            np.testing.assert_array_equal(w_vw.numpy(), want[1])
            np.testing.assert_array_equal(w_pln.numpy(), want[2])
            assert int(w_new) == int(n_new)
            fw, vw, pln = want
            w_fw = w_nfw
            levels += 1
            if not fw.any():
                break
        assert levels >= 2


def test_step_reference_skips_outside_reach():
    """nfw = touched & reach & ~vw: a vertex outside `reach` is never
    claimed, and a deep d sets only the planes of its bits."""
    # 0 -> 1, 0 -> 2
    port = CsrGraph.from_arrays(np.array([0, 2, 2, 2]), np.array([1, 2]))
    csc = port.transposed()
    st = mega.MegaStepper(csc.row_offsets, csc.col_indices, "cpu")
    fw = torch.from_numpy(_words_of(0, st.rows).copy())
    vw = fw.clone()
    reach = torch.from_numpy(_words_of(1, st.rows).copy()) | fw
    planes = torch.zeros((3 * st.rows, 128), dtype=torch.int32)
    nfw, n_new = st.step(fw, vw, planes, 5, reach)
    assert int(n_new) == 1 and int(nfw[0, 0]) == 0b10
    assert int(vw[0, 0]) == 0b11
    assert [int(planes[b * st.rows, 0]) for b in range(3)] == [2, 0, 2]


def test_step_wrapper_rejects_bad_inputs():
    port = CsrGraph.from_arrays(np.array([0, 1, 1]), np.array([1]))
    csc = port.transposed()
    st = mega.MegaStepper(csc.row_offsets, csc.col_indices, "cpu")
    good = lambda: torch.zeros((st.rows, 128), dtype=torch.int32)  # noqa
    planes = torch.zeros((8 * st.rows, 128), dtype=torch.int32)
    with pytest.raises(ValueError):     # wrong dtype
        st.step(good().long(), good(), planes, 1, good())
    with pytest.raises(ValueError):     # wrong shape
        st.step(good()[:1], good(), planes, 1, good())
    with pytest.raises(ValueError):     # aliased buffers
        fw = good()
        st.step(fw, fw, planes, 1, good())
    with pytest.raises(ValueError):     # depth 0 is the source's level
        st.step(good(), good(), planes, 0, good())
    before = trace.totals().get("launch.mega_step", 0)
    st.step(good(), good(), planes, 1, good())
    # the plain version is no launch
    assert trace.totals().get("launch.mega_step", 0) == before


@pytest.mark.parametrize("case", sorted(CASES))
def test_push_matches_reference_every_level(monkeypatch, case):
    """The plain push version, `push_reference`, over the relabeled
    out-CSR, equals `step_reference` and the JAX MegaStepper (Pallas
    interpret mode) bit for bit at every level of each search; so does
    the wrapper forced to push, forced to pull and left to choose."""
    make, relabel_mode, sources = CASES[case]
    monkeypatch.setenv("GT_BFS_RELABEL", relabel_mode)
    ref = make()
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)
    ref_p, ref_perm = ref_relabeled(ref)
    port_p, _ = relabeled(port)
    n = ref.num_nodes
    rows = word_rows(n)
    ref_csc = ref_p.transposed()
    plan = pm.build_mega_plan(ref_csc.row_offsets, ref_csc.col_indices, n)
    ref_step = pm.MegaStepper(plan, planes=8, interpret=True)
    port_csc = port_p.transposed()
    stepper = mega.MegaStepper(port_csc.row_offsets, port_csc.col_indices,
                               "cpu")
    out_off, out_dst = stepper.out_csr()
    np.testing.assert_array_equal(out_off.numpy(), port_p.row_offsets)
    np.testing.assert_array_equal(out_dst.numpy(), port_p.col_indices)
    for src in sources:
        psrc = src if ref_perm is None else int(ref_perm[src])
        reach = reach_words_for(port_p, psrc, rows * 128)
        reach_t = torch.from_numpy(reach)
        fw = vw = _words_of(psrc, rows)
        pln = np.zeros((8 * rows, 128), np.int32)
        taken = set()
        for d in range(1, n + 1):
            want = [np.array(a) for a in ref_step.step_with(
                ref_step.hub_args, ref_step.pk_args, jnp.asarray(fw),
                jnp.asarray(vw), jnp.asarray(pln), d)]
            args = (torch.from_numpy(fw), torch.from_numpy(vw),
                    torch.from_numpy(pln), d, reach_t)
            push = mega.push_reference(out_off, out_dst, *args)
            pull = mega.step_reference(stepper.offsets, stepper.in_src,
                                       *args)
            for got_push, got_pull, exp in zip(push, pull, want):
                np.testing.assert_array_equal(got_push.numpy(), exp)
                np.testing.assert_array_equal(got_pull.numpy(), exp)
            assert int(push[3]) == int(pull[3])
            for how in mega.DIRECTIONS:
                w_vw = torch.from_numpy(vw.copy())
                w_pln = torch.from_numpy(pln.copy())
                w_nfw, w_new = stepper.step(torch.from_numpy(fw.copy()),
                                            w_vw, w_pln, d, reach_t,
                                            direction=how)
                np.testing.assert_array_equal(w_nfw.numpy(), want[0])
                np.testing.assert_array_equal(w_vw.numpy(), want[1])
                np.testing.assert_array_equal(w_pln.numpy(), want[2])
                assert int(w_new) == int(pull[3])
                took = stepper.last_direction()
                assert took == (how if how != "auto" else took)
                if how == "auto":
                    edges, cand = mega.level_stats(out_off, *args[:2],
                                                   reach_t)
                    assert took == mega.choose_direction(edges, cand)
                    taken.add(took)
            fw, vw, pln = want
            if not fw.any():
                break
        assert taken    # the rule ran at every level


@pytest.mark.parametrize("edges,cand,want", [
    (0, 0, "pull"),            # nothing to claim: no push of an empty list
    (0, 1, "push"),            # an empty frontier: the push reads nothing
    (63727, 1048575, "push"),  # rmat-s20's first level from its hub
    (1000, 1000, "pull"),      # a tie goes to the pull
    (15_000_000, 984_000, "pull"),
    (2**31 - 1, 2**31 - 2, "pull"),
])
def test_choose_direction_rule(edges, cand, want):
    """Push exactly when the frontier's out-edges are fewer than the
    candidates (the kernel's `push_rule`)."""
    assert mega.choose_direction(edges, cand) == want


def test_level_stats_counts_by_hand():
    """The frontier's out-edge total and the candidates, on a graph
    small enough to count by hand: 0 -> 1, 0 -> 2, 1 -> 2, 2 -> 3."""
    port = CsrGraph.from_arrays(np.array([0, 2, 3, 4, 4]),
                                np.array([1, 2, 2, 3]))
    csc = port.transposed()
    st = mega.MegaStepper(csc.row_offsets, csc.col_indices, "cpu")
    out_off, _ = st.out_csr()
    words = lambda bits: torch.from_numpy(  # noqa: E731
        _words_of(bits[0], st.rows) | (_words_of(bits[1], st.rows)
                                       if len(bits) > 1 else 0))
    fw, vw = words([0, 1]), words([0, 1])
    reach = torch.full((st.rows, 128), -1, dtype=torch.int32)
    # out-edges of {0, 1}: 3; candidates: every vertex but 0 and 1 (2, 3)
    # and the padding bits past n = 4, which count for nothing
    assert mega.level_stats(out_off, fw, vw, reach) == (3, 2)
    assert mega.choose_direction(3, 2) == "pull"
    planes = torch.zeros((2 * st.rows, 128), dtype=torch.int32)
    nfw, n_new = st.step(fw, vw, planes, 1, reach)
    assert st.last_direction() == "pull" and int(n_new) == 1
    assert int(nfw[0, 0]) == 0b100


def test_step_wrapper_rejects_bad_direction():
    port = CsrGraph.from_arrays(np.array([0, 1, 1]), np.array([1]))
    csc = port.transposed()
    st = mega.MegaStepper(csc.row_offsets, csc.col_indices, "cpu")
    good = lambda: torch.zeros((st.rows, 128), dtype=torch.int32)  # noqa
    planes = torch.zeros((8 * st.rows, 128), dtype=torch.int32)
    with pytest.raises(RuntimeError):   # no level has run yet
        st.last_direction()
    for bad in ("sideways", "", None, 1):
        with pytest.raises(ValueError):
            st.step(good(), good(), planes, 1, good(), direction=bad)
    fw = st.start(0, candidates=1)
    assert int(fw[0, 0]) == 1 and fw.shape == (st.rows, 128)
    st.step(fw, fw.clone(), planes, 1, good(), direction="push")
    assert st.last_direction() == "push"


def test_search_graph_shares_one_out_csr():
    """The push's out-CSR is the search graph's `reverse()`: the CSC
    itself for a symmetric graph, one upload of the relabeled CSR for a
    directed one; the chain kernel reads the same tensors."""
    from gunrockinst_tpu_torch.primitives.search_graph import search_graph
    sym = CsrGraph.from_arrays(np.array([0, 1, 3, 4]),
                               np.array([1, 0, 2, 1]))
    g = search_graph(sym, torch.device("cpu"))
    out = g.stepper.out_csr()
    assert out[0] is g.stepper.offsets and out[1] is g.stepper.in_src
    directed = CsrGraph.from_arrays(np.array([0, 2, 3, 3]),
                                    np.array([1, 2, 2]))
    g = search_graph(directed, torch.device("cpu"))
    out = g.stepper.out_csr()
    assert out[0] is g.reverse()[0] and out[1] is g.reverse()[1]
    np.testing.assert_array_equal(out[0].numpy(), g.csr_p.row_offsets)
    np.testing.assert_array_equal(out[1].numpy(), g.csr_p.col_indices)


def test_first_candidates_counts_reach_without_source():
    from gunrockinst_tpu_torch.primitives.search_graph import first_candidates
    rows = word_rows(100)
    reach = np.zeros(rows * 128, np.uint32)
    reach[0] = 0b1011
    reach[2] = np.uint32(1) << np.uint32(31)
    words = reach.view(np.int32).reshape(rows, 128)
    assert first_candidates(words, 0) == 3       # 1, 3 and 95
    assert first_candidates(words, 95) == 3      # 0, 1 and 3
    assert first_candidates(words, 2) == 4       # 2 is not in reach
