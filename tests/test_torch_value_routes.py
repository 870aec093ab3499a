"""Port parity: the value sweep's three routes (gunrockinst_tpu_torch.ops
.value: "dense", "push", "touched") against the JAX package's
ValueStepper in Pallas interpret mode, the route rule, and the SSSP and
CC fixpoints with each route forced.

On the CPU the wrapper runs the plain version of the route it chose or
was given (`sweep_reference`, `push_reference`, `touched_reference`);
chip_smoke.py holds the card's kernels against the same plain versions.
Min sweeps are held bitwise (values, changed map, its count), the gated
add allclose (rtol 1e-6, atol 1e-6), as the JAX kernel sums in another
order."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.ops import pallas_value as pv
from gunrockinst_tpu.primitives import cc as ref_cc
from gunrockinst_tpu.primitives import sssp as ref_sssp

from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.ops import value
from gunrockinst_tpu_torch.ops.words import (mask_from_words,
                                             words_from_mask, word_rows)
from gunrockinst_tpu_torch.primitives import cc, sssp

CPU = torch.device("cpu")

# the JAX callers' settings (sssp.py:199, cc.py:108, bc.py's gated add)
CONFIGS = {
    "sssp_w": dict(mode="min", f32=True),          # weights per edge
    "sssp_c": dict(mode="min", f32=True, const_w=1.0),
    "cc": dict(mode="min", f32=False),
    "bc_add": dict(mode="add", f32=True, use_active=True),
}
ROUTES_OF = {name: (("dense", "touched") if cfg["mode"] == "add"
                    else value.ROUTES) for name, cfg in CONFIGS.items()}


def _coo(n, src, dst, seed):
    w = np.random.default_rng(seed).integers(1, 64, len(src)).astype(
        np.float32)
    return RefCsr.from_coo(RefCoo(n, np.asarray(src), np.asarray(dst), w))


def _random(n, m, seed, hub_edges=0):
    """Seeded random directed graph with integer weights 1..63; with
    `hub_edges`, that many more edges end at vertex 7."""
    rng = np.random.default_rng(seed)
    es = rng.integers(0, n, m + hub_edges)
    ed = np.concatenate([rng.integers(0, n, m), np.full(hub_edges, 7)])
    return _coo(n, es, ed, seed)


def _star(n, into):
    centre = n // 2 + 5
    leaves = np.delete(np.arange(n), centre)
    hub = np.full(leaves.size, centre)
    return _coo(n, leaves, hub, n) if into else _coo(n, hub, leaves, n)


GRAPHS = {
    "random600": lambda: _random(600, 4000, 3),
    # ten 4096-vertex source regions, and a hub of ~900 in-edges
    "multiregion40k_hub": lambda: _random(40000, 20000, 11, hub_edges=900),
    # every edge into one vertex (mid-word), and every edge out of it
    "star1003_in": lambda: _star(1003, True),
    "star1003_out": lambda: _star(1003, False),
    # n % 32 != 0, 40 more edges into vertex n-1
    "ragged1001": lambda: _coo(
        1001, np.concatenate([np.random.default_rng(5).integers(
            0, 1001, 8000), np.arange(40)]),
        np.concatenate([np.random.default_rng(6).integers(0, 1001, 8000),
                        np.full(40, 1000)]), 1001),
}


@functools.lru_cache(maxsize=None)
def _graph(name):
    return GRAPHS[name]()


def _stepper(ref, name, give_out_edges=True, **kw):
    """The port's stepper of configuration `name` on ref's CSC; the
    out-edge CSR given (ref's own CSR) unless the configuration has
    per-edge weights or give_out_edges is False."""
    csc = ref.transposed()
    cfg = dict(CONFIGS[name], **kw)
    if name == "sssp_w":
        cfg["weights"] = torch.from_numpy(csc.edge_values.astype(np.float32))
    elif give_out_edges:
        out = (torch.from_numpy(ref.row_offsets.astype(np.int32)),
               torch.from_numpy(ref.col_indices.astype(np.int32)))
        cfg["out_edges"] = lambda: out
    return value.ValueStepper(
        torch.from_numpy(csc.row_offsets.astype(np.int32)),
        torch.from_numpy(csc.col_indices.astype(np.int32)), **cfg)


def _inputs(name, n, seed, share=0.5):
    """Vertex-major values (f32 or i32 numpy, non-negative, 30% inf for
    the f32 min) and the active mask (`share` of the vertices)."""
    rng = np.random.default_rng(seed)
    if name == "cc":
        vals = rng.integers(0, n, n).astype(np.int32)
    elif name == "bc_add":
        vals = rng.random(n, dtype=np.float32)
    else:
        vals = (rng.random(n, dtype=np.float32) * 100).astype(np.float32)
        vals[rng.random(n) < 0.3] = np.inf
    return vals, rng.random(n) < share


@functools.lru_cache(maxsize=None)
def _jax_sweeps(graph, name):
    """The JAX ValueStepper's result of two chained sweeps (one for the
    add) from the seeded inputs: [(values, changed words)]."""
    ref = _graph(graph)
    n = ref.num_nodes
    csc = ref.transposed()
    cfg = dict(CONFIGS[name])
    add = cfg["mode"] == "add"
    plan = pv.build_value_plan(
        csc.row_offsets, csc.col_indices, n,
        weights=csc.edge_values if name == "sssp_w" else None)
    st = pv.ValueStepper(plan, interpret=True, zero_acc=add,
                         track_changed=not add, **cfg)
    vals, active = _inputs(name, n, len(graph) + len(name))
    acc = jnp.asarray(pv.to_bitmajor_np(vals, word_rows(n)))
    ch = jnp.asarray(words_from_mask(active, plan.n_words))
    dtype = np.float32 if cfg["f32"] else np.int32
    out = []
    for _ in range(1 if add else 2):
        acc, ch = st(acc, ch)
        out.append((pv.from_bitmajor_np(np.asarray(acc), n, dtype),
                    np.asarray(ch)))
    return tuple(out)


CASES = [(g, name, route) for g in sorted(GRAPHS)
         for name in sorted(CONFIGS) for route in ROUTES_OF[name]]


@pytest.mark.parametrize("graph,name,route", CASES)
def test_route_matches_jax_stepper(graph, name, route):
    """Each route's plain version, forced, over two chained sweeps (one
    for the add): bitwise for min (values, changed map, its count, and
    the changed vertices' out-edge total), allclose for the gated add."""
    ref = _graph(graph)
    n = ref.num_nodes
    st = _stepper(ref, name)
    vals, active = _inputs(name, n, len(graph) + len(name))
    x = np.zeros(st.n_pad, np.int32)
    x[:n] = vals.view(np.int32)
    x = torch.from_numpy(x)
    ch = torch.from_numpy(words_from_mask(active, st.n_words))
    out_deg = np.diff(ref.row_offsets)
    dtype = np.float32 if st.f32 else np.int32
    for want, want_ch in _jax_sweeps(graph, name):
        x, ch, counts = st._sweep(x, ch, None, route)
        assert st.last_route() == route
        got = x.numpy()[:n].view(dtype)
        if st.mode == "add":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            assert not ch.numpy().any() and counts.tolist() == [0, 0]
            continue
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))   # bitwise
        np.testing.assert_array_equal(ch.numpy(), want_ch)
        mask = mask_from_words(ch.numpy(), n)
        assert counts.tolist() == [int(mask.sum()),
                                   int(out_deg[mask].sum())]


@pytest.mark.parametrize("share", [0.0, 0.001, 0.1, 1.0])
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("graph", ["multiregion40k_hub", "star1003_out",
                                   "ragged1001"])
def test_touched_reference_equals_dense(graph, name, share):
    """`touched_reference` bitwise against `sweep_reference` (the add
    too: the untouched words' dense sum is an empty one, 0)."""
    ref = _graph(graph)
    n = ref.num_nodes
    st = _stepper(ref, name)
    vals, active = _inputs(name, n, 17, share)
    x = torch.zeros(st.n_pad, dtype=torch.int32)
    x[:n] = torch.from_numpy(vals.view(np.int32))
    ch = torch.from_numpy(words_from_mask(active, st.n_words))
    out_off, out_dst, _ = st.out_csr()
    got = value.touched_reference(
        st.offsets, st.in_src, out_off, out_dst, x, ch, mode=st.mode,
        f32=st.f32, weights=st.weights, const_w=st.const_w)
    want = value.sweep_reference(
        st.offsets, st.in_src, x, ch, mode=st.mode, f32=st.f32,
        weights=st.weights, const_w=st.const_w)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_asymmetric_weights_on_a_symmetric_structure():
    """A structurally symmetric graph whose weights differ per direction:
    the weighted stepper builds its own out-edge order and permutes the
    weights through each out-edge's CSC edge id, so the push equals the
    pull bitwise; the CSC-order weights, read in out-edge order as a
    symmetric graph's forward tensors would give them, do not."""
    rng = np.random.default_rng(23)
    n = 700
    src, dst = rng.integers(0, n, 5000), rng.integers(0, n, 5000)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    both_s = np.concatenate([src, dst])
    both_d = np.concatenate([dst, src])
    w = rng.integers(1, 64, both_s.size).astype(np.float32)   # per direction
    ref = RefCsr.from_coo(RefCoo(n, both_s, both_d, w))
    csc = ref.transposed()
    assert np.array_equal(csc.row_offsets, ref.row_offsets)
    assert np.array_equal(csc.col_indices, ref.col_indices)   # symmetric
    assert not np.array_equal(csc.edge_values, ref.edge_values)
    st = _stepper(ref, "sssp_w")
    out_off, out_dst, out_w = st.out_csr()
    assert torch.equal(out_off, st.offsets) and torch.equal(out_dst,
                                                            st.in_src)
    vals, active = _inputs("sssp_w", n, 29)
    vals[~np.isfinite(vals)] = 1e3
    x = torch.zeros(st.n_pad, dtype=torch.int32)
    x[:n] = torch.from_numpy(vals.view(np.int32))
    ch = torch.from_numpy(words_from_mask(active, st.n_words))
    dense = st.reference(x, ch, "dense")
    for a, b in zip(st.reference(x, ch, "push"), dense):
        assert torch.equal(a, b)
    wrong = value.push_reference(out_off, out_dst, x, ch, f32=True,
                                 out_w=st.weights)
    assert not torch.equal(wrong[0], dense[0])


@pytest.mark.parametrize("case", ["inf", "empty", "all"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_routes_on_inf_empty_and_full_active_sets(name, case):
    """Every route of every configuration on values that are all +inf
    but one (an f32 min), an empty active set and every source active:
    bitwise equal to the dense plain version, the add too."""
    ref = _graph("ragged1001")
    n = ref.num_nodes
    st = _stepper(ref, name, give_out_edges=False)
    vals, active = _inputs(name, n, 31)
    if case == "inf" and st.f32:
        vals[:] = np.inf if st.mode == "min" else 0.0
        vals[3] = 2.0
    active[:] = case != "empty"
    x = torch.zeros(st.n_pad, dtype=torch.int32)
    x[:n] = torch.from_numpy(vals.view(np.int32))
    ch = torch.from_numpy(words_from_mask(active, st.n_words))
    want = st.reference(x, ch, "dense")
    for route in ROUTES_OF[name]:
        got = st._sweep(x, ch, None, route)
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a, b)
        assert int(got[2][0]) == int(want[2])
    if case == "empty":
        assert st.stats(ch) == (0, 0)
        assert int(want[2]) == 0
    if case == "all":
        assert st.stats(ch) == (n, ref.num_edges)


def test_what_the_routes_give_on_negative_zero_and_inf():
    """The push compares integer bits: -0.0's are below every
    non-negative float's, so a -0.0 candidate lands on a +0.0 value
    where the dense min keeps +0.0; a stepper that could meet one (a
    -0.0 or negative const_w or weight, or no weight at all) never
    pushes.  +inf values and candidates give the same bits in every
    route."""
    ref = _coo(64, [1, 2], [0, 0], 3)           # 1 -> 0, 2 -> 0
    csc = ref.transposed()
    off = torch.from_numpy(csc.row_offsets.astype(np.int32))
    src = torch.from_numpy(csc.col_indices.astype(np.int32))
    out_off = torch.from_numpy(ref.row_offsets.astype(np.int32))
    out_dst = torch.from_numpy(ref.col_indices.astype(np.int32))
    st = value.ValueStepper(off, src, mode="min", f32=True, const_w=0.0)
    x = torch.full((st.n_pad,), float("inf")).view(torch.int32)
    xf = x.view(torch.float32)
    xf[0], xf[1] = 0.0, -0.0
    ch = torch.from_numpy(words_from_mask(np.arange(64) == 1, st.n_words))
    pushed = value.push_reference(out_off, out_dst, x, ch, f32=True)
    assert int(pushed[0][0]) == -2**31            # the bits of -0.0
    dense = value.sweep_reference(off, src, x, ch, mode="min", f32=True)
    assert float(dense[0].view(torch.float32)[0]) == 0.0
    assert int(pushed[2]) == int(dense[2]) == 0   # +0.0 > -0.0 is false
    for kw in (dict(const_w=-0.0), dict(const_w=-1.0), dict(),
               dict(weights=torch.tensor([1.0, -0.0])),
               dict(weights=torch.tensor([1.0, float("nan")]))):
        bad = value.ValueStepper(off, src, mode="min", f32=True, **kw)
        assert not bad.push_ok
        assert bad.choose_route(0) != "push"
        with pytest.raises(ValueError, match="cannot push"):
            bad.sweep(x, ch, route="push")
    assert st.push_ok
    xf[1] = float("inf")                          # inf + 0.0 = inf
    ch2 = torch.from_numpy(words_from_mask(np.ones(64, bool), st.n_words))
    want = st.reference(x, ch2, "dense")
    for route in value.ROUTES:
        got = st.sweep(x, ch2, route=route)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_route_rule_on_made_up_counts():
    """choose_route against the shares: push below PUSH_SHARE * m (a
    min that may push), touched below the touched share, else dense; an
    ungated sweep is dense and an add never pushes."""
    m = 10_000_000
    push, touched = value.route_limits(m, mode="min", gated=True,
                                       push_ok=True)
    assert push == int(value.PUSH_SHARE * m)
    assert touched == max(push, int(value.TOUCHED_SHARE * m))
    rule = functools.partial(value.choose_route, m=m)
    assert rule(0, mode="min", gated=True, push_ok=True) == "push"
    assert rule(push - 1, mode="min", gated=True, push_ok=True) == "push"
    assert rule(push, mode="min", gated=True, push_ok=True) == (
        "touched" if touched > push else "dense")
    assert rule(touched, mode="min", gated=True, push_ok=True) == "dense"
    assert rule(m, mode="min", gated=True, push_ok=True) == "dense"
    _, t_add = value.route_limits(m, mode="add", gated=True, push_ok=True)
    assert t_add == int(value.TOUCHED_SHARE_ADD * m)
    assert rule(0, mode="add", gated=True, push_ok=True) == "touched"
    assert rule(t_add, mode="add", gated=True, push_ok=True) == "dense"
    assert rule(0, mode="min", gated=True, push_ok=False) == "touched"
    for mode in ("min", "add"):
        assert rule(0, mode=mode, gated=False, push_ok=True) == "dense"


@pytest.mark.parametrize("share", [0.0005, 0.5, 1.0])
def test_sweep_without_a_route_follows_the_rule(share):
    """On the CPU `sweep(route=None)` takes the rule's route on the
    active sources' out-edge total, and `fixpoint` each round's route on
    the counts of the sweep before."""
    ref = _graph("multiregion40k_hub")
    n = ref.num_nodes
    st = _stepper(ref, "sssp_c")
    vals, active = _inputs("sssp_c", n, 41, share)
    x = torch.zeros(st.n_pad, dtype=torch.int32)
    x[:n] = torch.from_numpy(vals.view(np.int32))
    ch = torch.from_numpy(words_from_mask(active, st.n_words))
    edges = int(np.diff(ref.row_offsets)[active].sum())
    assert st.stats(ch) == (int(active.sum()), edges)
    got = st.sweep(x, ch)
    assert st.last_route() == st.choose_route(edges)
    for a, b in zip(got, st.reference(x, ch, "dense")):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="route must be"):
        st.sweep(x, ch, route="pull")
    add = _stepper(ref, "bc_add", use_active=False)
    with pytest.raises(ValueError, match="dense route only"):
        add.sweep(x, None, route="touched")


SSSP_GRAPHS = {
    "random200_directed": (lambda: ref_rmat(8, 6, undirected=False,
                                            seed=4), 0, True),
    "rmat10": (lambda: ref_rmat(10, 8, undirected=True, seed=10), 1,
               False),
}


@functools.lru_cache(maxsize=None)
def _sssp_pair(name):
    make, src, weighted = SSSP_GRAPHS[name]
    ref = make()
    if weighted:
        w = np.random.default_rng(8).integers(1, 64, ref.num_edges).astype(
            np.float32)
        ref = RefCsr(row_offsets=ref.row_offsets,
                     col_indices=ref.col_indices, edge_values=w)
    want = ref_sssp.run(ref, src, mode="planes")
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices,
                                ref.edge_values)
    return port, src, want


@pytest.mark.parametrize("route", [None, *value.ROUTES])
@pytest.mark.parametrize("name", sorted(SSSP_GRAPHS))
def test_sssp_fixpoint_with_each_route(name, route):
    port, src, want = _sssp_pair(name)
    fn = sssp.get_sssp_planes(port, CPU)
    assert fn.stepper.push_ok
    vals, ch = fn.start(src)
    vals, it = fn.stepper.fixpoint(vals, ch, fn.limit, route=route)
    dist = fn.g.to_input(vals.view(torch.float32)).numpy()
    np.testing.assert_array_equal(dist.view(np.int32),
                                  want.dist.view(np.int32))   # bitwise
    assert it == want.stats.search_depth


@functools.lru_cache(maxsize=None)
def _cc_pair(name):
    make = {"random200_directed": lambda: _random(200, 700, 7),
            "rmat10": lambda: ref_rmat(10, 4, undirected=True, seed=12)}[name]
    ref = make()
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)
    return port, ref_cc.run(ref, mode="planes")


@pytest.mark.parametrize("route", [None, *value.ROUTES])
@pytest.mark.parametrize("name", ["random200_directed", "rmat10"])
def test_cc_fixpoint_with_each_route(name, route):
    port, want = _cc_pair(name)
    fn = cc.get_cc_planes(port, CPU)
    vals, ch = fn.start()
    vals, it = fn.stepper.fixpoint(vals, ch, fn.limit, route=route)
    np.testing.assert_array_equal(fn.g.to_input(vals).numpy(),
                                  want.component_ids)
    assert it == want.stats.search_depth
