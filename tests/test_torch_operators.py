"""Port parity: the operator layer (gunrockinst_tpu_torch.graph.csr's
DeviceGraph and ops/segment, frontier, filter, advance and priority)
against the JAX package's, on the same seeded inputs: DeviceGraph field
for field; int, bool, min and max results bitwise; float adds allclose
(rtol 1e-6) and bitwise equal between two calls.

device="cpu" throughout; JAX runs on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.csr import DeviceGraph as RefDevice
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.ops import advance as ref_adv
from gunrockinst_tpu.ops import filter as ref_filter
from gunrockinst_tpu.ops import frontier as ref_fr
from gunrockinst_tpu.ops import priority as ref_pri
from gunrockinst_tpu.ops import segment as ref_seg

from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph
from gunrockinst_tpu_torch.ops import advance, filter as port_filter
from gunrockinst_tpu_torch.ops import frontier, priority, segment

CPU = torch.device("cpu")


def _coo_graph(n, rows, cols, values=None, undirected=False):
    return RefCsr.from_coo(RefCoo(n, np.asarray(rows, np.int64),
                                  np.asarray(cols, np.int64), values),
                           undirected=undirected)


GRAPHS = {
    # 200 vertices, directed, weights 1..63 (n not a multiple of 128)
    "random200": lambda: _coo_graph(
        200, *np.random.default_rng(7).integers(0, 200, (2, 1500)),
        np.random.default_rng(8).integers(1, 64, 1500).astype(np.float32)),
    "rmat8_undirected": lambda: ref_rmat(8, 8, undirected=True, seed=5),
    "rmat9_directed": lambda: ref_rmat(9, 4, undirected=False, seed=9),
    # a path 0-1-...-9, a star into 0 plus isolated vertex 20
    "path": lambda: _coo_graph(10, np.arange(9), np.arange(1, 10),
                               undirected=True),
    "star": lambda: _coo_graph(21, np.arange(1, 20), np.zeros(19)),
    # no edge at all
    "edgeless": lambda: _coo_graph(5, [], []),
    # 128 edges exactly: no padding edge
    "full_edges": lambda: _coo_graph(
        64, np.arange(128) % 64, (np.arange(128) % 64 + 1
                                  + np.arange(128) // 64) % 64),
}


def _pair(name, **kw):
    ref = GRAPHS[name]()
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices,
                                ref.edge_values)
    return (RefDevice.build(ref, **kw),
            DeviceGraph.build(port, device=CPU, **kw))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.asarray(a))


FIELDS = ("row_offsets", "edge_src", "edge_dst", "edge_w", "out_degree",
          "col_offsets", "csc_src", "csc_dst", "csc_w", "csc_edge_id",
          "in_degree")


def _assert_same_graph(rg, pg):
    assert (pg.n, pg.m, pg.n_pad, pg.m_pad, pg.dummy, pg.has_csc) == (
        rg.n, rg.m, rg.n_pad, rg.m_pad, rg.dummy, rg.has_csc)
    for f in FIELDS:
        want, got = getattr(rg, f), getattr(pg, f)
        if want is None:
            assert got is None, f
            continue
        assert got.dtype in (torch.int32, torch.float32), f
        np.testing.assert_array_equal(_np(got), np.asarray(want), f)
        assert _np(got).dtype == np.asarray(want).dtype, f


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("kw", [{}, dict(with_csc=False),
                                dict(with_values=False)])
def test_device_graph_matches_reference(name, kw):
    rg, pg = _pair(name, **kw)
    _assert_same_graph(rg, pg)
    assert pg.device == CPU
    if pg.has_csc:
        _assert_same_graph(rg.reverse_view(), pg.reverse_view())
    else:
        with pytest.raises(ValueError):
            pg.reverse_view()


def test_to_device_and_node_values_cache(tmp_path):
    ref = GRAPHS["random200"]()
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices,
                                ref.edge_values)
    _assert_same_graph(RefDevice.build(ref),
                       port.to_device(device="cpu"))
    port.node_values = np.arange(port.num_nodes, dtype=np.float32)
    port.save(str(tmp_path / "g.npz"))
    back = CsrGraph.load(str(tmp_path / "g.npz"))
    np.testing.assert_array_equal(back.node_values, port.node_values)
    np.testing.assert_array_equal(back.edge_values, port.edge_values)


# -- ops/segment.py --------------------------------------------------------

def _scatter_inputs(dtype, seed):
    rng = np.random.default_rng(seed)
    size = 300
    ids = rng.integers(-320, 330, 2000).astype(np.int32)  # some dropped
    if dtype == np.float32:
        vals = rng.standard_normal(2000).astype(np.float32)
        init = rng.standard_normal(size).astype(np.float32)
    else:
        vals = rng.integers(-1000, 1000, 2000).astype(np.int32)
        init = rng.integers(-1000, 1000, size).astype(np.int32)
    return init, ids, vals


@pytest.mark.parametrize("name", ["min", "max", "add"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_scatter_matches_reference(name, dtype):
    init, ids, vals = _scatter_inputs(dtype, 3)
    scatter, ident_of = segment.combine_fn(name)
    ref_scatter, ref_ident_of = ref_seg.combine_fn(name)
    assert ident_of(torch.from_numpy(init).dtype) == ref_ident_of(
        jnp.dtype(dtype))
    got = scatter(_t(init), _t(ids), _t(vals))
    again = scatter(_t(init), _t(ids), _t(vals))
    want = np.asarray(ref_scatter(jnp.asarray(init), jnp.asarray(ids),
                                  jnp.asarray(vals)))
    assert got.dtype == _t(init).dtype
    if name == "add" and dtype == np.float32:
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(_np(got).view(np.int32),
                                      _np(again).view(np.int32))
    else:
        np.testing.assert_array_equal(_np(got), want)


def test_scatter_or_matches_reference():
    rng = np.random.default_rng(4)
    init = rng.random(300) < 0.1
    ids = rng.integers(-320, 330, 900).astype(np.int32)
    flags = rng.random(900) < 0.3
    got = segment.scatter_or(_t(init), _t(ids), _t(flags))
    want = ref_seg.scatter_or(jnp.asarray(init), jnp.asarray(ids),
                              jnp.asarray(flags))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert segment.combine_fn("or")[1](torch.bool) is False


@pytest.mark.parametrize("name", ["random200", "rmat9_directed", "star"])
def test_edge_sums_match_scatter_add(name):
    """sum_by_src and sum_by_dst (one value per edge, with and without
    csc_edge_id, batched) equal the reference's scatter-add at the
    edges' sources and destinations."""
    rg, pg = _pair(name)
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((3, pg.m_pad)).astype(np.float32)
    for got_fn, ids in ((segment.sum_by_src, rg.edge_src),
                        (segment.sum_by_dst, rg.edge_dst)):
        for g in (pg, dataclasses.replace(pg, csc_edge_id=None)):
            got = got_fn(g, _t(vals))
            assert got.shape == (3, pg.n_pad)
            for k in range(3):
                want = ref_seg.scatter_add(jnp.zeros(pg.n_pad), ids,
                                           jnp.asarray(vals[k]))
                np.testing.assert_allclose(_np(got[k]), np.asarray(want),
                                           rtol=1e-6, atol=1e-6)
                np.testing.assert_array_equal(
                    _np(got_fn(g, _t(vals[k]))), _np(got[k]))


# -- ops/frontier.py and ops/filter.py -------------------------------------

@pytest.mark.parametrize("cap", [1, 37, 300, 520])
def test_frontier_matches_reference(cap):
    rng = np.random.default_rng(cap)
    mask = rng.random(512) < 0.2
    ids, count = frontier.compact(_t(mask), cap, fill=500)
    rids, rcount = ref_fr.compact(jnp.asarray(mask), cap, fill=500)
    np.testing.assert_array_equal(_np(ids), np.asarray(rids))
    assert ids.dtype == torch.int32 and int(count) == int(rcount)
    assert int(frontier.frontier_size(_t(mask))) == int(
        ref_fr.frontier_size(jnp.asarray(mask)))
    some = rng.integers(-600, 600, 40).astype(np.int32)
    keep = (some >= 0) & (some < 512)     # the reference wraps negatives
    np.testing.assert_array_equal(
        _np(frontier.bitmap_from_ids(_t(some[keep]), 512)),
        np.asarray(ref_fr.bitmap_from_ids(jnp.asarray(some[keep]), 512)))
    np.testing.assert_array_equal(
        _np(frontier.singleton_bitmap(cap % 512, 512, CPU)),
        np.asarray(ref_fr.singleton_bitmap(cap % 512, 512)))
    assert not frontier.empty_bitmap(512, CPU).any()


@pytest.mark.parametrize("name", ["random200", "path"])
def test_filter_matches_reference(name):
    rg, pg = _pair(name)
    rng = np.random.default_rng(6)
    front = rng.random(pg.n_pad) < 0.5
    visited = rng.random(pg.n_pad) < 0.3
    state = rng.integers(0, 3, pg.n_pad).astype(np.int32)
    got = port_filter.filter_frontier(
        pg, _t(front), lambda v, s: s[v] != 0, _t(state), _t(visited))
    want = ref_filter.filter_frontier(
        rg, jnp.asarray(front), lambda v, s: s[v] != 0, jnp.asarray(state),
        jnp.asarray(visited))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(
        _np(port_filter.filter_frontier(pg, _t(front))),
        np.asarray(ref_filter.filter_frontier(rg, jnp.asarray(front))))


# -- ops/advance.py --------------------------------------------------------

def _functors(dtype):
    """The same edge functor for both packages: pass edges whose
    destination state is even; payload src (int) or w * state[src]."""
    def port_fn(s, d, w, eid, state):
        pay = s if dtype == np.int32 else w * state[s].to(torch.float32)
        return state[d] % 2 == 0, pay

    def ref_fn(s, d, w, eid, state):
        pay = s if dtype == np.int32 else w * state[s].astype(jnp.float32)
        return state[d] % 2 == 0, pay
    return port_fn, ref_fn


@pytest.mark.parametrize("name", ["random200", "rmat8_undirected",
                                  "full_edges"])
@pytest.mark.parametrize("combine,dtype", [
    ("min", np.int32), ("max", np.int32), ("or", np.int32),
    ("add", np.float32), ("min", np.float32)])
def test_advance_dense_and_reduce_match_reference(name, combine, dtype):
    rg, pg = _pair(name)
    rng = np.random.default_rng(11)
    front = rng.random(pg.n_pad) < 0.3
    state = rng.integers(0, 9, pg.n_pad).astype(np.int32)
    port_fn, ref_fn = _functors(dtype)
    pdt = torch.int32 if dtype == np.int32 else torch.float32
    for reverse in (False, True):
        for f in (front, None):
            got = advance.advance_dense(
                pg, None if f is None else _t(f), port_fn, _t(state),
                combine=combine, payload_dtype=pdt, reverse=reverse)
            want = ref_adv.advance_dense(
                rg, None if f is None else jnp.asarray(f), ref_fn,
                jnp.asarray(state), combine=combine,
                payload_dtype=jnp.dtype(dtype), reverse=reverse)
            _assert_combined(got, want, combine, dtype)
            again = advance.advance_dense(
                pg, None if f is None else _t(f), port_fn, _t(state),
                combine=combine, payload_dtype=pdt, reverse=reverse)
            np.testing.assert_array_equal(_np(got[0]), _np(again[0]))
    got = advance.neighborhood_reduce(pg, _t(front), port_fn, _t(state),
                                      combine=combine, payload_dtype=pdt)
    want = ref_adv.neighborhood_reduce(rg, jnp.asarray(front), ref_fn,
                                       jnp.asarray(state), combine=combine,
                                       payload_dtype=jnp.dtype(dtype))
    _assert_combined((got, None), (want, None), combine, dtype)


def _assert_combined(got, want, combine, dtype):
    if combine == "add" and dtype == np.float32:
        np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]),
                                   rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    if got[1] is not None:
        np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))


def test_advance_without_payload_gives_touched_twice():
    rg, pg = _pair("random200")
    front = np.random.default_rng(2).random(pg.n_pad) < 0.2
    got = advance.advance_dense(pg, _t(front),
                                lambda s, d, w, e, st: (d >= 0, None))
    want = ref_adv.advance_dense(rg, jnp.asarray(front),
                                 lambda s, d, w, e, st: (d >= 0, None))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("name", ["random200", "rmat8_undirected", "star"])
@pytest.mark.parametrize("share,e_cap", [(0.05, 64), (0.3, 512),
                                         (0.3, None), (1.0, 100)])
def test_expand_frontier_matches_reference(name, share, e_cap):
    """Every output lane equal, also when the frontier's degree sum
    exceeds e_cap (the tail cut off) and when cap > the count."""
    rg, pg = _pair(name)
    rng = np.random.default_rng(int(share * 100))
    front = rng.random(pg.n_pad) < share
    front[pg.n:] = False
    cap = pg.n_pad
    ids, num = frontier.compact(_t(front), cap, pg.n)
    rids, rnum = ref_fr.compact(jnp.asarray(front), cap, pg.n)
    need = int(advance.degree_sum(pg, _t(front)))
    assert need == int(ref_adv.degree_sum(rg, jnp.asarray(front)))
    e_cap = e_cap or max(need, 1)
    got = advance.expand_frontier(pg, ids, num, e_cap)
    want = ref_adv.expand_frontier(rg, rids, rnum, e_cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    port_fn, ref_fn = _functors(np.int32)
    state = rng.integers(0, 9, pg.n_pad).astype(np.int32)
    got = advance.advance_sparse(pg, ids, num, port_fn, _t(state),
                                 combine="min", payload_dtype=torch.int32,
                                 e_cap=e_cap)
    want = ref_adv.advance_sparse(rg, rids, rnum, ref_fn,
                                  jnp.asarray(state), combine="min",
                                  payload_dtype=jnp.int32, e_cap=e_cap)
    _assert_combined(got, want, "min", np.int32)


# -- ops/priority.py -------------------------------------------------------

@pytest.mark.parametrize("delta", [0.7, 3.0, 25.0])
def test_priority_matches_reference(delta):
    rng = np.random.default_rng(int(delta * 10))
    pending = rng.random(384) < 0.4
    keys = np.where(rng.random(384) < 0.9,
                    rng.random(384) * 100, np.inf).astype(np.float32)
    d_t = torch.tensor(delta, dtype=torch.float32)
    for level in (0, 3, 40):
        near, far = priority.near_far_split(_t(pending), _t(keys), level,
                                            d_t)
        rnear, rfar = ref_pri.near_far_split(
            jnp.asarray(pending), jnp.asarray(keys), jnp.int32(level),
            jnp.float32(delta))
        np.testing.assert_array_equal(_np(near), np.asarray(rnear))
        np.testing.assert_array_equal(_np(far), np.asarray(rfar))
        for p in (pending, np.zeros_like(pending)):
            got = priority.next_nonempty_level(_t(p), _t(keys), level, d_t)
            want = ref_pri.next_nonempty_level(
                jnp.asarray(p), jnp.asarray(keys), jnp.int32(level),
                jnp.float32(delta))
            assert got == int(want)
