"""Port parity: the value sweep (gunrockinst_tpu_torch.ops.value) against
the JAX package's ValueStepper in Pallas interpret mode, in each of the
four configurations that SSSP, CC and PR run: the min sweeps bitwise
(values and changed map) over two chained sweeps, the add sweep
allclose.

The port's CUDA kernel runs only on the card; here the wrapper takes
its plain PyTorch version, `sweep_reference`, because the tensors lie
on the CPU.  chip_smoke.py holds the kernel against the same plain
version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.ops import pallas_value as pv

from gunrockinst_tpu_torch.ops import value
from gunrockinst_tpu_torch.ops.words import (mask_from_words,
                                             words_from_mask, word_rows)
from gunrockinst_tpu_torch.utils import trace

# the JAX callers' settings (sssp.py:199, cc.py:108, pr.py:192); the
# port's mode sets what the JAX stepper's zero_acc and track_changed say
CONFIGS = {
    "sssp_w": dict(mode="min", f32=True),          # weights per edge
    "sssp_c": dict(mode="min", f32=True, const_w=1.0),
    "cc": dict(mode="min", f32=False),
    "pr": dict(mode="add", f32=True, use_active=False),
}


def _ref_config(cfg):
    add = cfg["mode"] == "add"
    return dict(cfg, zero_acc=add, track_changed=not add)


def _random(n, m, seed, hub_edges=0):
    """Seeded random directed graph with integer weights 1..63; with
    `hub_edges`, that many more edges end at vertex 7, whose word the
    card then walks with the whole warp."""
    rng = np.random.default_rng(seed)
    es = rng.integers(0, n, m + hub_edges)
    ed = np.concatenate([rng.integers(0, n, m), np.full(hub_edges, 7)])
    return RefCsr.from_coo(RefCoo(n, es, ed, rng.integers(
        1, 64, m + hub_edges).astype(np.float32)))


GRAPHS = {
    "random600": lambda: _random(600, 4000, 3),
    # ten 4096-vertex source regions, and a hub of ~900 in-edges
    "multiregion40k_hub": lambda: _random(40000, 20000, 11,
                                          hub_edges=900),
}


def _inputs(name, n, n_words, rng):
    """Vertex-major values (f32 or i32 numpy) and the changed mask."""
    if name == "cc":
        vals = rng.integers(0, n, n).astype(np.int32)
    elif name == "pr":
        vals = rng.random(n, dtype=np.float32)
    else:
        vals = (rng.random(n, dtype=np.float32) * 100).astype(np.float32)
        vals[rng.random(n) < 0.3] = np.inf
    changed = (np.ones(n, bool) if name == "pr"
               else rng.random(n) < 0.5)
    return vals, changed


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sweep_matches_reference(name, graph):
    ref = GRAPHS[graph]()
    n = ref.num_nodes
    csc = ref.transposed()
    cfg = dict(CONFIGS[name])
    weighted = name == "sssp_w"
    plan = pv.build_value_plan(
        csc.row_offsets, csc.col_indices, n,
        weights=csc.edge_values if weighted else None)
    ref_st = pv.ValueStepper(plan, interpret=True, **_ref_config(cfg))
    rows = word_rows(n)
    assert plan.rows_w == rows
    offsets = torch.from_numpy(csc.row_offsets.astype(np.int32))
    in_src = torch.from_numpy(csc.col_indices.astype(np.int32))
    if weighted:
        cfg["weights"] = torch.from_numpy(
            csc.edge_values.astype(np.float32))
    st = value.ValueStepper(offsets, in_src, **cfg)
    rng = np.random.default_rng(sum(map(ord, name + graph)))
    vals, changed = _inputs(name, n, plan.n_words, rng)
    acc = jnp.asarray(pv.to_bitmajor_np(vals, rows))
    ch_ref = jnp.asarray(words_from_mask(changed, plan.n_words)
                         if name != "pr"
                         else np.full((rows, 128), -1, np.int32))
    np.testing.assert_array_equal(
        words_from_mask(changed, plan.n_words),
        pv.words_from_mask(changed, plan.n_words))
    x = np.zeros(st.n_pad, np.int32)
    x[:n] = vals.view(np.int32)
    x = torch.from_numpy(x)
    ch = torch.from_numpy(np.array(ch_ref))
    dtype = np.float32 if cfg["f32"] else np.int32
    for sweep in range(1 if name == "pr" else 2):
        acc, ch_ref = ref_st(acc, ch_ref)
        want = pv.from_bitmajor_np(np.asarray(acc), n, dtype)
        x, ch, n_changed = st.sweep(x, ch)
        got = x.numpy()[:n].view(dtype)
        if name == "pr":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            continue
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))   # bitwise
        np.testing.assert_array_equal(ch.numpy(), np.asarray(ch_ref))
        mask = mask_from_words(ch.numpy(), n)
        np.testing.assert_array_equal(
            mask, pv.mask_from_words(np.asarray(ch_ref), n))
        assert int(n_changed) == int(mask.sum())
        assert sweep == 1 or mask.any()     # the second sweep has work


def test_add_sweep_sums_every_in_edge():
    """The port's ungated add sweep ignores ch: every in-edge counts,
    and each destination starts from 0."""
    ref = _random(300, 2000, 5)
    csc = ref.transposed()
    st = value.ValueStepper(
        torch.from_numpy(csc.row_offsets.astype(np.int32)),
        torch.from_numpy(csc.col_indices.astype(np.int32)),
        **CONFIGS["pr"])
    rng = np.random.default_rng(6)
    contrib = np.zeros(st.n_pad, np.float32)
    contrib[:300] = rng.random(300, dtype=np.float32)
    out, ch, n_changed = st.sweep(
        torch.from_numpy(contrib.view(np.int32)),
        torch.zeros((st.rows, 128), dtype=torch.int32))
    esrc = csc.col_indices
    edst = np.repeat(np.arange(300), np.diff(csc.row_offsets))
    want = np.zeros(300, np.float64)
    np.add.at(want, edst, contrib[esrc].astype(np.float64))
    np.testing.assert_allclose(out.numpy()[:300].view(np.float32), want,
                               rtol=1e-6, atol=1e-6)
    assert not out.numpy()[300:].any()
    assert not ch.numpy().any() and int(n_changed) == 0
    again, _, _ = st.sweep(torch.from_numpy(contrib.view(np.int32)))
    assert torch.equal(again, out)      # the ungated sweep needs no ch


def test_sweep_wrapper_rejects_bad_inputs():
    offsets = torch.tensor([0, 1, 1], dtype=torch.int32)
    in_src = torch.tensor([1], dtype=torch.int32)
    st = value.ValueStepper(offsets, in_src, mode="min", f32=True)
    vals = lambda: torch.zeros(st.n_pad, dtype=torch.int32)  # noqa: E731
    ch = lambda: torch.zeros((st.rows, 128), dtype=torch.int32)  # noqa
    with pytest.raises(ValueError):     # wrong dtype
        st.sweep(vals().long(), ch())
    with pytest.raises(ValueError):     # wrong shape
        st.sweep(vals()[:-1], ch())
    with pytest.raises(ValueError):     # wrong shape of the changed map
        st.sweep(vals(), ch()[:1])
    with pytest.raises(ValueError):     # another device than the graph's
        st.sweep(vals().to("meta"), ch())
    with pytest.raises(ValueError):     # out aliases vals: not Jacobi
        v = vals()
        st.sweep(v, ch(), out=v)
    with pytest.raises(ValueError):     # a gated sweep needs ch
        st.sweep(vals(), None)
    with pytest.raises(ValueError):     # weights are for f32 combines
        value.ValueStepper(offsets, in_src, mode="min", f32=False,
                           const_w=1.0)
    with pytest.raises(ValueError):     # one weight per in-edge
        value.ValueStepper(offsets, in_src, mode="min", f32=True,
                           weights=torch.ones(2))
    with pytest.raises(ValueError):
        value.ValueStepper(offsets, in_src, mode="max", f32=True)
    with pytest.raises(ValueError):     # no caller sums i32
        value.ValueStepper(offsets, in_src, mode="add", f32=False)
    with pytest.raises(ValueError):     # the lanes walk up to 32 in-edges
        value.ValueStepper(offsets, in_src, mode="min", f32=True,
                           long_degree=16)
    def launched():
        return sum(v for k, v in trace.totals().items()
                   if k.startswith("launch.value_step."))

    before = launched()
    st.sweep(vals(), ch())
    assert launched() == before         # the plain version is no launch


@pytest.mark.parametrize("long_degree", [32, 256])
def test_long_lists_cover_each_long_in_list_once(long_degree):
    """The chunks the card walks for in-lists longer than long_degree:
    each long vertex's chunks tile its in-edges in order, none longer
    than long_degree; the other vertices have none."""
    ref = _random(3000, 20000, 9, hub_edges=2000)
    offsets = torch.from_numpy(ref.transposed().row_offsets.astype(
        np.int32))
    long_v, long_chunk, begin, end = (
        t.numpy() for t in value.long_lists(offsets, long_degree))
    deg = np.diff(offsets.numpy())
    np.testing.assert_array_equal(long_v, np.flatnonzero(deg > long_degree))
    assert 7 in long_v and long_chunk[0] == 0
    assert long_chunk[-1] == begin.size == end.size
    for i, v in enumerate(long_v):
        c0, c1 = long_chunk[i], long_chunk[i + 1]
        assert begin[c0] == offsets[v] and end[c1 - 1] == offsets[v + 1]
        np.testing.assert_array_equal(begin[c0 + 1:c1], end[c0:c1 - 1])
        assert np.all(end[c0:c1] - begin[c0:c1] <= long_degree)
        assert np.all(end[c0:c1] > begin[c0:c1])
