"""The host side of the touched sweep's shared-memory staging
(gunrockinst_tpu_torch.ops.pull: the staged frontier words chosen from a
shared-memory limit, the `stage_cap` and alignment checks), the value
sweep's split of every in-edge between the word walks and the long-list
chunks (ops.value), and the plain versions on the edge-case graphs the
card's kernels are held to (a star, hubs, isolated vertices, n not a
multiple of 32) against the JAX package's sweepers in Pallas interpret
mode.

The CUDA kernels run only on the card; chip_smoke.py holds them against
the same plain versions there (the touched sweep staged whole, capped
and not staged)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.ops import pallas_value as pv
from gunrockinst_tpu.primitives import bfs_pallas as ref_bfs_pallas

from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.ops import pull, value
from gunrockinst_tpu_torch.ops.words import words_from_mask, word_rows
from gunrockinst_tpu_torch.primitives import bfs_pallas

H100_LIMIT = 232448 - 4352      # an opt-in limit less some static memory


@pytest.mark.parametrize("n_words", [128, 1024, 32768, 262144])
@pytest.mark.parametrize("limit", [0, 15, 16, 1000, 65536, H100_LIMIT])
def test_staged_words_from_limit(n_words, limit):
    got = pull.staged_words(n_words, limit)
    assert 0 <= got <= n_words
    assert 4 * got <= limit                   # fits the budget
    assert got == n_words or got % 4 == 0     # whole 16-byte copies
    if got < n_words:                         # and no 16 bytes more fit
        assert 4 * (got + 4) > limit


def test_staged_prefix_at_rmat_s20():
    """rmat-s20 (2^20 vertices) with the H100's budget: the whole
    frontier map fits; at rmat-s21 it no longer does."""
    assert pull.staged_words(2**15, H100_LIMIT) == 2**15
    assert pull.staged_words(2**16, H100_LIMIT) == H100_LIMIT // 16 * 4


def test_staging_rejects_a_negative_limit():
    with pytest.raises(ValueError):
        pull.staged_words(128, -1)


@pytest.mark.parametrize("bad", [-1, 1.5, "65536", True, [1024]])
def test_wrappers_reject_a_bad_stage_cap(bad):
    offsets = torch.tensor([0, 1, 1], dtype=torch.int32)
    in_src = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError):
        pull.PullSweeper(offsets.numpy(), in_src.numpy(),
                         torch.device("cpu"), stage_cap=bad)


@pytest.mark.parametrize("which", ["fw"])
def test_wrappers_reject_a_map_off_a_16_byte_boundary(which):
    """The touched sweep's kernel copies fw to shared memory in 16-byte
    units: a contiguous view that starts 4 bytes in is refused by name
    on every device, and an aligned one is taken."""
    n, offsets, in_src = _star(1003)
    sw = pull.PullSweeper(offsets.numpy(), in_src.numpy(),
                          torch.device("cpu"))
    buf = torch.zeros(sw.n_words + 1, dtype=torch.int32)
    bad, good = buf[1:].view(sw.rows, 128), buf[:-1].view(sw.rows, 128)
    assert bad.is_contiguous() and bad.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match=f"{which} must start on a "
                                         "16-byte boundary"):
        sw(bad)
    with pytest.raises(ValueError, match=f"{which} must start on a "
                                         "16-byte boundary"):
        sw.sweep_fused(bad, good)
    sw(good)


@pytest.mark.parametrize("cap", [None, 0, 65536])
def test_a_good_stage_cap_changes_no_result(cap):
    """On the CPU the cap only rides along: the plain version gives the
    same touched words with any cap."""
    n, offsets, in_src = _star(1003)
    sw = pull.PullSweeper(offsets.numpy(), in_src.numpy(),
                          torch.device("cpu"), stage_cap=cap)
    assert sw.stage_cap == cap and sw.staged is None
    fw = torch.from_numpy(words_from_mask(np.arange(n) == n - 1,
                                          sw.n_words))
    touched = sw(fw)
    assert int(touched.flatten()[(n // 2 + 5) // 32]) != 0


def _star(n):
    """Host CSC of a star whose centre (n // 2 + 5, mid-word) holds every
    in-edge, as chip_smoke.py builds it."""
    centre = n // 2 + 5
    offsets = np.zeros(n + 1, np.int32)
    offsets[centre + 1:] = n - 1
    in_src = np.delete(np.arange(n, dtype=np.int32), centre)
    return n, torch.from_numpy(offsets), torch.from_numpy(in_src)


def _coo(n, src, dst):
    return RefCsr.from_coo(RefCoo(n, np.asarray(src), np.asarray(dst),
                                  None))


def _edge_case(name):
    """Reference CSR graphs for the kernels' edge cases."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "star1003":              # every edge into one vertex
        centre = 1003 // 2 + 5
        leaves = np.delete(np.arange(1003), centre)
        return _coo(1003, leaves, np.full(leaves.size, centre))
    if name == "hubs2000":              # three hubs of 300-700 in-edges
        src = [rng.integers(0, 2000, 6000)]
        dst = [rng.integers(0, 2000, 6000)]
        for hub, deg in ((3, 700), (1000, 300), (1999, 450)):
            src.append(rng.choice(2000, deg, replace=False))
            dst.append(np.full(deg, hub))
        return _coo(2000, np.concatenate(src), np.concatenate(dst))
    if name == "isolated3000":          # 90% of the vertices isolated
        live = rng.choice(3000, 300, replace=False)
        return _coo(3000, rng.choice(live, 2000), rng.choice(live, 2000))
    assert name == "ragged1001"         # n % 32 != 0, edges to vertex n-1
    src = np.concatenate([rng.integers(0, 1001, 8000), np.arange(40)])
    dst = np.concatenate([rng.integers(0, 1001, 8000), np.full(40, 1000)])
    return _coo(1001, src, dst)


EDGE_CASES = ["star1003", "hubs2000", "isolated3000", "ragged1001"]


@pytest.mark.parametrize("long_degree", [32, 64, 128])
@pytest.mark.parametrize("name", EDGE_CASES)
def test_work_split_covers_each_in_edge_once(name, long_degree):
    """The card's work: every destination word is walked by one warp,
    which folds the in-lists of at most long_degree edges; the longer
    lists are cut into chunks (`long_lists`), whose partials the finish
    kernel combines per long vertex.  Together they take every in-edge
    exactly once, and every long vertex exactly once."""
    ref = _edge_case(name)
    n = ref.num_nodes
    offsets = torch.from_numpy(ref.transposed().row_offsets.astype(
        np.int32))
    off = offsets.numpy().astype(np.int64)
    deg = np.diff(off)
    long_v, long_chunk, begin, end = (
        t.numpy() for t in value.long_lists(offsets, long_degree))
    taken = np.zeros(off[-1], np.int64)
    for b, e in zip(begin, end):
        taken[b:e] += 1
    n_words = word_rows(n) * 128
    for word in range(n_words):
        for v in range(32 * word, min(32 * word + 32, n)):
            if deg[v] <= long_degree:
                taken[off[v]:off[v + 1]] += 1
    np.testing.assert_array_equal(taken, np.ones_like(taken))
    owner = np.repeat(np.arange(long_v.size), np.diff(long_chunk))
    np.testing.assert_array_equal(
        np.repeat(long_v, np.diff(long_chunk)), long_v[owner])
    assert set(long_v.tolist()) == set(
        np.flatnonzero(deg > long_degree).tolist())


@pytest.mark.parametrize("chunk", [1, 7, 2048])
@pytest.mark.parametrize("name", EDGE_CASES)
def test_tail_pieces_cover_each_long_list_once(name, chunk):
    """The touched sweep reads the first `head` ids of each in-list and
    hands the rest of a list with no hit on to the tail walk in pieces
    of at most `chunk` ids, as csrc/touch_sweep.cu cuts them (begin
    head + j * chunk past the list's start); `tail_room` counts every
    piece of every list, and the sweep and the pieces together cover
    every in-edge once."""
    ref = _edge_case(name)
    off = ref.transposed().row_offsets.astype(np.int64)
    head = 16
    taken = np.zeros(off[-1], np.int64)
    pieces = 0
    for beg, end in zip(off[:-1], off[1:]):
        lim = beg + head if end - beg > head else end
        taken[beg:lim] += 1
        if lim < end:
            k = (end - lim - 1) // chunk + 1
            for j in range(k):
                b = lim + j * chunk
                e = b + chunk if end - b > chunk else end
                assert 0 < e - b <= chunk
                taken[b:e] += 1
            pieces += k
    np.testing.assert_array_equal(taken, np.ones_like(taken))
    assert pull.tail_room(torch.from_numpy(off.astype(np.int32)), head,
                          chunk) == pieces
    if name == "star1003":
        assert pieces == (1002 - head - 1) // chunk + 1


def _value_pair(ref, cfg, seed):
    n = ref.num_nodes
    csc = ref.transposed()
    plan = pv.build_value_plan(csc.row_offsets, csc.col_indices, n)
    add = cfg["mode"] == "add"
    ref_st = pv.ValueStepper(plan, interpret=True, zero_acc=add,
                             track_changed=not add, **cfg)
    st = value.ValueStepper(
        torch.from_numpy(csc.row_offsets.astype(np.int32)),
        torch.from_numpy(csc.col_indices.astype(np.int32)), **cfg)
    rng = np.random.default_rng(seed)
    if cfg["f32"]:
        vals = (rng.random(n, dtype=np.float32) * 100).astype(np.float32)
    else:
        vals = rng.integers(0, n, n).astype(np.int32)
    changed = np.ones(n, bool) if add else rng.random(n) < 0.5
    return plan, ref_st, st, vals, changed


@pytest.mark.parametrize("cfg", [
    dict(mode="min", f32=True, const_w=1.0),
    dict(mode="min", f32=False),
    dict(mode="add", f32=True, use_active=False)],
    ids=["sssp_c", "cc", "pr"])
@pytest.mark.parametrize("name", ["star1003", "ragged1001"])
def test_value_sweep_on_edge_cases_matches_reference(name, cfg):
    ref = _edge_case(name)
    n = ref.num_nodes
    plan, ref_st, st, vals, changed = _value_pair(ref, cfg, len(name))
    rows = word_rows(n)
    acc = jnp.asarray(pv.to_bitmajor_np(vals, rows))
    ch = words_from_mask(changed, plan.n_words)
    acc, ch_ref = ref_st(acc, jnp.asarray(ch))
    dtype = np.float32 if cfg["f32"] else np.int32
    want = pv.from_bitmajor_np(np.asarray(acc), n, dtype)
    x = np.zeros(st.n_pad, np.int32)
    x[:n] = vals.view(np.int32)
    out, ch_out, n_changed = st.sweep(torch.from_numpy(x),
                                      torch.from_numpy(ch))
    got = out.numpy()[:n].view(dtype)
    if cfg["mode"] == "add":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        np.testing.assert_array_equal(ch_out.numpy(), np.asarray(ch_ref))
        assert int(n_changed) == sum(
            bin(int(w)).count("1")
            for w in np.asarray(ch_ref).view(np.uint32).ravel())


@pytest.mark.parametrize("name", ["star1003", "isolated3000",
                                  "ragged1001"])
def test_touched_sweep_on_edge_cases_matches_reference(name):
    ref = _edge_case(name)
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)
    rsw = ref_bfs_pallas.get_pull_sweeper(ref, interpret=True)
    sw = bfs_pallas.get_pull_sweeper(port, device="cpu")
    rng = np.random.default_rng(len(name))
    n = ref.num_nodes
    far = np.zeros(n, bool)
    far[int(sw.in_src[-1])] = True      # the last in-edge of the last list
    for mask in (np.zeros(n, bool), far, rng.random(n) < 0.3):
        fw = words_from_mask(mask, sw.n_words)
        vw = fw | words_from_mask(rng.random(n) < 0.3, sw.n_words)
        want = np.asarray(rsw(jnp.asarray(fw)))
        got = sw(torch.from_numpy(fw)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            sw.sweep_fused(torch.from_numpy(fw), torch.from_numpy(vw))
            .numpy(), want & ~vw)
