"""Port parity: neighbour sampling (gunrockinst_tpu_torch.ops.sampling)
against the JAX package's `ops/sampling.py`.

The reference draws with `jax.random.uniform`; the port takes the draws
as an input.  Fed the reference's draws (for `sample_khop`, replaying
its `jax.random.split` sequence), the port's neighbours, edge ids and
masks equal the reference's bit for bit, an isolated vertex and the
dummy id included.  With draws from a `torch.Generator`: every valid
sample is an edge of its vertex's CSR segment, the rest point at the
dummy, and one seed gives the same bits twice.

device="cpu" throughout; JAX runs on the CPU."""

import jax
import numpy as np
import pytest
import torch

from gunrockinst_tpu.graph.coo import CooGraph as RefCoo
from gunrockinst_tpu.graph.csr import CsrGraph as RefCsr
from gunrockinst_tpu.graph.csr import DeviceGraph as RefDevice
from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.ops import sampling as ref_sampling

from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph
from gunrockinst_tpu_torch.ops import sampling

CPU = torch.device("cpu")


def _coo_graph(n, rows, cols, undirected=False):
    return RefCsr.from_coo(RefCoo(n, np.asarray(rows, np.int64),
                                  np.asarray(cols, np.int64), None),
                           undirected=undirected)


GRAPHS = {
    "rmat9_undirected": lambda: ref_rmat(9, 8, undirected=True, seed=5),
    "rmat10_directed": lambda: ref_rmat(10, 8, undirected=False, seed=2),
    # a path 0-...-9 beside a star into 10 and the isolated vertex 31
    "path_star": lambda: _coo_graph(
        32, np.r_[np.arange(9), np.arange(11, 31)],
        np.r_[np.arange(1, 10), np.full(20, 10)]),
}


def _pair(name):
    ref = GRAPHS[name]()
    port = CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)
    return RefDevice.build(ref), DeviceGraph.build(port, device=CPU)


def _batch(g, b, seed):
    """b vertex ids: every kind (an isolated vertex, a sink, the dummy
    id) and random ones."""
    deg = g.out_degree[: g.n].numpy()
    ids = list(np.random.default_rng(seed).integers(0, g.n, b - 3))
    ids += [int(np.argmin(deg)), int(np.argmax(deg)), g.n]
    return np.asarray(ids, np.int32)


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sample_neighbors_matches_reference(name, k):
    rg, g = _pair(name)
    ids = _batch(g, 40, 3)
    key = jax.random.PRNGKey(7)
    want = ref_sampling.sample_neighbors(rg, ids, key, k)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (len(ids), k))))
    got = sampling.sample_neighbors(g, torch.from_numpy(ids), k, u=u)
    for a, b in zip(got, want):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the isolated vertex and the dummy are masked
    deg = g.out_degree.numpy()
    np.testing.assert_array_equal(got[2].numpy().any(1),
                                  (deg[ids] > 0) & (ids != g.n))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sample_khop_matches_reference(name):
    rg, g = _pair(name)
    seeds, k, hops = _batch(g, 6, 1), 3, 3
    key = jax.random.PRNGKey(11)
    want = ref_sampling.sample_khop(rg, seeds, key, k, hops)
    draws, width = [], len(seeds)
    for _ in range(hops):            # the reference's split sequence
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.asarray(
            jax.random.uniform(sub, (width, k)))))
        width *= k
    got = sampling.sample_khop(g, torch.from_numpy(seeds), k, hops,
                               u=draws)
    assert len(got) == len(want) == hops
    for layer, ref_layer in zip(got, want):
        for a, b in zip(layer, ref_layer):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sampling_from_a_generator():
    _, g = _pair("rmat9_undirected")
    seeds = torch.from_numpy(_batch(g, 16, 5))
    runs = [sampling.sample_khop(g, seeds, 4, 2,
                                 generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    ro, dst = g.row_offsets.numpy(), g.edge_dst.numpy()
    for (v0, n0, ok0), (v1, n1, ok1) in zip(*runs):
        for a, b in ((v0, v1), (n0, n1), (ok0, ok1)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        v, nb, ok = v0.numpy(), n0.numpy(), ok0.numpy()
        assert (nb[~ok] == g.n).all()
        for i, j in zip(*np.nonzero(ok)):
            assert nb[i, j] in dst[ro[v[i]]:ro[v[i] + 1]]
    _, eids, ok = sampling.sample_neighbors(
        g, seeds, 4, generator=torch.Generator().manual_seed(3))
    e, ok = eids.numpy(), ok.numpy()
    s = seeds.numpy()[:, None].repeat(4, 1)
    assert ((e >= ro[np.minimum(s, g.n)]) & (e < ro[np.minimum(s, g.n) + 1])
            )[ok].all()
    assert (e[~ok] == g.m_pad - 1).all()


def test_sampling_needs_draws_or_a_generator():
    _, g = _pair("path_star")
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="Generator"):
        sampling.sample_neighbors(g, ids, 2)
    with pytest.raises(ValueError, match="shape"):
        sampling.sample_neighbors(g, ids, 2, u=torch.zeros(4, 3))
    with pytest.raises(ValueError, match="one a hop"):
        sampling.sample_khop(g, ids, 2, 2, u=[torch.zeros(4, 2)])
