"""The generators: determinism by seed, Graph500's tuple count and
vertex permutation, weights the same both ways, the Delaunay mesh's
edge count, and the components the edge counts rest on."""

import numpy as np
import pytest
import torch

from portbench.graphs import _csr, delaunay, kronecker
from portbench.reference.components import components

KRON = {"scale": 9, "edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19}


def _edges(g):
    src = np.repeat(np.arange(g.n), np.diff(g.offsets.numpy()))
    return src, g.cols.numpy().astype(np.int64)


def _assert_simple_symmetric(g):
    src, dst = _edges(g)
    assert not np.any(src == dst)
    key = src * g.n + dst
    assert np.all(np.diff(key) > 0)            # rows sorted, no duplicate
    rev = np.sort(dst * g.n + src)
    assert np.array_equal(rev, key)            # every edge both ways
    if g.weights is not None:
        w = g.weights.numpy()
        order = np.argsort(dst * g.n + src)
        assert np.array_equal(w[order], w)     # the same weight both ways


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 1])
def test_kronecker_deterministic_by_seed(seed):
    a = kronecker.make(KRON, seed, "cpu")
    b = kronecker.make(KRON, seed, "cpu")
    c = kronecker.make(KRON, seed + 1, "cpu")
    assert torch.equal(a.offsets, b.offsets)
    assert torch.equal(a.cols, b.cols)
    assert torch.equal(a.weights, b.weights)
    assert not (a.m == c.m and torch.equal(a.cols, c.cols))


def test_kronecker_tuples_permutation_and_weights(monkeypatch):
    seen = {}
    real = kronecker.undirected_csr

    def spy(n, u, v, w):
        seen.update(n=n, m=u.shape[0], w=w.shape[0],
                    top=int(max(int(u.max()), int(v.max()))))
        return real(n, u, v, w)

    monkeypatch.setattr(kronecker, "undirected_csr", spy)
    g = kronecker.make(KRON, 7, "cpu")
    assert seen["n"] == 2 ** 9 and seen["m"] == 16 * 2 ** 9
    assert seen["w"] == seen["m"] and seen["top"] < seen["n"]
    _assert_simple_symmetric(g)
    w = g.weights.numpy()
    assert w.dtype == np.float32 and w.min() >= 0 and w.max() < 1

    # the same draws without the permutation: the same degrees, other ids;
    # unpermuted, vertex 0 (every bit in quadrant A) is the hub
    monkeypatch.setattr(kronecker.torch, "randperm",
                        lambda n, **kw: torch.arange(n))
    plain = kronecker.make(KRON, 7, "cpu")
    deg, plain_deg = g.degrees().numpy(), plain.degrees().numpy()
    assert np.array_equal(np.sort(deg), np.sort(plain_deg))
    assert int(np.argmax(plain_deg)) == 0
    assert not np.array_equal(deg, plain_deg)


def test_duplicates_keep_least_weight_self_loops_dropped():
    u = torch.tensor([0, 1, 0, 2, 3, 2])
    v = torch.tensor([1, 0, 1, 2, 2, 3])
    w = torch.tensor([0.5, 0.25, 0.75, 0.1, 0.9, 0.3])
    g = _csr.undirected_csr(4, u, v, w)
    assert g.offsets.tolist() == [0, 1, 2, 3, 4]
    assert g.cols.tolist() == [1, 0, 3, 2]
    assert g.weights.tolist() == [0.25, 0.25, 0.30000001192092896,
                                  0.30000001192092896]


@pytest.mark.parametrize("seed", [3, 2**33])
def test_delaunay_deterministic_and_planar(seed):
    cfg = {"points": 3000}
    a = delaunay.make(cfg, seed, "cpu")
    b = delaunay.make(cfg, seed, "cpu")
    assert torch.equal(a.cols, b.cols) and a.weights is None
    _assert_simple_symmetric(a)
    # Euler: a triangulation of n points, h of them on the hull, has
    # 3n - 3 - h edges
    from scipy.spatial import ConvexHull
    pts = np.random.default_rng(seed).random((3000, 2))
    h = len(ConvexHull(pts).vertices)
    assert a.m // 2 == 3 * 3000 - 3 - h


def test_components_match_scipy():
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    g = kronecker.make({**KRON, "scale": 10, "edgefactor": 2}, 11, "cpu")
    comp = components(g.to("cpu")).numpy()
    a = csr_matrix((np.ones(g.m), g.cols.numpy(), g.offsets.numpy()),
                   shape=(g.n, g.n))
    k, lab = connected_components(a, directed=False)
    assert len(np.unique(comp)) == k > 1
    # the same partition, each named by its least vertex
    for c in np.unique(lab):
        members = np.flatnonzero(lab == c)
        assert np.all(comp[members] == members.min())
