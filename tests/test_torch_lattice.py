"""Port parity: the grid (lattice) generator
(gunrockinst_tpu_torch.graph.lattice) against the JAX package's,
bitwise, and its cache round trip."""

import numpy as np
import pytest

from gunrockinst_tpu.graph import lattice as ref_lattice

from gunrockinst_tpu_torch.graph import lattice


@pytest.mark.parametrize("side,diagonal,with_values,seed", [
    (2, False, False, 0),
    (4, False, False, 0),
    (12, False, False, 0),
    (4, True, False, 0),
    (12, True, False, 0),
    (12, False, True, 0),
    (12, False, True, 7),
    (4, True, True, 3),
])
def test_grid_matches_reference(side, diagonal, with_values, seed):
    kw = dict(diagonal=diagonal, with_values=with_values, seed=seed)
    got, want = lattice.grid_coo(side, **kw), ref_lattice.grid_coo(side,
                                                                  **kw)
    assert got.num_nodes == want.num_nodes == side * side
    for a, b in ((got.rows, want.rows), (got.cols, want.cols)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    if with_values:
        np.testing.assert_array_equal(got.values, want.values)
        assert got.values.dtype == want.values.dtype
    else:
        assert got.values is None and want.values is None
    g, r = lattice.grid_graph(side, **kw), ref_lattice.grid_graph(side,
                                                                 **kw)
    for a, b in ((g.row_offsets, r.row_offsets),
                 (g.col_indices, r.col_indices)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    if with_values:
        np.testing.assert_array_equal(g.edge_values, r.edge_values)
    else:
        assert g.edge_values is None
    # every lattice edge in both directions: 4 s (s-1) straight edges,
    # 4 (s-1)^2 diagonal ones
    assert g.num_edges == 4 * side * (side - 1) + (
        4 * (side - 1) ** 2 if diagonal else 0)
    assert int(g.degrees.min()) >= 2
    assert int(g.degrees.max()) <= (8 if diagonal else 4)


def test_grid_different_seeds_differ():
    a = lattice.grid_coo(12, with_values=True, seed=0).values
    b = lattice.grid_coo(12, with_values=True, seed=7).values
    assert not np.array_equal(a, b)


def test_grid_rejects_side_below_two():
    with pytest.raises(ValueError):
        lattice.grid_coo(1)


@pytest.mark.parametrize("with_values", [False, True])
def test_grid_cache_round_trip(tmp_path, with_values):
    built = lattice.grid_graph(6, with_values=with_values, seed=5,
                               cache_dir=str(tmp_path))
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == [
        f"grid_s6_d0_v{int(with_values)}_seed5.npz"]
    loaded = lattice.grid_graph(6, with_values=with_values, seed=5,
                                cache_dir=str(tmp_path))
    assert loaded is not built
    np.testing.assert_array_equal(loaded.row_offsets, built.row_offsets)
    np.testing.assert_array_equal(loaded.col_indices, built.col_indices)
    if with_values:
        np.testing.assert_array_equal(loaded.edge_values, built.edge_values)
    else:
        assert loaded.edge_values is None
    # the JAX package reads the port's cache file as its own
    ref = ref_lattice.grid_graph(6, with_values=with_values, seed=5,
                                 cache_dir=str(tmp_path))
    np.testing.assert_array_equal(ref.col_indices, built.col_indices)
