""".mtx loading in the port (gunrockinst_tpu_torch.graph.market and
_native_io) against the JAX package's loader, on files written to
tmp_path: symmetric and general, pattern and real, with self-loops and
duplicate edges; the .csr.npz cache and its mtime check; missing and
malformed files; the native parser against the NumPy one."""

import os

import numpy as np
import pytest

from gunrockinst_tpu.graph.market import load_market as ref_load_market

from gunrockinst_tpu_torch import load_market
from gunrockinst_tpu_torch.graph import _native_io, market

FILES = {
    "general_pattern": (
        "%%MatrixMarket matrix coordinate pattern general\n"
        "% a comment\n"
        "5 5 7\n1 2\n2 3\n3 3\n2 3\n4 1\n5 4\n1 5\n"),
    "general_real": (
        "%%MatrixMarket matrix coordinate real general\n"
        "6 6 6\n1 2 0.5\n2 3 1.25\n3 1 2\n6 6 9\n4 5 3.5\n4 5 7\n"),
    "symmetric_pattern": (
        "%%MatrixMarket matrix coordinate pattern symmetric\n"
        "4 4 4\n2 1\n3 2\n4 4\n4 1\n"),
    "symmetric_real": (
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "%\n5 5 5\n2 1 1.5\n3 1 2.5\n3 2 4\n5 4 8\n5 5 1\n"),
    "no_banner": "3 3 3\n1 2 4.0\n2 3 5.0\n3 1 6.0\n",
}


def _write(tmp_path, name, text=None):
    path = tmp_path / f"{name}.mtx"
    path.write_text(FILES[name] if text is None else text)
    return str(path)


def _assert_same_csr(got, want):
    np.testing.assert_array_equal(got.row_offsets, want.row_offsets)
    np.testing.assert_array_equal(got.col_indices, want.col_indices)
    if want.edge_values is None:
        assert got.edge_values is None
    else:
        np.testing.assert_array_equal(got.edge_values, want.edge_values)
        assert got.edge_values.dtype == np.float32


@pytest.mark.parametrize("undirected", [False, True])
@pytest.mark.parametrize("name", sorted(FILES))
def test_load_market_matches_reference(tmp_path, name, undirected):
    path = _write(tmp_path, name)
    got = load_market(path, undirected=undirected, use_cache=False)
    want = ref_load_market(path, undirected=undirected, use_cache=False)
    _assert_same_csr(got, want)
    # self-loops dropped, duplicates kept once
    src = np.repeat(np.arange(got.num_nodes), got.degrees)
    assert not np.any(src == got.col_indices)
    pairs = src.astype(np.int64) * got.num_nodes + got.col_indices
    assert np.unique(pairs).size == pairs.size


@pytest.mark.parametrize("name", sorted(FILES))
def test_native_parser_equals_numpy_parser(tmp_path, name):
    path = _write(tmp_path, name)
    native = _native_io.parse_mtx(path)
    plain = market._parse_mtx_numpy(path)
    assert native[0] == plain[0] and native[4] == plain[4]
    for a, b in zip(native[1:4], plain[1:4]):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    assert market.parse_market(path)[1] == "native"
    assert _native_io.library_path().parent.name == "_build"


def test_cache_is_written_and_reread_after_a_change(tmp_path):
    path = _write(tmp_path, "general_real")
    first = load_market(path)
    cache = tmp_path / "general_real.mtx.csr.npz"
    assert cache.exists()
    again = load_market(path)
    _assert_same_csr(again, first)
    ud = load_market(path, undirected=True)
    assert (tmp_path / "general_real.mtx.ud.csr.npz").exists()
    assert ud.num_edges > first.num_edges
    # rewrite the file: a newer mtime than the cache's makes it re-parse
    _write(tmp_path, "general_real",
           "%%MatrixMarket matrix coordinate real general\n"
           "6 6 2\n1 2 3.0\n2 1 4.0\n")
    stamp = os.path.getmtime(cache) + 10
    os.utime(path, (stamp, stamp))
    changed = load_market(path)
    assert changed.num_edges == 2
    np.testing.assert_array_equal(changed.edge_values, [4.0, 3.0])
    _assert_same_csr(changed, ref_load_market(path, use_cache=False))


def test_missing_and_malformed_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_market(str(tmp_path / "missing.mtx"), use_cache=False)
    with pytest.raises(FileNotFoundError):
        _native_io.parse_mtx(str(tmp_path / "missing.mtx"))
    bad = _write(tmp_path, "general_real",
                 "%%MatrixMarket matrix coordinate real general\n"
                 "3 3 2\n1 2 1.0\nx y\n")
    with pytest.raises(ValueError):
        load_market(bad, use_cache=False)
    with pytest.raises(ValueError):
        _native_io.parse_mtx(bad)
    with pytest.raises(ValueError):
        market._parse_mtx_numpy(bad)
