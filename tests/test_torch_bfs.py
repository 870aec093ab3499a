"""Port parity: the BFS main path (gunrockinst_tpu_torch.primitives)
against the JAX package's mega route and the NumPy oracle, bitwise, on
the CPU (device="cpu": the kernels' plain versions)."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from gunrockinst_tpu.graph.rmat import rmat_graph as ref_rmat
from gunrockinst_tpu.oracles import bfs_reference as ref_oracle
from gunrockinst_tpu.primitives import bfs as ref_bfs
from gunrockinst_tpu.primitives import bfs_pallas as ref_bfs_pallas

from gunrockinst_tpu_torch.graph.coo import CooGraph
from gunrockinst_tpu_torch.graph.csr import CsrGraph
from gunrockinst_tpu_torch.oracles import bfs_reference
from gunrockinst_tpu_torch.primitives import bfs, bfs_pallas

INF32 = np.iinfo(np.int32).max
REPO = pathlib.Path(__file__).resolve().parent.parent


def _port_of(ref):
    return CsrGraph.from_arrays(ref.row_offsets, ref.col_indices)


@pytest.mark.parametrize("scale,ef,undirected,relabel,sources", [
    (16, 2, True, "force", (0, 40000)),     # multi-region, relabeled
    (12, 6, False, "force", (0, 999)),      # directed, relabeled
])
def test_run_matches_reference_and_oracle(monkeypatch, scale, ef,
                                          undirected, relabel, sources):
    monkeypatch.setenv("GT_BFS_RELABEL", relabel)
    ref = ref_rmat(scale, ef, undirected=undirected, seed=scale + ef)
    port = _port_of(ref)
    for src in sources:
        got = bfs.run(port, src, mark_preds=True, traversal_mode="auto",
                      device="cpu")
        want = ref_bfs.run(ref, src, mark_preds=True,
                           traversal_mode="mega")
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.preds, want.preds)
        labels, preds = bfs_reference(port, src)
        np.testing.assert_array_equal(got.labels, labels)
        np.testing.assert_array_equal(got.preds, preds)
        assert got.stats.route == "step8"
        assert got.stats.search_depth == want.stats.search_depth
        assert got.stats.nodes_visited == want.stats.nodes_visited
        assert got.stats.edges_visited == want.stats.edges_visited


def test_port_oracle_matches_reference_oracle():
    ref = ref_rmat(12, 4, undirected=False, seed=8)
    port = _port_of(ref)
    for src in (0, 100, 4095):
        for got, want in zip(bfs_reference(port, src),
                             ref_oracle(ref, src)):
            np.testing.assert_array_equal(got, want)


def test_multi_visited_sets_match_reference(monkeypatch):
    monkeypatch.setenv("GT_BFS_RELABEL", "force")
    ref = ref_rmat(16, 2, undirected=True, seed=23)
    port = _port_of(ref)
    srcs = np.array([5, 40000, 65535], np.int32)
    fn = bfs_pallas.get_fused_bfs_multi(port, reps=3, device="cpu")
    deps, vws, wall_ms = fn(srcs)
    rfn = ref_bfs_pallas.get_fused_bfs_multi(ref, reps=3)
    rdeps, rvws, _ = rfn(srcs)
    np.testing.assert_array_equal(fn.perm, rfn.perm)
    np.testing.assert_array_equal(deps, np.asarray(rdeps))
    assert vws.shape == np.asarray(rvws).shape and vws.dtype == np.int32
    np.testing.assert_array_equal(vws, np.asarray(rvws))
    for i, s in enumerate(srcs):
        np.testing.assert_array_equal(fn.visited_of(vws[i]),
                                      rfn.visited_of(rvws[i]))
        labels, _ = bfs_reference(port, int(s))
        np.testing.assert_array_equal(fn.visited_of(vws[i]),
                                      labels != INF32)
    assert wall_ms > 0
    with pytest.raises(ValueError):
        fn(srcs[:2])
    with pytest.raises(ValueError):
        fn(np.array([5, 40000, port.num_nodes], np.int32))


def test_multi_planes_argument_matches_reference():
    """`planes` sets the label planes of each multi-search; the visited
    sets and depths do not depend on it, and equal the JAX package's
    with the same planes."""
    ref = ref_rmat(10, 4, undirected=True, seed=31)
    port = _port_of(ref)
    srcs = np.array([0, 700], np.int32)
    deps4, vws4, _ = bfs_pallas.get_fused_bfs_multi(
        port, reps=2, planes=4, device="cpu")(srcs)
    deps8, vws8, _ = bfs_pallas.get_fused_bfs_multi(
        port, reps=2, device="cpu")(srcs)
    rdeps, rvws, _ = ref_bfs_pallas.get_fused_bfs_multi(
        ref, reps=2, planes=4)(srcs)
    np.testing.assert_array_equal(deps4, np.asarray(rdeps))
    np.testing.assert_array_equal(vws4, np.asarray(rvws))
    np.testing.assert_array_equal(deps4, deps8)
    np.testing.assert_array_equal(vws4, vws8)


def test_two_components_and_isolated_source():
    u = np.array([0, 1, 3], dtype=np.int64)
    v = np.array([1, 2, 4], dtype=np.int64)
    port = CsrGraph.from_coo(CooGraph(6, np.concatenate([u, v]),
                                      np.concatenate([v, u]), None))
    for src in (0, 3, 5):           # vertex 5 has no edges
        got = bfs.run(port, src, traversal_mode="auto", device="cpu")
        labels, preds = bfs_reference(port, src)
        np.testing.assert_array_equal(got.labels, labels)
        np.testing.assert_array_equal(got.preds, preds)


def test_deep_path_takes_chain_route():
    """Depth > 255 overflows the 8 label planes: the search runs again,
    whole, on the chain kernel with bit_length(n+1) planes, later
    searches go there directly, and the depth counts the last, empty
    level, as the reference's searches do."""
    n = 600
    u = np.arange(n - 1, dtype=np.int64)
    port = CsrGraph.from_coo(CooGraph(
        n, np.concatenate([u, u + 1]), np.concatenate([u + 1, u]), None))
    fn = bfs_pallas.get_fused_bfs(port, device="cpu")
    labels, depth, _ = fn(0)
    assert fn.route == "chain"
    np.testing.assert_array_equal(labels, bfs_reference(port, 0)[0])
    assert depth == n
    labels2, preds, depth2, _ = bfs_pallas.bfs_pallas_fused(
        port, n - 1, device="cpu")
    want_labels, want_preds = bfs_reference(port, n - 1)
    np.testing.assert_array_equal(labels2, want_labels)
    np.testing.assert_array_equal(preds, want_preds)
    assert depth2 == n and fn.route == "chain"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = CsrGraph.from_arrays(np.array([0, 1, 1]), np.array([1]))
    with pytest.raises(RuntimeError):
        bfs.run(port, 0)
    with pytest.raises(RuntimeError):
        bfs.run(port, 0, device="cuda")
    with pytest.raises(RuntimeError):
        bfs_pallas.get_fused_bfs(port)
    with pytest.raises(RuntimeError):
        bfs_pallas.get_fused_bfs_multi(port, reps=1)
    with pytest.raises(RuntimeError):
        bfs_pallas.bfs_pallas_fused(port, 0)
    assert bfs.run(port, 0, traversal_mode="auto",
                   device="cpu").labels.tolist() == [0, 1]


def test_unported_modes_raise():
    """The modes that raised before this slice ("dense", "sparse", and
    "auto" with a depth cap) now run and equal the JAX package's;
    an out-of-range source still raises."""
    ref = ref_rmat(9, 4, undirected=False, seed=3)
    port = _port_of(ref)
    for mode, depth in (("dense", None), ("sparse", None), ("auto", 3)):
        got = bfs.run(port, 0, traversal_mode=mode, max_depth=depth,
                      device="cpu")
        want = ref_bfs.run(ref, 0, traversal_mode=mode, max_depth=depth)
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.preds, want.preds)
        assert got.stats.total_queued == want.stats.total_queued
        assert got.stats.route == mode
    with pytest.raises(ValueError):
        bfs.run(port, ref.num_nodes, device="cpu")
    with pytest.raises(ValueError):
        bfs_pallas.get_fused_bfs(port, device="cpu")(-1)


def _port_sources():
    files = sorted((REPO / "gunrockinst_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_sources_never_name_jax_or_the_reference():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|gunrockinst_tpu)\b"
                     r"|\bgunrockinst_tpu\.|__import__\(\s*['\"](jax|"
                     r"gunrockinst_tpu)\b", re.M)
    files = _port_sources()
    assert len(files) > 10
    for path in files:
        hits = [m.group(0) for m in bad.finditer(path.read_text())]
        assert not hits, f"{path.relative_to(REPO)} refers to {hits}"


def test_port_runs_with_jax_and_reference_unimportable():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'gunrockinst_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from gunrockinst_tpu_torch.graph.rmat import rmat_graph\n"
        "from gunrockinst_tpu_torch.primitives import bfs\n"
        "from gunrockinst_tpu_torch.oracles import bfs_reference\n"
        "import chip_smoke\n"
        "g = rmat_graph(10, 4, undirected=True, seed=1)\n"
        "r = bfs.run(g, 0, traversal_mode='auto', device='cpu')\n"
        "assert np.array_equal(r.labels, bfs_reference(g, 0)[0])\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
