"""The port's edge mesh and rank pool (gunrockinst_tpu_torch.parallel.
mesh): the pool's faults end within its deadline and leave no process
behind, so that no test can hang the suite through this tier.

- a job that raises on rank 1 only comes back as RankError with that
  rank's traceback, every rank ended, the pool closed;
- a job whose rank 1 never joins the collectives comes back as RankError
  when the deadline passes, every rank ended;
- a normal close ends every rank;
- edge_mesh() with no process group starts a 1-rank group in this
  process and runs a call there; asked for more ranks it raises;
- a pool with no device asks for the card and, with none, raises
  before it starts a rank;
- the partition builders make no NumPy array over all m edges
  (`memory_peaks`), and the dst-owned builder's chunked stream gives the
  one-chunk shards field for field;
- gunrockinst_tpu_torch.parallel imports and runs in a process where
  `jax` cannot be imported, and imports nothing of gunrockinst_tpu."""

import dataclasses
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gunrockinst_tpu_torch.graph.rmat import rmat_graph
from gunrockinst_tpu_torch.oracles import bfs_reference
from gunrockinst_tpu_torch.parallel import dist_words as dw
from gunrockinst_tpu_torch.parallel.mesh import (MESH, EdgeMesh, RankError,
                                                 RankPool, edge_mesh,
                                                 memory_peaks, mesh_check)

ROOT = Path(__file__).resolve().parent.parent


def _all_ended(procs):
    return all(not p.is_alive() and p.exitcode is not None for p in procs)


@pytest.mark.parametrize("size", [1, 3])
def test_pool_runs_and_closes(size):
    with RankPool(size, device="cpu", deadline_s=60) as pool:
        procs = list(pool._procs)
        got = pool.run(mesh_check, MESH)
    assert got == [(list(range(size)), size * (size - 1) // 2,
                    "gloo, cpu tensors")] * size
    assert pool.closed and _all_ended(procs)


def test_pool_rank_raises():
    pool = RankPool(3, device="cpu", deadline_s=60)
    procs = list(pool._procs)
    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 1 raised") as err:
        pool.run(mesh_check, MESH, fail_rank=1)
    assert "rank 1 was asked to fail" in str(err.value)
    assert time.monotonic() - t0 < 60
    assert pool.closed and _all_ended(procs)
    with pytest.raises(RankError, match="closed"):
        pool.run(mesh_check, MESH)


def test_pool_rank_hangs():
    deadline = 8
    pool = RankPool(2, device="cpu", deadline_s=deadline)
    procs = list(pool._procs)
    t0 = time.monotonic()
    with pytest.raises(RankError, match="did not finish within the "
                                        "deadline of 8 s"):
        pool.run(mesh_check, MESH, skip_rank=1)
    took = time.monotonic() - t0
    assert deadline <= took < deadline + 20
    assert pool.closed and _all_ended(procs)


def test_edge_mesh_in_process():
    assert not dist.is_initialized()
    try:
        mesh = edge_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        assert edge_mesh(1, device="cpu").size == 1
        with pytest.raises(ValueError):
            edge_mesh(2, device="cpu")
        csr = rmat_graph(7, 8, undirected=True, seed=3)
        labels, preds, depth, traffic = dw.bfs_dist_words(
            dw.shard_graph_by_dst(csr, mesh), 0, mesh)
        want_labels, want_preds = bfs_reference(csr, 0)
        n = csr.num_nodes
        np.testing.assert_array_equal(labels.numpy()[:n], want_labels)
        np.testing.assert_array_equal(preds.numpy()[:n], want_preds)
        assert traffic == depth * (mesh.size * 4096 // 32) * 4
        assert mesh_check(mesh) == ([0], 0, "gloo, cpu tensors")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_edge_mesh_needs_ranks_outside_a_group():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="outside a process group"):
        edge_mesh(4, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="nccl"):
        RankPool(2, device="cpu", backend="nccl")


def test_parallel_imports_no_jax():
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # `import jax` raises
        import numpy as np
        import gunrockinst_tpu_torch.parallel as par
        from gunrockinst_tpu_torch.parallel import dist, dist_more
        from gunrockinst_tpu_torch.graph.rmat import rmat_graph
        mesh = par.edge_mesh(device="cpu")
        csr = rmat_graph(6, 4, undirected=True, seed=1)
        g = par.shard_graph_by_dst(csr, mesh)
        labels, _, depth, _ = par.bfs_dist(g, 0, mesh)
        assert int(labels[0]) == 0 and depth > 0
        bad = [m for m in sys.modules
               if m == "jax" and sys.modules[m] is not None
               or m.split(".")[0] == "gunrockinst_tpu"]
        assert not bad, bad
        print("ok")
        """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_cuda_mesh_needs_a_card_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        edge_mesh(device=None)


def test_pool_defaults_to_the_card():
    """RankPool with no device asks for the card, as every entry point
    does: without one it raises before any rank starts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import multiprocessing
    before = set(multiprocessing.active_children())
    for kwargs in ({}, {"backend": "gloo"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RankPool(2, **kwargs)
    assert set(multiprocessing.active_children()) == before


def test_memory_peaks_in_process():
    """memory_peaks runs the call, drops its result and reports the
    host peak of its NumPy buffers (no device peak on the CPU): the
    partition builders make no NumPy array over all m edges."""
    assert not dist.is_initialized()
    try:
        mesh = edge_mesh(device="cpu")
        csr = rmat_graph(10, 16, undirected=True, seed=5)
        big = 4 * csr.num_edges             # one int32 over all edges
        for fn, args in ((dw.shard_graph_by_dst, (csr, mesh)),
                         (dw._src_owned_edges, (csr, 4096, 1, csr.num_nodes,
                                                mesh))):
            got = memory_peaks(mesh, fn, *args)
            assert got["device_peak"] is None and got["device_kept"] is None
            assert 0 < got["host_peak"] < big
            assert got["rss_peak"] > 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("weighted", [False, True])
def test_dst_partition_chunks(monkeypatch, weighted):
    """The dst-owned builder streams the col ids in chunks: small chunks
    give every rank's shard of the one-chunk build, field for field."""
    csr = rmat_graph(9, 8, undirected=False, seed=31)
    if weighted:
        rng = np.random.default_rng(2)
        csr = dataclasses.replace(csr, edge_values=rng.integers(
            1, 64, csr.num_edges).astype(np.float32))
    for p in (1, 3):
        for rank in range(p):
            mesh = EdgeMesh(None, rank, p, torch.device("cpu"), "gloo")
            want = dw.shard_graph_by_dst(csr, mesh)
            with monkeypatch.context() as mp:
                mp.setattr(dw, "EDGE_CHUNK", 1000)
                got = dw.shard_graph_by_dst(csr, mesh)
            assert got.m_loc == want.m_loc
            for k in ("edge_src", "edge_dst_l", "edge_w", "out_degree"):
                assert torch.equal(getattr(got, k), getattr(want, k)), k
