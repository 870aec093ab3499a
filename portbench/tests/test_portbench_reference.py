"""The reference against the program's `device="cpu"` calls on small
graphs, and the controls against the reference."""

import numpy as np
import pytest

from portbench.graphs import delaunay, kronecker
from portbench.reference import bfs, sssp

KRON = {"scale": 9, "edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19}


def _port_csr(g, weighted):
    from gunrockinst_tpu_torch.graph.csr import CsrGraph
    ro, ci, ev = g.port_arrays(weighted)
    return CsrGraph(row_offsets=ro, col_indices=ci, edge_values=ev)


def _roots(g, k=4):
    live = np.flatnonzero(g.degrees().numpy() > 0)
    return live[np.linspace(0, live.shape[0] - 1, k).astype(int)]


@pytest.mark.parametrize("make,cfg", [(kronecker.make, KRON),
                                      (delaunay.make, {"points": 1500})])
def test_bfs_reference_matches_port(make, cfg):
    from gunrockinst_tpu_torch.primitives import bfs as port_bfs
    g = make(cfg, 5, "cpu")
    csr, on = _port_csr(g, False), g.to("cpu")
    for root in _roots(g):
        res = port_bfs.run(csr, int(root), traversal_mode="auto",
                           mark_preds=True, device="cpu")
        got = {"labels": res.labels, "preds": res.preds}
        assert bfs.compare(got, bfs.solve(on, int(root))) == {
            "label_mismatch": 0, "pred_mismatch": 0}


def test_sssp_reference_matches_port():
    from gunrockinst_tpu_torch.primitives import sssp as port_sssp
    g = kronecker.make(KRON, 6, "cpu")
    csr, on = _port_csr(g, True), g.to("cpu")
    for root in _roots(g):
        res = port_sssp.run(csr, int(root), mode="planes", mark_preds=True,
                            device="cpu")
        got = {"dist": res.dist, "preds": res.preds}
        assert sssp.compare(got, sssp.solve(on, int(root))) == {
            "dist_mismatch": 0, "pred_mismatch": 0}


@pytest.mark.parametrize("ref", [bfs, sssp])
def test_control_breaks_the_comparison(ref):
    g = kronecker.make(KRON, 8, "cpu").to("cpu")
    totals = dict.fromkeys(ref.LIMITS, 0)
    for root in _roots(g):
        got = {k: v.numpy() for k, v in ref.control(g, int(root)).items()}
        for k, v in ref.compare(got, ref.solve(g, int(root))).items():
            totals[k] += v
    assert any(v > ref.LIMITS[k] for k, v in totals.items()), totals


def test_compare_counts_missing_answers():
    g = kronecker.make(KRON, 9, "cpu").to("cpu")
    exp = bfs.solve(g, 0)
    assert bfs.compare({"labels": None}, exp) == {
        "label_mismatch": g.n, "pred_mismatch": g.n}
