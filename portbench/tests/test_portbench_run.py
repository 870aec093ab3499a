"""Whole runs on the CPU at small sizes: the result line's shape, and
`correct` coming out false with the timed path broken underneath (a step
that returns its state unchanged; an answer altered where the program
produces it) or with the control in the program's place.  A cell's
other faults of the contract's list (half of a batch left out, the
exchange between chips left out) have no counterpart here: a query is
one root on one card."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench import run as run_cmd

SPEC = harness.bench_spec()
SMALL = {"g500-kron-s21": {"scale": 9}, "dimacs10-delaunay-n21":
         {"points": 1500}}
SEED = 2**31 + 12345


def _cell(name):
    cell = harness.load_cell(name, SPEC)
    return dataclasses.replace(
        cell, config={**cell.config, **SMALL[cell.config["name"]]})


def _run(name, trace=False, seconds=0.3):
    rec = harness.run_cell(_cell(name), SEED, seconds, "cpu",
                           log=lambda s: None)
    return rec, run_cmd.result_line(rec, SPEC, trace, 1)


@pytest.mark.parametrize("name", ["kron21-bfs", "delaunay21-bfs",
                                  "kron21-sssp"])
def test_sound_run_line(name):
    rec, line = _run(name)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == len(rec.queries) > 0
    assert len(rec.checked) == min(16, len(rec.queries))
    units = {m["name"]: m["unit"] for m in SPEC["end_to_end"]}
    # no device here: the card's rate finds no busy time and says nothing
    assert set(line["metrics"]) == set(units) - {"card_gteps"}
    for k, v in line["metrics"].items():
        assert v["unit"] == units[k] and v["value"] > 0
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert {"value", "limit"} <= set(line["checks"]["pred_mismatch"])
    json.dumps(line)
    # the window takes fresh roots, none of the warm-up's
    roots = [q.root for q in rec.queries]
    assert len(set(roots)) == len(roots)


def test_traced_run_line():
    rec, line = _run("kron21-bfs", trace=True)
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert line["correct"] is True
    assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
    assert len(rec.trace.query_device_s) == len(rec.queries)
    per_layer = {m["name"] for m in harness.metrics_for(SPEC, "kron21-bfs",
                                                        True)}
    # no device here: the trace's readers find nothing and say nothing
    assert set(line["metrics"]) == per_layer - {"bfs_roofline",
                                                "device.idle_pct"}
    for key in ("device_ops", "idle_gaps"):
        assert len(line["breakdown"][key]) <= 10


def test_card_rate_is_edges_over_busy_time():
    """`card_gteps` reads the window's edges over the card's busy
    seconds from the trace, and nothing where the card never ran."""
    rec, _ = _run("kron21-bfs")
    read = harness.reader("card_gteps")
    assert rec.trace.busy_s == 0 and read(rec) is None
    busy = dataclasses.replace(rec.trace, busy_s=0.25)
    edges = sum(q.edges for q in rec.served)
    assert edges > 0
    assert read(dataclasses.replace(rec, trace=busy)) == pytest.approx(
        edges / 0.25 / 1e9)


def test_same_seed_same_work():
    a, _ = _run("kron21-bfs", seconds=0.2)
    b, _ = _run("kron21-bfs", seconds=0.2)
    k = min(len(a.queries), len(b.queries))
    assert [q.root for q in a.queries[:k]] == [q.root for q in b.queries[:k]]
    assert [q.edges for q in a.queries[:k]] == [q.edges
                                               for q in b.queries[:k]]


def _state_unchanged_bfs(monkeypatch):
    from gunrockinst_tpu_torch.ops import mega
    monkeypatch.setattr(mega.MegaStepper, "step",
                        lambda self, fw, *a, **k: (
                            fw, torch.zeros(1, dtype=torch.int32)))


def _state_unchanged_sssp(monkeypatch):
    from gunrockinst_tpu_torch.ops import value

    def sweep(self, vals, ch, out, route):
        return vals.clone(), ch, torch.zeros(2, dtype=torch.int32)

    monkeypatch.setattr(value.ValueStepper, "_cpu_sweep", sweep)


def _altered_bfs(monkeypatch):
    from gunrockinst_tpu_torch.primitives import bfs_pallas
    real = bfs_pallas._labels

    def labels(*args):
        out = real(*args)
        far = int(np.argmax(np.where(out == np.iinfo(np.int32).max, -1,
                                     out)))
        out[far] += 1
        return out

    monkeypatch.setattr(bfs_pallas, "_labels", labels)


def _altered_sssp(monkeypatch):
    from gunrockinst_tpu_torch.primitives import sssp
    real = sssp._SsspPlanes.__call__

    def call(self, src):
        dist, it, ms = real(self, src)
        far = int(np.argmax(np.where(np.isfinite(dist), dist, -1)))
        dist[far] = np.nextafter(dist[far], np.float32(np.inf))
        return dist, it, ms

    monkeypatch.setattr(sssp._SsspPlanes, "__call__", call)


@pytest.mark.parametrize("name,fault", [
    ("kron21-bfs", _state_unchanged_bfs),
    ("kron21-bfs", _altered_bfs),
    ("delaunay21-bfs", _altered_bfs),
    ("kron21-sssp", _state_unchanged_sssp),
    ("kron21-sssp", _altered_sssp),
])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    rec, line = _run(name)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("name", ["kron21-bfs", "delaunay21-bfs",
                                  "kron21-sssp"])
def test_control_is_not_correct(name):
    out = control.readings(_cell(name), SEED, 3, "cpu")
    assert any(v["value"] > v["limit"] for v in out.values()), out


@pytest.mark.card
@pytest.mark.parametrize("name", ["kron21-bfs", "delaunay21-bfs",
                                  "kron21-sssp"])
def test_control_is_not_correct_at_cell_size(card, name):
    cell = harness.load_cell(name, SPEC)
    for seed in (11, 2**31 + 7, 2**32 + 3):
        out = control.readings(cell, seed,
                               int(cell.traffic["checked_queries"]), card)
        assert any(v["value"] > v["limit"] for v in out.values()), out


@pytest.mark.card
@pytest.mark.parametrize("name", ["kron21-bfs", "delaunay21-bfs",
                                  "kron21-sssp"])
def test_short_run_on_the_card_is_correct(card, name):
    rec = harness.run_cell(harness.load_cell(name, SPEC), 2**31 + 99, 2.0,
                           card, log=lambda s: None)
    assert rec.correct and rec.queries
    assert 0 < rec.trace.busy_s < rec.trace.window_s
    assert harness.reader("card_gteps")(rec) > 0


@pytest.mark.parametrize("loads_jax", [False, True])
def test_reader_that_loads_jax_leaves_no_result(monkeypatch, capsys,
                                                loads_jax):
    """The last look at `sys.modules` comes after the metric readers
    are loaded: a reader that pulls in JAX (here a stub module) ends the
    run with no result line; the same run with a clean reader prints
    one."""
    import sys
    import types

    rec, _ = _run("kron21-bfs")

    def read(_rec):
        if loads_jax:
            sys.modules["jax"] = types.ModuleType("jax")
        return 1.0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: rec)
    monkeypatch.setattr(harness, "reader", lambda name: read)
    monkeypatch.setattr(sys, "path", list(sys.path))
    had_jax = "jax" in sys.modules
    assert not had_jax
    try:
        rc = run_cmd.main(["--workload", "kron21-bfs", "--seed", "1",
                           "--seconds", "1", "--trace", "0"])
    finally:
        sys.modules.pop("jax", None)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    if loads_jax:
        assert rc != 0 and "jax" in err
        for line in lines:
            with pytest.raises(ValueError):
                json.loads(line)
    else:
        assert rc == 0 and json.loads(lines[-1])["correct"] is True
