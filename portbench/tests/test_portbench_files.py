"""BENCHMARK.json against the contract's shape, and every configuration,
traffic mix and metric it names found by that name under portbench/."""

import json
import re

import pytest

from portbench import harness

ROOT = harness.CHECKOUT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in SPEC["workloads"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads"):
        listed = [e["name"] for e in SPEC[group]]
        assert len(set(listed)) == len(listed)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert _line(e["why"])
    for c in SPEC["configs"]:
        assert _line(c["source"])
    assert all(_line(w) for w in SPEC["command"])


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) == {"card_gteps", "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_entries():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    layers = set()
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= cells
        layers.add(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert layers == {"host set-up", "caller", "entry", "driver", "kernels",
                      "device"}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cells_find_their_files(cell):
    entry = {w["name"]: w for w in SPEC["workloads"]}[cell]
    assert entry["chips"] == 1 and _line(entry["why"])
    found = harness.load_cell(cell, SPEC)
    assert (ROOT / "portbench" / "graphs"
            / f"{found.config['generator']}.py").exists()
    primitive = found.traffic["primitive"]
    for folder in ("queries", "reference", "work"):
        assert (ROOT / "portbench" / folder / f"{primitive}.py").exists()
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one, and the metric each per-layer one moves
    e2e = [m["name"] for m in harness.metrics_for(SPEC, cell, False)]
    layer = harness.metrics_for(SPEC, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m["moves"] in e2e for m in layer)


def test_configs_are_used_and_their_files_hold_them():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
        assert len(c["reduced"]) <= 16


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))


def test_every_file_name_is_made_of_name_characters():
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
