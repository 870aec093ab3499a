"""The yardstick kept apart from the program: no module of the benchmark
imports JAX or the JAX package (top-level names compared whole), only
the adaptors import the program, and a run with no card prints no
result."""

import ast
import json
import subprocess
import sys

import pytest

from portbench import harness

PKG = harness.PKG


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("modules,found", [
    (["gunrockinst_tpu_torch", "gunrockinst_tpu_torch.ops"], []),
    (["gunrockinst_tpu.graph"], ["gunrockinst_tpu"]),
    (["jaxlib.xla_client", "jaxtyping", "flaxen"], ["jaxlib"]),
    (["jax", "flax.linen", "numpy"], ["flax", "jax"]),
])
def test_forbidden_names_compare_top_level_whole(modules, found):
    assert harness.forbidden_modules(modules) == found


def test_sources_import_no_jax_and_only_adaptors_import_the_program():
    for path in PKG.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not harness.forbidden_modules(tops), path
        rel = path.relative_to(PKG).parts
        if "gunrockinst_tpu_torch" in tops:
            assert rel[0] in ("queries", "tests") or rel == ("harness.py",), \
                path


def test_reference_and_work_import_nothing_of_the_program():
    for folder in ("reference", "work", "graphs", "metrics"):
        for path in (PKG / folder).glob("*.py"):
            tops = {name.split(".")[0] for name in _imports(path)}
            assert "gunrockinst_tpu_torch" not in tops, path


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(PKG / "run.py"), "--workload", "kron21-bfs",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.CHECKOUT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
    assert "CUDA" in proc.stderr
