"""Port parity: the CLI (`python -m gunrockinst_tpu_torch.cli`) against
the JAX package's (tests/test_cli.py's twin, on generated graphs).

For the same arguments the port's result lines equal the JAX CLI's: the
graph line, notices, `Node_ID` entries, `number of components`, `MIS
size`, `MST: ... edges, total weight ...`, the TopK lines, the
`CORRECTNESS` line and the metric block's counts.  Timing fields are
left out (the metric block's elapsed, rate and avg_duty; the trace
lines' ms).  The rank primitives' values (PR, HITS, SALSA, WTF, BC)
agree to rtol 1e-4, as their tests hold them.  Kernel routes (SSSP's
default, planes, pallas, mega) run their plain versions here and the
reference in Pallas interpret mode.

A getter that refuses its input (ValueError/TypeError) falls back with
the JAX CLI's notice; any other error propagates.

device="cpu" (the `--device=cpu` flag); JAX runs on the CPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from gunrockinst_tpu import cli as ref_cli

from gunrockinst_tpu_torch import cli
from gunrockinst_tpu_torch.primitives import cc as cc_mod

REPO = pathlib.Path(__file__).resolve().parent.parent
RMAT = ["rmat", "--rmat-scale=8", "--rmat-edgefactor=8", "--undirected",
        "--rmat-seed=3"]
TIMING = re.compile(r"elapsed: [-\d.e+]+ ms, rate: [\d.e+]+ MiEdges/s, |"
                    r", avg_duty: [\d.]+%|'elapsed_ms': [\d.e+-]+, "
                    r"'device_ms': [\d.e+-]+, 'avg_duty': [\d.e+-]+|"
                    r" [\d.]+ dev [\d.]+ duty [\d.]+%$")
NODE = re.compile(r"^    Node_ID (\d+): (\S+)$")


def _run(main, argv, capsys):
    rc = main(list(argv))
    return rc, capsys.readouterr().out.splitlines()


def _pair(argv, capsys):
    rc, got = _run(cli.main, argv + ["--device=cpu"], capsys)
    ref_rc, want = _run(ref_cli.main, argv, capsys)
    return (rc, [TIMING.sub("", line) for line in got]), \
        (ref_rc, [TIMING.sub("", line) for line in want])


def _market(tmp_path, weighted):
    rng = np.random.default_rng(5)
    n, m = 90, 400
    rows, cols = rng.integers(1, n + 1, m), rng.integers(1, n + 1, m)
    head = ("%%MatrixMarket matrix coordinate "
            f"{'real' if weighted else 'pattern'} general\n{n} {n} {m}\n")
    lines = [f"{r} {c}" + (f" {rng.integers(1, 9)}" if weighted else "")
             for r, c in zip(rows, cols)]
    path = tmp_path / ("w.mtx" if weighted else "p.mtx")
    path.write_text(head + "\n".join(lines) + "\n")
    return ["market", str(path)]


EXACT = [
    ["bfs", "--src=largestdegree", "--mark-pred"],
    ["bfs", "--traversal-mode=sparse"],
    ["bfs", "--traversal-mode=mega", "--src=3"],
    ["dobfs", "--src=2"],
    ["dobfs", "--alpha=6.5", "--beta=2.5", "--mark-pred"],
    ["sssp", "--src=1"],                       # the value kernel
    ["sssp", "--traversal-mode=sparse", "--iteration-num=2"],
    ["cc"],
    ["cc", "--traversal-mode=planes"],
    ["topk", "--top-nodes=7"],
    ["mis"],
    ["mst"],
]


# on a weighted directed .mtx (MIS validates an undirected graph)
MARKET = [["bfs", "--src=2", "--mark-pred"], ["dobfs", "--src=2"],
          ["sssp", "--src=2"], ["cc"], ["topk"], ["mis", "--undirected"],
          ["mst"]]
CASES = ([("rmat", a) for a in EXACT] + [("market", a) for a in MARKET])


@pytest.mark.parametrize("graph,args", CASES,
                         ids=[f"{g}: {' '.join(a)}" for g, a in CASES])
def test_result_lines_match_reference(args, graph, tmp_path, capsys):
    g = RMAT if graph == "rmat" else _market(tmp_path, weighted=True)
    argv = [args[0]] + g + args[1:]
    (rc, got), (ref_rc, want) = _pair(argv, capsys)
    assert rc == ref_rc == 0
    assert got == want
    assert f"{args[0]} CORRECTNESS: PASSED" in got


RANKED = [
    ["pr"],
    ["pr", "--traversal-mode=pallas", "--max-iter=20"],
    ["pr", "--traversal-mode=planes", "--top-nodes=5"],
    ["bc", "--src=4"],
    ["bc", "--traversal-mode=planes", "--src=4"],
    ["hits", "--max-iter=10"],
    ["salsa", "--max-iter=10"],
    ["wtf", "--src=2", "--max-iter=10"],
]


@pytest.mark.parametrize("args", RANKED, ids=lambda a: " ".join(a))
def test_rank_lines_match_reference(args, capsys):
    argv = [args[0]] + RMAT + args[1:]
    (rc, got), (ref_rc, want) = _pair(argv, capsys)
    assert rc == ref_rc == 0
    assert len(got) == len(want)
    for a, b in zip(got, want):
        ma, mb = NODE.match(a), NODE.match(b)
        if ma and mb:
            assert np.isclose(float(ma.group(2)), float(mb.group(2)),
                              rtol=1e-4, atol=1e-6), (a, b)
            if args[0] == "bc":        # ids in vertex order
                assert ma.group(1) == mb.group(1)
        else:
            assert a == b
    assert f"{args[0]} CORRECTNESS: PASSED" in got


@pytest.mark.parametrize("prim", ["bfs", "sssp", "cc"])
def test_instrumented_lines_match_reference(prim, capsys):
    argv = [prim] + RMAT + ["--instrumented", "--src=5"]
    (rc, got), (ref_rc, want) = _pair(argv, capsys)
    assert rc == ref_rc == 0
    assert got == want
    assert any(line.startswith("l ") for line in got)
    assert f"{prim} CORRECTNESS: PASSED" in got


def test_usage_and_errors(tmp_path, capsys):
    for argv in ([], ["-h"]):
        assert cli.main(argv) == 0
        assert "gunrockinst_tpu_torch.cli" in capsys.readouterr().out
    assert cli.main(["frobnicate", "rmat"]) == 2
    assert "unknown primitive" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["bfs", "market", "--device=cpu"])
    with pytest.raises(FileNotFoundError):
        cli.main(["bfs", "market", str(tmp_path / "missing.mtx"),
                  "--device=cpu"])


def test_refused_getter_falls_back_and_other_errors_propagate(
        monkeypatch, capsys):
    def refuse(csr, device=None):
        raise ValueError("too large")
    monkeypatch.setattr(cc_mod, "get_cc_planes", refuse)
    argv = ["cc"] + RMAT + ["--traversal-mode=planes", "--device=cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert ("cc planes mode unavailable (too large); falling back to xla"
            in out)
    assert "cc CORRECTNESS: PASSED" in out

    def broken(csr, device=None):
        raise RuntimeError("kernel build failed")
    monkeypatch.setattr(cc_mod, "get_cc_planes", broken)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        cli.main(argv)


def test_cli_needs_a_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device=0 runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["topk"] + RMAT)


def test_cli_and_new_modules_run_without_jax():
    code = (
        "import sys, runpy\n"
        "for name in ('jax', 'jaxlib', 'gunrockinst_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "from gunrockinst_tpu_torch import api\n"
        "from gunrockinst_tpu_torch.graph.rmat import rmat_graph\n"
        "from gunrockinst_tpu_torch.ops import sampling\n"
        "from gunrockinst_tpu_torch.primitives import (dobfs, mis, mst,"
        " topk)\n"
        "from gunrockinst_tpu_torch.utils import config, instrument\n"
        "from gunrockinst_tpu_torch import oracles as o\n"
        "g = rmat_graph(8, 4, undirected=True, seed=1)\n"
        "r = dobfs.run(g, 0, device='cpu')\n"
        "assert np.array_equal(r.labels, o.bfs_reference(g, 0)[0])\n"
        "assert o.verify_mis(g, mis.run(g, device='cpu').in_set)\n"
        "assert np.isclose(mst.run(g, device='cpu').total_weight,"
        " o.mst_reference_weight(g))\n"
        "t = topk.run(g, 5, device='cpu')\n"
        "assert np.array_equal(t.node_ids, o.topk_degree_reference(g, 5)"
        "[0])\n"
        "dg = g.to_device(device='cpu')\n"
        "sampling.sample_khop(dg, torch.arange(4), 3, 2,"
        " generator=torch.Generator().manual_seed(0))\n"
        "s = instrument.SteppedBfs(dg, 0, slice_depth=2, device='cpu')\n"
        "assert np.array_equal(s.run_to_completion(),"
        " o.bfs_reference(g, 0)[0])\n"
        "api.topk(g.row_offsets, g.col_indices, 3, device='cpu')\n"
        "sys.argv = ['cli', 'mst', 'rmat', '--rmat-scale=7',"
        " '--device=cpu']\n"
        "try:\n"
        "    runpy.run_module('gunrockinst_tpu_torch.cli',"
        " run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
    assert "mst CORRECTNESS: PASSED" in out.stdout
