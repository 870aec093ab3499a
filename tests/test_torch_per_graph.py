"""What the port keeps per host graph: the shared search graph
(`primitives/search_graph.py`) is built once per graph and device through
the one per-graph cache (`graph/csr.py::derived`), everything derived
from a graph goes with it once the caller drops it, and the layers keep
their import order (the kernel wrappers and the graph containers know
nothing of the primitives; only `bfs.py` reaches the BFS module).  On
the CPU, and on a card (`-m card`) that a dropped graph's card memory is
freed."""

import ast
import gc
import pickle
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

import gunrockinst_tpu_torch
from gunrockinst_tpu_torch.graph.csr import CsrGraph, derived
from gunrockinst_tpu_torch.graph.relabel import is_symmetric, relabeled
from gunrockinst_tpu_torch.graph.rmat import rmat_graph
from gunrockinst_tpu_torch.oracles import bfs_reference, sssp_reference
from gunrockinst_tpu_torch.primitives import bfs, sssp
from gunrockinst_tpu_torch.primitives.search_graph import search_graph
from gunrockinst_tpu_torch.utils import trace

PKG = Path(gunrockinst_tpu_torch.__file__).parent
CPU = torch.device("cpu")


def _imports(path):
    """Every module `path` imports, as dotted names (`from a import b`
    gives both `a` and `a.b`)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
            out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


def _modules(*parts):
    return sorted(PKG.joinpath(*parts).rglob("*.py"))


@pytest.mark.parametrize("layer", ["ops", "graph"])
def test_lower_layers_import_no_primitive(layer):
    bad = [str(p.relative_to(PKG)) for p in _modules(layer)
           if any(name.startswith("gunrockinst_tpu_torch.primitives")
                  for name in _imports(p))]
    assert bad == []


def test_only_the_bfs_entry_imports_the_bfs_module():
    users = [str(p.relative_to(PKG)) for p in _modules()
             if "gunrockinst_tpu_torch.primitives.bfs_pallas"
             in _imports(p)]
    assert users == ["primitives/bfs.py"]


def _graph():
    """A graph `relabeled` leaves in its own numbering (too small to
    renumber), so that its relabeling is the graph itself."""
    return rmat_graph(9, 8, undirected=True, seed=5, with_values=True)


def _bfs(csr, src):
    res = bfs.run(csr, src, traversal_mode="auto", device="cpu")
    return res.labels, res.preds, bfs_reference


def _sssp(csr, src):
    res = sssp.run(csr, src, mode="planes", device="cpu")
    return res.dist, res.preds, sssp_reference


RUNS = {"bfs auto": _bfs, "sssp planes": _sssp}


def _src(csr):
    return int(np.argmax(csr.degrees))


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_a_dropped_graph_goes_with_what_it_derived(kind):
    csr = _graph()
    assert relabeled(csr) == (csr, None)
    values, preds, oracle = RUNS[kind](csr, _src(csr))
    want = oracle(csr, _src(csr))
    np.testing.assert_array_equal(values, want[0])
    np.testing.assert_array_equal(preds, want[1])
    g = weakref.ref(search_graph(csr, CPU))
    alive = weakref.ref(csr)
    del csr
    gc.collect()
    assert alive() is None
    assert g() is None


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_second_call_builds_nothing(kind):
    trace.set_enabled(True)
    trace.clear()
    csr = _graph()
    first = RUNS[kind](csr, _src(csr))
    g = search_graph(csr, CPU)
    trace.clear()
    second = RUNS[kind](csr, _src(csr))
    assert search_graph(csr, CPU) is g
    for a, b in zip(first[:2], second[:2]):
        np.testing.assert_array_equal(a, b)
    (call,) = trace.calls()
    assert [s.name for s in call.spans
            if s.name.startswith("gt.setup.")] == []
    assert trace.setup_spans() == []
    trace.clear()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("kind", sorted(RUNS))
def test_a_dropped_graph_frees_its_card_memory(card, kind):
    def run_and_drop():
        csr = _graph()
        if kind == "bfs auto":
            bfs.run(csr, _src(csr), traversal_mode="auto", device=card)
        else:
            sssp.run(csr, _src(csr), mode="planes", device=card)
        del csr
        gc.collect()
        torch.cuda.synchronize(card)
        return torch.cuda.memory_allocated(card)
    base = run_and_drop()       # the kernels' own state, once a process
    assert run_and_drop() == base


def test_derived_builds_once_per_key_and_holds_no_graph():
    csr = _graph()
    built = []

    def build():
        built.append(1)
        return csr          # an object that refers back to its graph
    assert derived(csr, "k", build) is csr
    assert derived(csr, "k", build) is csr
    assert derived(csr, ("k", 2), lambda: False) is False
    assert derived(csr, ("k", 2), build) is False
    assert built == [1]
    alive = weakref.ref(csr)
    del csr, build
    gc.collect()
    assert alive() is None


def test_a_pickled_graph_leaves_what_it_derived_behind():
    csr = _graph()
    search_graph(csr, CPU)
    is_symmetric(csr)
    copy = pickle.loads(pickle.dumps(csr))
    assert isinstance(copy, CsrGraph)
    assert "_derived" not in vars(copy)
    np.testing.assert_array_equal(copy.col_indices, csr.col_indices)
    assert search_graph(copy, CPU) is not search_graph(csr, CPU)
