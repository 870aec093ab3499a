"""Tutorial: run CC -> BFS -> BC on one graph with the PyTorch/CUDA port
and validate each against its NumPy oracle.

The port's twin of examples/simple_example.py (the reference's
simple_example/simple_example.cu: CC, BFS and BC with CPU references;
prints TEST PASSED).  With no .mtx path it runs on a generated graph,
rmat scale 12, edge factor 8, undirected, seed 0.

Usage: python examples/simple_example_torch.py [path/to/graph.mtx] [--device=cpu]
"""

import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import gunrockinst_tpu_torch as gt  # noqa: E402
from gunrockinst_tpu_torch.oracles import (bc_reference,  # noqa: E402
                                           bfs_reference, cc_reference)
from gunrockinst_tpu_torch.primitives import bc, bfs, cc  # noqa: E402


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    for a in list(argv):
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
            argv.remove(a)
    if argv:
        graph = gt.load_market(argv[0], undirected=True)
    else:
        graph = gt.rmat_graph(12, 8, undirected=True, seed=0)
    print(f"graph: {graph.num_nodes} nodes, {graph.num_edges} edges")

    ok = True

    res = cc.run(graph, device=device)
    good = np.array_equal(res.component_ids, cc_reference(graph))
    print(f"CC: {res.num_components} components "
          f"({'match' if good else 'MISMATCH'})")
    res.stats.display("cc")
    ok &= good

    # BFS from the largest-degree vertex
    src = int(np.argmax(graph.degrees))
    r = bfs.run(graph, src, mark_preds=True, device=device)
    labels, preds = bfs_reference(graph, src)
    good = (np.array_equal(r.labels, labels)
            and np.array_equal(r.preds, preds))
    print(f"BFS from {src}: depth {r.stats.search_depth} "
          f"({'match' if good else 'MISMATCH'})")
    r.stats.display("bfs")
    ok &= good

    rb = bc.run(graph, src=src, device=device)
    ref_bc, _, _ = bc_reference(graph, src=src)
    good = np.allclose(rb.bc_values, ref_bc, rtol=1e-4, atol=1e-5)
    print(f"BC (single source {src}): {'match' if good else 'MISMATCH'}")
    rb.stats.display("bc")
    ok &= good

    print("TEST PASSED" if ok else "TEST FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
