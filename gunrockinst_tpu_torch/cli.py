"""CLI drivers: one subcommand per primitive.

Counterpart of the JAX package's `cli.py`, after the reference's
standalone test drivers (tests/*/test_*.cu): parse the flags, build the
graph, run the primitive, optionally validate against the NumPy oracle,
print the reference's metric schema (elapsed / MiEdges/s /
search_depth, tests/bfs/test_bfs.cu:210-235) and a DisplaySolution-style
result dump.  The same subcommands, flags and result lines as the JAX
CLI; `--device` takes a card index (the default, 0) or `cpu`.

A kernel route (`--traversal-mode` planes, pallas or mega; SSSP's
default) falls back to the operator layer only when its getter refuses
the input with a ValueError or TypeError, and then says so; an error in
building or launching a kernel propagates.

Usage:
    python -m gunrockinst_tpu_torch.cli bfs market graph.mtx --src=largestdegree
    python -m gunrockinst_tpu_torch.cli sssp rmat --rmat-scale=20 --undirected
    python -m gunrockinst_tpu_torch.cli pr rmat --rmat-scale=14 --device=cpu
"""

from __future__ import annotations

import sys

import numpy as np

from gunrockinst_tpu_torch.utils.config import (load_graph, resolve_source,
                                                standard_parser,
                                                torch_device)

PRIMS = ["bfs", "dobfs", "sssp", "cc", "bc", "pr", "topk", "hits",
         "salsa", "wtf", "mis", "mst"]
# what a kernel route's getter raises for an input it refuses
REFUSED = (ValueError, TypeError)


def _display(name, ids, values, limit=10):
    print(f"[{name}] first {min(limit, len(ids))} entries:")
    for i in range(min(limit, len(ids))):
        print(f"    Node_ID {ids[i]}: {values[i]}")


def _validate(name, ok):
    print(f"{name} CORRECTNESS: {'PASSED' if ok else 'FAILED'}")
    return 0 if ok else 1


def _timed(args, fn):
    """Run fn() --iteration-num times and report the MEAN elapsed over
    the repetitions (the reference averages its GpuTimer over
    --iteration-num runs, tests/bfs/test_bfs.cu:402-431)."""
    res = fn()
    if args.iteration_num > 1:
        total = res.stats.elapsed_ms
        for _ in range(args.iteration_num - 1):
            res = fn()
            total += res.stats.elapsed_ms
        res.stats.elapsed_ms = total / args.iteration_num
    return res


def _kernel_mode(prim, mode, getter, fallback):
    """`mode` when `getter()` accepts the graph, else `fallback` with
    the JAX CLI's notice; only a refusal (REFUSED) falls back."""
    try:
        getter()
        return mode
    except REFUSED as e:
        print(f"{prim} {mode} mode unavailable ({e}); "
              f"falling back to {fallback}")
        return fallback


def _instrumented(prim, tracer, stats_kw, ok_fn, args):
    """The INST-mode tail the three stepped searches share: the tracer's
    summary, the metric block with avg_duty, the validation."""
    from gunrockinst_tpu_torch.primitives.base import Stats
    print(f"instrumented run: {tracer.summary()}")
    Stats(elapsed_ms=tracer.total_elapsed_ms,
          search_depth=len(tracer.records),
          total_queued=tracer.total_queued, avg_duty=tracer.avg_duty,
          **stats_kw).display(prim)
    if not args.quick:
        return _validate(prim, ok_fn())
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m gunrockinst_tpu_torch.cli "
              f"<{'|'.join(PRIMS)}> <market file.mtx | rmat> [flags]")
        return 0
    prim = argv.pop(0)
    if prim not in PRIMS:
        print(f"unknown primitive '{prim}'; choose from {PRIMS}")
        return 2
    args = standard_parser(prim).parse_args(argv)
    dev = torch_device(args.device)
    csr = load_graph(args)
    if not args.quiet:
        print(f"graph: {csr.num_nodes} nodes, {csr.num_edges} edges")
    rc = 0

    if prim in ("bfs", "dobfs"):
        from gunrockinst_tpu_torch.primitives import bfs as bfs_mod
        from gunrockinst_tpu_torch.primitives import dobfs as dobfs_mod
        src = resolve_source(args.src, csr)
        if prim == "bfs" and args.instrumented:
            # INST mode: sliced execution with per-slice trace lines
            from gunrockinst_tpu_torch.oracles import bfs_reference
            from gunrockinst_tpu_torch.utils.instrument import (
                ProgressTracer, SteppedBfs)
            tracer = ProgressTracer(verbose=True)
            stepped = SteppedBfs(csr.to_device(with_csc=False, device=dev),
                                 src, tracer=tracer, device=dev)
            labels = stepped.run_to_completion()
            reached = labels != np.iinfo(np.int32).max
            return _instrumented(
                prim, tracer,
                dict(nodes_visited=int(reached.sum()),
                     edges_visited=int(csr.degrees[reached].sum())),
                lambda: np.array_equal(labels, bfs_reference(csr, src)[0]),
                args)
        if prim == "bfs":
            res = _timed(args, lambda: bfs_mod.run(
                csr, src, mark_preds=args.mark_pred,
                traversal_mode=args.traversal_mode, device=dev))
        else:
            res = _timed(args, lambda: dobfs_mod.run(
                csr, src, alpha=args.alpha, beta=args.beta,
                mark_preds=args.mark_pred, device=dev))
        res.stats.display(prim)
        _display(prim, np.arange(len(res.labels)), res.labels)
        if not args.quick:
            from gunrockinst_tpu_torch.oracles import bfs_reference
            labels, _ = bfs_reference(csr, src)
            rc = _validate(prim, np.array_equal(res.labels, labels))

    elif prim == "sssp":
        from gunrockinst_tpu_torch.primitives import sssp as m
        src = resolve_source(args.src, csr)
        if args.instrumented:
            from gunrockinst_tpu_torch.oracles import sssp_reference
            from gunrockinst_tpu_torch.utils.instrument import (
                ProgressTracer, SteppedSssp)
            tracer = ProgressTracer(verbose=True)
            stepped = SteppedSssp(csr.to_device(with_csc=False, device=dev),
                                  src, tracer=tracer, device=dev)
            dist = stepped.run_to_completion()
            return _instrumented(
                prim, tracer,
                dict(nodes_visited=int(np.isfinite(dist).sum()),
                     edges_visited=csr.num_edges),
                lambda: np.array_equal(dist, sssp_reference(csr, src)[0]),
                args)
        # "dense" is the global default flag value; for SSSP it means
        # the value kernel ("planes"), as in the JAX CLI, which says so;
        # an explicit --traversal-mode=sparse/auto keeps the operator
        # layer
        s_mode = "sparse"
        if args.traversal_mode in ("planes", "dense"):
            s_mode = _kernel_mode(prim, "planes",
                                  lambda: m.get_sssp_planes(csr, dev),
                                  "sparse")
            if s_mode == "planes" and args.traversal_mode != "planes":
                print("sssp: using the value-plane fast path "
                      "(default; --traversal-mode=sparse to override)")
        res = _timed(args, lambda: m.run(
            csr, src, delta=args.delta_factor, mode=s_mode,
            mark_preds=args.mark_pred, device=dev))
        res.stats.display(prim)
        _display(prim, np.arange(len(res.dist)), res.dist)
        if not args.quick:
            from gunrockinst_tpu_torch.oracles import sssp_reference
            dist, _ = sssp_reference(csr, src)
            rc = _validate(prim, np.array_equal(res.dist, dist))

    elif prim == "cc":
        from gunrockinst_tpu_torch.primitives import cc as m
        if args.instrumented:
            # cc_enactor.cuh:300 runs the INST relaunch loop as well
            from gunrockinst_tpu_torch.oracles import cc_reference
            from gunrockinst_tpu_torch.utils.instrument import (
                ProgressTracer, SteppedCc)
            tracer = ProgressTracer(verbose=True)
            stepped = SteppedCc(csr.to_device(with_csc=False, device=dev),
                                tracer=tracer, device=dev)
            comp = stepped.run_to_completion()
            return _instrumented(
                prim, tracer,
                dict(nodes_visited=csr.num_nodes,
                     edges_visited=csr.num_edges),
                lambda: np.array_equal(comp, cc_reference(csr)), args)
        c_mode = "xla"
        if args.traversal_mode == "planes":
            c_mode = _kernel_mode(prim, "planes",
                                  lambda: m.get_cc_planes(csr, dev), "xla")
        res = _timed(args, lambda: m.run(csr, mode=c_mode, device=dev))
        res.stats.display(prim)
        print(f"number of components: {res.num_components}")
        _display(prim, np.arange(len(res.component_ids)), res.component_ids)
        if not args.quick:
            from gunrockinst_tpu_torch.oracles import cc_reference
            rc = _validate(prim, np.array_equal(res.component_ids,
                                                cc_reference(csr)))

    elif prim == "bc":
        from gunrockinst_tpu_torch.primitives import bc as m
        src = resolve_source(args.src, csr)
        bc_mode = "xla"
        if args.traversal_mode == "planes":
            bc_mode = _kernel_mode(prim, "planes",
                                   lambda: m.get_bc_planes(csr, dev), "xla")
        res = _timed(args, lambda: m.run(csr, src=src, mode=bc_mode,
                                         device=dev))
        res.stats.display(prim)
        _display(prim, np.arange(len(res.bc_values)), res.bc_values)
        if not args.quick:
            from gunrockinst_tpu_torch.oracles import bc_reference
            ref, _, _ = bc_reference(csr, src=src)
            rc = _validate(prim, np.allclose(res.bc_values, ref,
                                             rtol=1e-4, atol=1e-5))

    elif prim == "pr":
        from gunrockinst_tpu_torch.primitives import pr as m
        pr_mode = "xla"
        if args.traversal_mode in ("pallas", "planes"):
            getter = (m.get_spmv_sweeper if args.traversal_mode == "pallas"
                      else m.get_pr_planes)
            pr_mode = _kernel_mode(prim, args.traversal_mode,
                                   lambda: getter(csr, dev), "xla")
        res = _timed(args, lambda: m.run(
            csr, delta=args.delta, threshold=args.error,
            max_iter=args.max_iter, mode=pr_mode, device=dev))
        res.stats.display(prim)
        _display(prim, res.node_ids[: args.top_nodes],
                 res.sorted_ranks[: args.top_nodes])
        if not args.quick:
            from gunrockinst_tpu_torch.oracles import pagerank_reference
            ref = pagerank_reference(csr, delta=args.delta,
                                     threshold=args.error,
                                     max_iter=args.max_iter)
            rc = _validate(prim, np.allclose(res.ranks, ref, rtol=1e-4,
                                             atol=1e-5))

    elif prim == "topk":
        from gunrockinst_tpu_torch.primitives import topk as m
        res = m.run(csr, args.top_nodes, device=dev)
        res.stats.display(prim)
        for i in range(len(res.node_ids)):
            print(f"    Node ID {res.node_ids[i]}: in_degrees "
                  f"{res.in_degrees[i]}: out_degrees {res.out_degrees[i]}")
        if not args.quick:
            from gunrockinst_tpu_torch.oracles import topk_degree_reference
            ids, _, _, _ = topk_degree_reference(csr, args.top_nodes)
            rc = _validate(prim, np.array_equal(res.node_ids, ids))

    elif prim == "hits":
        from gunrockinst_tpu_torch.primitives import hits as m
        src = resolve_source(args.src, csr)
        h_mode = "xla"
        if args.traversal_mode == "planes":
            h_mode = _kernel_mode(prim, "planes",
                                  lambda: m.get_hits_planes(csr, dev), "xla")
        res = m.run(csr, src=src, delta=args.delta,
                    max_iter=args.max_iter, mode=h_mode, device=dev)
        res.stats.display(prim)
        order = np.argsort(-res.hub_ranks)[: args.top_nodes]
        _display("hub", order, res.hub_ranks[order])
        if not args.quick:
            from gunrockinst_tpu_torch.oracles import hits_reference
            hub, _ = hits_reference(csr, src, delta=args.delta,
                                    max_iter=args.max_iter)
            rc = _validate(prim, np.allclose(res.hub_ranks, hub, rtol=1e-4,
                                             atol=1e-6))

    elif prim == "salsa":
        from gunrockinst_tpu_torch.primitives import salsa as m
        sa_mode = "xla"
        if args.traversal_mode == "planes":
            sa_mode = _kernel_mode(prim, "planes",
                                   lambda: m.get_salsa_planes(csr, dev),
                                   "xla")
        res = m.run(csr, max_iter=args.max_iter, mode=sa_mode, device=dev)
        res.stats.display(prim)
        order = np.argsort(-res.auth_ranks)[: args.top_nodes]
        _display("auth", order, res.auth_ranks[order])
        if not args.quick:
            from gunrockinst_tpu_torch.oracles import salsa_reference
            _, auth = salsa_reference(csr, max_iter=args.max_iter)
            rc = _validate(prim, np.allclose(res.auth_ranks, auth,
                                             rtol=1e-4, atol=1e-6))

    elif prim == "wtf":
        from gunrockinst_tpu_torch.primitives import wtf as m
        src = resolve_source(args.src, csr)
        w_mode = "xla"
        if args.traversal_mode == "planes":
            w_mode = _kernel_mode(prim, "planes",
                                  lambda: m.get_wtf_planes(csr, dev), "xla")
        res = m.run(csr, src=src, alpha=args.salsa_alpha, delta=args.delta,
                    threshold=args.error, max_iter=args.max_iter,
                    mode=w_mode, device=dev)
        res.stats.display(prim)
        order = np.argsort(-res.wtf_ranks)[: args.top_nodes]
        _display(prim, order, res.wtf_ranks[order])
        if not args.quick:
            from gunrockinst_tpu_torch.oracles import wtf_reference
            ref, _, _ = wtf_reference(csr, src, alpha=args.salsa_alpha,
                                      delta=args.delta,
                                      threshold=args.error,
                                      max_iter=args.max_iter)
            rc = _validate(prim, np.allclose(res.wtf_ranks, ref, rtol=1e-4,
                                             atol=1e-6))

    elif prim == "mis":
        from gunrockinst_tpu_torch.primitives import mis as m
        res = m.run(csr, device=dev)
        res.stats.display(prim)
        print(f"MIS size: {int(res.in_set.sum())}")
        if not args.quick:
            from gunrockinst_tpu_torch.oracles import verify_mis
            rc = _validate(prim, verify_mis(csr, res.in_set))

    elif prim == "mst":
        from gunrockinst_tpu_torch.primitives import mst as m
        res = m.run(csr, device=dev)
        res.stats.display(prim)
        print(f"MST: {len(res.edges)} edges, total weight "
              f"{res.total_weight}")
        if not args.quick:
            from gunrockinst_tpu_torch.oracles import verify_spanning_tree
            ok = verify_spanning_tree(_canonical_csr(csr), res.edge_mask)
            rc = _validate(prim, ok)

    return rc


def _canonical_csr(csr):
    """CSR over the canonical undirected edge set the MST kernel uses."""
    from gunrockinst_tpu_torch.graph.coo import CooGraph
    from gunrockinst_tpu_torch.graph.csr import CsrGraph
    from gunrockinst_tpu_torch.primitives.mst import canonical_edges
    u, v, w = canonical_edges(csr)
    return CsrGraph.from_coo(
        CooGraph(csr.num_nodes, u.astype(np.int64), v.astype(np.int64), w))


if __name__ == "__main__":
    raise SystemExit(main())
