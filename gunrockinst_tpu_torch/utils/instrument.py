"""Instrumentation: per-iteration tracing, resumable stepping, and
algorithm-state checkpointing.

Counterpart of the JAX package's `utils/instrument.py`, after the
reference's INST layer, which slices long-running kernels into
resumable time slices, persists a yield point and reports per-launch
progress (kernel_runtime_stats.cuh:21-29, the relaunch loops of
bfs_enactor.cuh:384-505, the "l advance <iter> <yield_point> <elapsed>"
traces of advance/kernel.cuh:639):

  * `ProgressTracer`: per-slice records (kernel, iteration, frontier
    size, wall ms, device ms) in the reference's trace-line format, and
    the `avg_duty` summary;
  * `SteppedBfs`, `SteppedSssp`, `SteppedCc`: the search in slices of
    up to `slice_depth` rounds; between slices the host may yield,
    checkpoint or stop;
  * `save_state` / `load_state`: vertex state to an .npz and back, with
    the JAX package's keys and dtypes, so that a checkpoint written by
    either package resumes in the other.

A slice queues its `slice_depth` rounds without reading anything back
and makes one host read at its end.  A round whose frontier (pending
set; CC: last round's change) is already empty changes no state, and
the round counter only counts rounds that had work, so the slice ends
in the state of the reference's `lax.while_loop`, which stops there.
Each slice runs under `torch.profiler.record_function` with the JAX
package's annotation name.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device
from gunrockinst_tpu_torch.ops import frontier as fr
from gunrockinst_tpu_torch.ops.segment import scatter_min, scatter_or
from gunrockinst_tpu_torch.primitives.base import GraphLike, device_graph

INT_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass
class TraceRecord:
    kernel: str
    iteration: int
    frontier_size: int
    elapsed_ms: float           # wall time for the slice (incl. host)
    device_ms: float = 0.0      # queued -> device-completion time


class ProgressTracer:
    """Collects per-slice progress (EnactorStats + INST trace analog).
    `avg_duty` is the reference's per-kernel duty metric
    (util/kernel_runtime_stats.cuh:226-290: kernel running time /
    lifetime): here device ms over wall ms, summed over slices."""

    def __init__(self, verbose: bool = False):
        self.records: List[TraceRecord] = []
        self.verbose = verbose

    def record(self, kernel: str, iteration: int, frontier_size: int,
               elapsed_ms: float, device_ms: float = 0.0) -> None:
        self.records.append(
            TraceRecord(kernel, iteration, frontier_size, elapsed_ms,
                        device_ms))
        if self.verbose:
            # reference trace-line shape: "l advance <iter> <...> <elapsed>"
            duty = 100.0 * device_ms / elapsed_ms if elapsed_ms else 0.0
            print(f"l {kernel} {iteration} {frontier_size} "
                  f"{elapsed_ms:.4f} dev {device_ms:.4f} duty {duty:.1f}%")

    @property
    def total_queued(self) -> int:
        return sum(r.frontier_size for r in self.records)

    @property
    def total_elapsed_ms(self) -> float:
        return sum(r.elapsed_ms for r in self.records)

    @property
    def total_device_ms(self) -> float:
        return sum(r.device_ms for r in self.records)

    @property
    def avg_duty(self) -> float:
        """Device-time share of wall time, 0..1 (avg_duty analog)."""
        wall = self.total_elapsed_ms
        return (self.total_device_ms / wall) if wall > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        return dict(iterations=len(self.records),
                    total_queued=self.total_queued,
                    elapsed_ms=self.total_elapsed_ms,
                    device_ms=round(self.total_device_ms, 4),
                    avg_duty=round(self.avg_duty, 4))


# -- checkpoint / restore ----------------------------------------------------

def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_state(path: str, **arrays) -> None:
    """Persist named vertex-state arrays (+ scalars) to an .npz."""
    np.savez(path, **{k: _host(v) for k, v in arrays.items()})


def load_state(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class _Stepped:
    """The slice loop the three stepped searches share: `_slice` queues
    one slice and returns the device scalars read at its end."""

    kernel = ""

    def _setup(self, graph: GraphLike, slice_depth: int,
               tracer: Optional[ProgressTracer], device: DeviceLike):
        dev = resolve_device(device)
        self.graph = device_graph(graph, dev)
        self.device = dev
        self.slice_depth = int(slice_depth)
        self.tracer = tracer or ProgressTracer()
        self.done = False

    def step(self) -> bool:
        """Run one slice.  Returns True while not converged.

        The wall/device split feeds ProgressTracer.avg_duty: device_ms
        spans from the moment the slice is queued (the device working)
        to the end of the host read that waits for it; wall time also
        counts the queueing before it and the bookkeeping after, so a
        duty below 1 measures host overhead."""
        if self.done:
            return False
        t0 = time.perf_counter()
        with torch.profiler.record_function(self._annotation()):
            scalars = self._slice()
            t1 = time.perf_counter()    # queued; the device working
            iteration, size, more = torch.stack(
                [x.to(torch.int32) for x in scalars]).tolist()
        t2 = time.perf_counter()        # the read waited for the device
        self._read(iteration)
        self.done = not more
        elapsed = (time.perf_counter() - t0) * 1e3
        self.tracer.record(self.kernel, iteration, size, elapsed,
                           (t2 - t1) * 1e3)
        return not self.done

    def run_to_completion(self) -> np.ndarray:
        while self.step():
            pass
        return self._result()[: self.graph.n].cpu().numpy()


# -- stepped / resumable BFS -------------------------------------------------

class SteppedBfs(_Stepped):
    """Cooperatively preemptible BFS: `slice_depth` levels a `step()`,
    checkpoint and resume between slices.

    The reference's yield-point relaunch loop (`while h_yield_point <
    grid-1`, bfs_enactor.cuh:384) becomes `while not done: step()`, with
    the slice boundary at level granularity."""

    kernel = "advance"

    def __init__(self, graph: GraphLike, src: int, slice_depth: int = 1,
                 tracer: Optional[ProgressTracer] = None,
                 device: DeviceLike = None):
        self._setup(graph, slice_depth, tracer, device)
        g = self.graph
        if not 0 <= int(src) < g.n:
            raise ValueError(f"source vertex {src} out of range [0, {g.n})")
        self.labels = torch.full((g.n_pad,), INT_MAX, dtype=torch.int32,
                                 device=g.device)
        self.labels[int(src)] = 0
        self.frontier = fr.singleton_bitmap(src, g.n_pad, g.device)
        self.depth = torch.zeros((), dtype=torch.int32, device=g.device)
        self._depth = 0

    def _annotation(self) -> str:
        return f"bfs_slice_d{self._depth}"

    def _slice(self):
        """Up to `slice_depth` levels (the reference's `_bfs_slice`)."""
        g = self.graph
        esrc, edst = g.edge_src, g.edge_dst
        labels, frontier, depth = self.labels, self.frontier, self.depth
        for _ in range(self.slice_depth):
            live = frontier.any()
            cand = frontier[esrc] & (labels[edst] == INT_MAX)
            touched = scatter_or(torch.zeros(g.n_pad, dtype=torch.bool,
                                             device=g.device), edst, cand)
            newf = touched & (labels == INT_MAX)
            labels = torch.where(newf, depth + 1, labels)
            frontier = newf
            depth = depth + live.to(torch.int32)
        self.labels, self.frontier, self.depth = labels, frontier, depth
        size = fr.frontier_size(frontier)
        return depth, size, size > 0

    def _read(self, iteration: int) -> None:
        self._depth = iteration

    def _result(self) -> torch.Tensor:
        return self.labels

    # -- persistence --------------------------------------------------------

    def checkpoint(self, path: str) -> None:
        save_state(path, labels=self.labels, frontier=self.frontier,
                   depth=self.depth)

    @staticmethod
    def resume(graph: GraphLike, path: str, slice_depth: int = 1,
               tracer: Optional[ProgressTracer] = None,
               device: DeviceLike = None) -> "SteppedBfs":
        """A SteppedBfs in the state of the checkpoint at `path` (written
        by this package's `checkpoint` or the JAX package's)."""
        state = load_state(path)
        obj = SteppedBfs.__new__(SteppedBfs)
        obj._setup(graph, slice_depth, tracer, device)
        dev = obj.graph.device
        obj.labels = torch.from_numpy(
            state["labels"].astype(np.int32)).to(dev)
        obj.frontier = torch.from_numpy(
            state["frontier"].astype(bool)).to(dev)
        obj._depth = int(state["depth"])
        obj.depth = torch.tensor(obj._depth, dtype=torch.int32, device=dev)
        obj.done = bool((~state["frontier"]).all())
        return obj


# -- stepped SSSP / CC (the reference runs its INST relaunch loop for
# these enactors too: sssp_enactor.cuh, cc_enactor.cuh:300) ------------

class SteppedSssp(_Stepped):
    """Cooperatively preemptible SSSP: `slice_depth` Bellman rounds a
    slice, relaxing the pending vertices' out-edges (primitives/sssp.py
    bellman semantics: f32 `dist[src] + w`, a scatter-min)."""

    kernel = "relax"

    def __init__(self, graph: GraphLike, src: int, slice_depth: int = 1,
                 tracer: Optional[ProgressTracer] = None,
                 device: DeviceLike = None):
        self._setup(graph, slice_depth, tracer, device)
        g = self.graph
        if not 0 <= int(src) < g.n:
            raise ValueError(f"source vertex {src} out of range [0, {g.n})")
        self.dist = torch.full((g.n_pad,), float("inf"),
                               dtype=torch.float32, device=g.device)
        self.dist[int(src)] = 0.0
        self.pending = fr.singleton_bitmap(src, g.n_pad, g.device)
        self.it = torch.zeros((), dtype=torch.int32, device=g.device)
        self._it = 0

    def _annotation(self) -> str:
        return f"sssp_slice_{self._it}"

    def _slice(self):
        g = self.graph
        esrc, edst, w = g.edge_src, g.edge_dst, g.edge_w
        dist, pending, it = self.dist, self.pending, self.it
        for _ in range(self.slice_depth):
            live = pending.any()
            vals = torch.where(pending[esrc], dist[esrc] + w, float("inf"))
            relaxed = scatter_min(torch.full_like(dist, float("inf")),
                                  edst, vals)
            newdist = torch.minimum(dist, relaxed)
            pending = newdist < dist
            dist = newdist
            it = it + live.to(torch.int32)
        self.dist, self.pending, self.it = dist, pending, it
        size = pending.sum(dtype=torch.int32)
        return it, size, size > 0

    def _read(self, iteration: int) -> None:
        self._it = iteration

    def _result(self) -> torch.Tensor:
        return self.dist

    def checkpoint(self, path: str) -> None:
        save_state(path, dist=self.dist, pending=self.pending, it=self.it)


class SteppedCc(_Stepped):
    """Cooperatively preemptible connected components: `slice_depth`
    rounds of hooking and two pointer jumps a slice (primitives/cc.py
    semantics)."""

    kernel = "hook"

    def __init__(self, graph: GraphLike, slice_depth: int = 1,
                 tracer: Optional[ProgressTracer] = None,
                 device: DeviceLike = None):
        self._setup(graph, slice_depth, tracer, device)
        g = self.graph
        self.comp = torch.arange(g.n_pad, dtype=torch.int32,
                                 device=g.device)
        self.it = torch.zeros((), dtype=torch.int32, device=g.device)
        self._it = 0

    def _annotation(self) -> str:
        return f"cc_slice_{self._it}"

    def _slice(self):
        g = self.graph
        esrc, edst = g.edge_src, g.edge_dst
        comp, it = self.comp, self.it
        # each slice starts as if the last round had changed a label;
        # at a fixpoint a round changes nothing, so only `it` is gated
        changed = torch.ones((), dtype=torch.bool, device=g.device)
        for _ in range(self.slice_depth):
            hook = scatter_min(comp, edst, comp[esrc])
            hook = scatter_min(hook, esrc, comp[edst])
            hook = hook[hook]
            hook = hook[hook]
            it = it + changed.to(torch.int32)
            changed = (hook != comp).any()
            comp = hook
        moved = (comp != self.comp).sum(dtype=torch.int32)
        self.comp, self.it = comp, it
        return it, moved, changed

    def _read(self, iteration: int) -> None:
        self._it = iteration

    def _result(self) -> torch.Tensor:
        return self.comp

    def checkpoint(self, path: str) -> None:
        save_state(path, comp=self.comp, it=self.it)
