"""Spans and counters of the port's entry points, on the profiler's clock.

A span names a stretch of host work:

    with trace.span("gt.entry.extract") as s:
        ...
    s.elapsed_ms

While a `torch.profiler` profile is active, each span also enters a
record function of its name (torch's `_RecordFunctionFast`, else
`torch.profiler.record_function`), so it lands in the profiler's trace
beside the card's events, and the trace's idle gaps take its name.
Every span keeps its start and end on `time.perf_counter_ns`, its
parent and the counts made while it was the innermost open span.  A
call's root span and the set-up spans also keep the system CPU time and
minor page faults of their thread over their extent
(`getrusage(RUSAGE_THREAD)`).  The other spans do not: under the CUDA
profiler on an H100 host the two reads cost about 0.2 ms, more than a
level's work, and `record_function` 30-55 us where the fast form costs
next to nothing.  The stack of open spans is per thread.

`count(name, k)` adds to the innermost open span's counts and to the
process-wide `totals()`.  Names used by the port:

  * `launch.mega_step`, `launch.chain_bfs`, `launch.touch_sweep`,
    `launch.spmv`, `launch.value_stats` and `launch.value_step.<route>`
    (`dense`, `push`, `touched` where the host chose the route, `auto`
    where the card did): launches of the hand-written kernels (their
    plain versions count none);
  * `host_read`: each blocking read of the device's data by the host
    (`.item()`, `.tolist()`, `.cpu()`), counted whatever the device;
  * `copy.d2h_bytes`, `copy.h2d_bytes`: the bytes of each copy between
    host and device, from the tensors' sizes;
  * `kernel.build`: each `nvcc` run;
  * `level.push`, `level.pull`: the order each level of the step
    kernel's search took (`SearchGraph.search`);
  * `relabel.degree`, `relabel.breadth`, `relabel.none`: the order a
    graph's relabel took, once per graph (`graph/relabel.py`);
  * `warmup.search`: each search of the BFS and SSSP kernel routes
    whose answer is dropped (`primitives/base.py::warm_search`): on a
    cached search object's first call, and on a route switch.

The outermost `bfs.run` or `sssp.run` of a thread opens a call record
(`call`): its primitive, source, route, span tree, and
`clock_offset_ns` (`time.time_ns() - time.perf_counter_ns()` at the
call's start), which puts every stamp of the call on the epoch clock the
profiler's CPU events carry.  An entry called inside another is a child
span.  `calls()` holds the last CALLS records; every `gt.setup.*` span is
also kept in `setup_spans()`, so that set-up stays readable after its
call has left.  A call records at most SPANS_PER_CALL spans: later ones
are still timed and profiled, and their counts go to the innermost
recorded span.

Nothing here reads the device or queues work on it.  `set_enabled(False)`
turns it all off: spans then only time, and counts are dropped.
"""

from __future__ import annotations

import collections
import itertools
import resource
import threading
import time
from typing import Dict, List, Optional

import torch

CALLS = 1024            # call records kept
SETUP = 4096            # set-up spans kept
SPANS_PER_CALL = 256    # spans recorded in one call
SETUP_PREFIX = "gt.setup."

_RUSAGE = getattr(resource, "RUSAGE_THREAD", resource.RUSAGE_SELF)
_profiling = torch.autograd._profiler_enabled
_record = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
           or torch.profiler.record_function)

_enabled = True
_local = threading.local()
_ids = itertools.count(1)
_calls: "collections.deque[Call]" = collections.deque(maxlen=CALLS)
_setup: "collections.deque[Span]" = collections.deque(maxlen=SETUP)
_totals: Dict[str, int] = {}
_lock = threading.Lock()


class Call:
    """One outermost entry call: `spans[0]` is its root span, the rest
    in the order they opened."""

    __slots__ = ("id", "primitive", "src", "route", "spans",
                 "clock_offset_ns", "dropped")

    def __init__(self, primitive: str, src: int):
        self.id = next(_ids)
        self.primitive = primitive
        self.src = int(src)
        self.route = ""
        self.spans: List[Span] = []
        self.clock_offset_ns = time.time_ns() - time.perf_counter_ns()
        self.dropped = 0        # spans past SPANS_PER_CALL

    @property
    def root(self) -> "Span":
        return self.spans[0]

    def self_ms(self, span: "Span") -> float:
        """`span`'s time less that of its recorded children."""
        return span.elapsed_ms - sum(s.elapsed_ms for s in self.spans
                                     if s.parent == span.id)


class Span:
    """A named stretch of host work; see the module's docstring.  Times
    are perf_counter_ns stamps; `sys_s` and `minflt` are the thread's
    system CPU seconds and minor page faults over the span (a call's
    root and set-up spans only; 0 elsewhere)."""

    __slots__ = ("id", "parent", "name", "start_ns", "end_ns", "counts",
                 "sys_s", "minflt", "record", "_rf", "_on", "_kept",
                 "_opens", "_usage")

    def __init__(self, name: str, opens: Optional[tuple] = None):
        self.name = name
        self.id = self.parent = 0
        self.start_ns = self.end_ns = 0
        self.counts: Dict[str, int] = {}
        self.sys_s = 0.0
        self.minflt = 0
        self.record: Optional[Call] = None   # the call this span opened
        self._rf = None
        self._on = self._kept = False
        self._opens = opens     # (primitive, src) for an entry's root
        self._usage = opens is not None or name.startswith(SETUP_PREFIX)

    @property
    def elapsed_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def set_route(self, route: str) -> None:
        """The route of the call this span opened, if it opened one."""
        if self.record is not None:
            self.record.route = route

    def __enter__(self) -> "Span":
        # the stamps enclose the record function, whose first entry in a
        # process takes about a millisecond after the profiler's stamp
        self.start_ns = time.perf_counter_ns()
        self._on = _enabled
        if self._on:
            if _profiling():
                self._rf = _record(self.name)
                self._rf.__enter__()
            self._open()
        return self

    def _open(self) -> None:
        stack = _stack()
        call = getattr(_local, "call", None)
        if call is None and self._opens is not None:
            call = _local.call = self.record = Call(*self._opens)
            _calls.append(call)
        if call is not None and len(call.spans) >= SPANS_PER_CALL:
            call.dropped += 1
        else:
            self._kept = True
            self.id = next(_ids)
            self.parent = stack[-1].id if stack else 0
            if call is not None:
                call.spans.append(self)
            if self.name.startswith(SETUP_PREFIX):
                _setup.append(self)
            stack.append(self)
        if self._usage:
            use = resource.getrusage(_RUSAGE)
            self.sys_s, self.minflt = -use.ru_stime, -use.ru_minflt

    def __exit__(self, *exc) -> bool:
        if self._on:
            if self._usage:
                use = resource.getrusage(_RUSAGE)
                self.sys_s += use.ru_stime
                self.minflt += use.ru_minflt
            if self._kept:
                _stack().pop()
            if self.record is not None:
                _local.call = None
            if self._rf is not None:
                self._rf.__exit__(*exc)
                self._rf = None
        self.end_ns = time.perf_counter_ns()
        return False


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str) -> Span:
    """A context manager naming a stretch of host work (see the
    module's docstring); it yields the Span, whose `elapsed_ms` holds
    after the block, traced or not."""
    return Span(name)


def call(name: str, primitive: str, src: int) -> Span:
    """The root span of an entry point's call: it opens a call record
    when no call is open on this thread, else it is a child span."""
    return Span(name, (primitive, src))


def count(name: str, k: int = 1) -> None:
    """Add k to the innermost open span's count `name` and to the
    process-wide total."""
    if not _enabled:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + k
    with _lock:
        _totals[name] = _totals.get(name, 0) + k


def d2h(t):
    """Count one blocking host read of `t` (a tensor or array) and its
    bytes, copied device to host; returns `t`."""
    count("host_read")
    count("copy.d2h_bytes", int(t.nbytes))
    return t


def h2d(t):
    """Count the bytes of `t` (a tensor or array), copied host to
    device; returns `t`."""
    count("copy.h2d_bytes", int(t.nbytes))
    return t


def totals() -> Dict[str, int]:
    """Every counter's total since the last `reset_totals`."""
    with _lock:
        return dict(_totals)


def reset_totals() -> None:
    with _lock:
        _totals.clear()


def calls() -> List[Call]:
    """The last CALLS call records, oldest first."""
    return list(_calls)


def setup_spans() -> List[Span]:
    """The last SETUP `gt.setup.*` spans, oldest first, whatever call
    they ran in."""
    return list(_setup)


def clear() -> None:
    """Forget the call records and set-up spans (not the totals)."""
    _calls.clear()
    _setup.clear()


def set_enabled(on: bool) -> None:
    """Turn spans and counters on (the default) or off, process-wide."""
    global _enabled
    _enabled = bool(on)
