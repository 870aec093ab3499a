"""The program's own spans and counters (`gunrockinst_tpu_torch.utils.
trace`), as the per-layer metrics under `metrics/` read them.  Like the
primitive adaptors beside it, this is the benchmark's one door to a part
of the program: the readers import it, not the program.

Every outermost `bfs.run` or `sssp.run` leaves a call record (`trace.
calls()`, the last 1024).  The window's records are those whose source
matches a served query's root, taken in order: roots never repeat in a
run, and the warm-up's roots are not the window's.  A reader reports the
median over the records still held.  With a program that keeps no trace
(`ImportError`), every function here returns None or nothing.
"""

from __future__ import annotations

import statistics
from typing import Iterable, List, Optional, Tuple


def _trace():
    try:
        from gunrockinst_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def window_calls(rec) -> List[Tuple[object, object]]:
    """(query, call record) of every served query of `rec` whose record
    is still held, in the window's order."""
    trace = _trace()
    if trace is None:
        return []
    index = {q.root: i for i, q in enumerate(rec.served)}
    served = rec.served
    out, last = [], -1
    for call in trace.calls():
        i = index.get(call.src)
        if (call.primitive != rec.primitive or not call.spans or i is None
                or i <= last):
            continue
        out.append((served[i], call))
        last = i
    return out


def median(values: Iterable[float]) -> Optional[float]:
    values = list(values)
    return float(statistics.median(values)) if values else None


def children(call, span, name: str) -> list:
    """The direct children of `span` in `call` named `name`."""
    return [s for s in call.spans if s.parent == span.id and s.name == name]


def subtree(call, span) -> list:
    """`span` and every span under it in `call`."""
    inside, out = {span.id}, [span]
    for s in call.spans:
        if s.parent in inside and s.id not in inside:
            inside.add(s.id)
            out.append(s)
    return out


def named(call, *names: str) -> list:
    return [s for s in call.spans if s.name in names]


def counted(spans, keep) -> int:
    """The sum of the counts of `spans` whose name passes `keep`."""
    return sum(v for s in spans for k, v in s.counts.items() if keep(k))


def root_phase_ms(rec, name: str) -> Optional[float]:
    """Median over the window's calls of the root's direct `name`
    spans, in ms (calls without one are left out)."""
    per_call = []
    for _, call in window_calls(rec):
        found = children(call, call.root, name)
        if found:
            per_call.append(sum(s.elapsed_ms for s in found))
    return median(per_call)


def per_level(rec, keep) -> Optional[float]:
    """Median over the window's calls of the counts passing `keep` under
    the root's timed `gt.entry.search`, over the call's depth
    (`Stats.search_depth`; calls of depth 0 left out)."""
    per_call = []
    for query, call in window_calls(rec):
        found = children(call, call.root, "gt.entry.search")
        if found and query.depth > 0:
            spans = [s for f in found for s in subtree(call, f)]
            per_call.append(counted(spans, keep) / query.depth)
    return median(per_call)


def setup_s(name: str, outermost: bool = False) -> Optional[float]:
    """The sum of the process's `name` set-up spans, in s (0 where none
    ran); with `outermost`, leaving out those inside another `name`
    span.  None with a program that keeps no trace."""
    trace = _trace()
    if trace is None:
        return None
    spans = trace.setup_spans()
    by_id = {s.id: s for s in spans}

    def nested(s):
        p = by_id.get(s.parent)
        while p is not None:
            if p.name == name:
                return True
            p = by_id.get(p.parent)
        return False

    return sum(s.elapsed_ms for s in spans
               if s.name == name and not (outermost and nested(s))) / 1e3
