"""The profiler's trace of a measured window, reduced to what the
per-layer metrics and the result's `breakdown` read.

Each query of the window runs inside a `record_function(QUERY)` span.
From torch.profiler's raw events (CPU ops, CUDA kernels, copies and
sets) this takes: the traced window (first query's start to the last
one's end), the card's busy time in it (the union of device intervals),
each query's summed device time (device events that start inside its
span), the device operations that took most time, and the idle gaps,
summed by what the host was doing while the card waited.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import List, Tuple

import torch

QUERY = "portbench.query"
TOP = 10
NAME_CHARS = 160        # a kernel's C++ name is cut to this in the breakdown


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    query_device_s: List[float]          # one per traced query
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    @property
    def has_device_time(self) -> bool:
        return self.busy_s > 0


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def _host_labels(ops, points):
    """For each (time, payload) in `points`, sorted by time, the name of
    the innermost host op running then, or "host code after <op>" (the
    op that ended last before it) when none was running."""
    out = []
    stack, j, last = [], 0, "window start"
    last_end = -1
    for t, payload in points:
        while j < len(ops) and ops[j][0] <= t:
            start = ops[j][0]
            while stack and stack[-1][1] <= start:
                done = stack.pop()
                if done[1] > last_end:
                    last_end, last = done[1], done[2]
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] < t:
            done = stack.pop()
            if done[1] > last_end:
                last_end, last = done[1], done[2]
        out.append((stack[-1][2] if stack else f"host code after {last}",
                    payload))
    return out


def summarize(prof) -> Summary:
    cpu = torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    spans, host, device = [], [], []
    for e in events:
        if e.device_type() == cpu:
            item = (e.start_ns(), e.end_ns(), e.name(), e.start_thread_id())
            (spans if e.name() == QUERY else host).append(item)
        elif not e.is_user_annotation() and e.name() != QUERY:
            # the card's own work; a span's mirror on the card is not
            device.append((e.start_ns(), e.end_ns(), e.name()))
    spans.sort()
    if not spans:
        return Summary(0.0, 0.0, [], [], [])
    thread = spans[0][3]
    host = sorted(h[:3] for h in host if h[3] == thread)
    lo, hi = spans[0][0], spans[-1][1]
    device = sorted(d for d in device if d[1] > lo and d[0] < hi)

    busy = _union((max(s, lo), min(e, hi)) for s, e, _ in device)
    busy_ns = sum(e - s for s, e in busy)

    per_query, k = [], 0
    for start, end, _, _ in spans:
        total = 0
        while k < len(device) and device[k][0] < start:
            k += 1
        j = k
        while j < len(device) and device[j][0] <= end:
            total += device[j][1] - device[j][0]
            j += 1
        per_query.append(total / 1e9)

    by_name = defaultdict(int)
    for s, e, name in device:
        by_name[name] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    gaps, prev = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            gaps.append(((prev + s) // 2, s - prev))
        prev = max(prev, e)
    idle = defaultdict(int)
    for label, length in _host_labels(host, gaps):
        idle[label] += length
    idle_top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]

    return Summary(window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9,
                   query_device_s=per_query,
                   device_ops=[(n[:NAME_CHARS], v / 1e9) for n, v in ops],
                   idle_gaps=[(n, v / 1e9) for n, v in idle_top])
