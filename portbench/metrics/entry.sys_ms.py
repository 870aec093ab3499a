"""The mean over the window's calls of the system CPU time of the
caller's thread over the whole call (the root span's `getrusage`
difference), in ms: page faults of fresh host arrays, pageable copies.
A mean, not a median: the kernel charges system time a clock tick (10 ms
on the H100 host) at a time, so one call reads 0 or 10 and only the mean
over many calls says how much there is."""

from portbench.queries import spans


def read(rec):
    calls = spans.window_calls(rec)
    if not calls:
        return None
    return sum(call.root.sys_s for _, call in calls) * 1e3 / len(calls)
