"""Simple undirected edges traversed (`work/teps.py`) by every query
completed in the window, over the seconds in which an operation ran on
the card during the window (the union of device intervals in the
profiler's trace), in billions: the rate one card's time buys."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.has_device_time or not rec.served:
        return None
    return sum(q.edges for q in rec.served) / tr.busy_s / 1e9
