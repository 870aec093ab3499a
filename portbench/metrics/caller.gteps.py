"""The caller's rate: simple undirected edges traversed (`work/teps.py`,
not Graph500's tuple count) by every query completed in the window, over
the window's seconds on the host's clock, in billions."""


def read(rec):
    if rec.window_s <= 0 or not rec.served:
        return None
    return sum(q.edges for q in rec.served) / rec.window_s / 1e9
