"""BFS queries' least time on the card (work/bfs.py's bytes at the HBM
peak) over their summed device time in the trace, over the checked
sample."""


def read(rec):
    return rec.roofline_pct("bfs")
