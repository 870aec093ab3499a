"""The median over the window's queries of the search span over its
levels or rounds (`Stats.elapsed_ms / Stats.search_depth`)."""

from portbench.harness import median


def read(rec):
    return median(q.elapsed_ms / q.depth for q in rec.served if q.depth > 0)
