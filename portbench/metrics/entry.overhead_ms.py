"""The median over the window's queries of the call's wall time less the
search span the call reports (`Stats.elapsed_ms`): the entry's own work
around the search (warm-up search, reach mask, label assembly, parents,
copies)."""

from portbench.harness import median


def read(rec):
    return median(q.wall_s * 1e3 - q.elapsed_ms for q in rec.served)
