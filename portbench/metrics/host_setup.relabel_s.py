"""The program's host relabel of the graph (degree or breadth-first
order): the sum of the run's `gt.setup.relabel` spans."""

from portbench.queries import spans


def read(rec):
    return spans.setup_s("gt.setup.relabel")
