"""The program's breadth-first depth probe of the relabel (a search
over every edge that decides whether the breadth-first order pays):
the sum of the run's `gt.setup.depth_probe` spans, or nothing where no
such span was recorded (a program without it, or a graph that takes
the degree order)."""

from portbench.queries import spans

SPAN = "gt.setup.depth_probe"


def read(rec):
    trace = spans._trace()
    if trace is None or not any(s.name == SPAN
                                for s in trace.setup_spans()):
        return None
    return spans.setup_s(SPAN)
