"""The program's host transposes (`CsrGraph.transposed`): the sum of the
run's outermost `gt.setup.transpose` spans."""

from portbench.queries import spans


def read(rec):
    return spans.setup_s("gt.setup.transpose", outermost=True)
