"""The program's host connected components (`component_labels`, for the
reach masks): the sum of the run's `gt.setup.components` spans, 0 where
the cell's path needs none."""

from portbench.queries import spans


def read(rec):
    return spans.setup_s("gt.setup.components")
