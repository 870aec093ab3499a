"""The program's kernel builds (`nvcc`, at a checkout's first run) and
loads: the sum of the run's `gt.setup.kernel_load` spans."""

from portbench.queries import spans


def read(rec):
    return spans.setup_s("gt.setup.kernel_load")
