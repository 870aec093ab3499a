"""The median over the window's calls of the call's warm-up search, with
its own extraction (the root's `gt.entry.warmup` span)."""

from portbench.queries import spans


def read(rec):
    return spans.root_phase_ms(rec, "gt.entry.warmup")
