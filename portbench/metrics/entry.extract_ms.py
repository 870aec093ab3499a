"""The median over the window's calls of the timed search's extraction:
labels or distances back to input ids on the host (the root's direct
`gt.entry.extract` span; the warm-up's own is left out)."""

from portbench.queries import spans


def read(rec):
    return spans.root_phase_ms(rec, "gt.entry.extract")
