"""The median over the window's calls of the hand-written kernels'
launches (`launch.*` counts) under the timed search (the root's
`gt.entry.search`), over the call's levels or rounds
(`Stats.search_depth`)."""

from portbench.queries import spans


def read(rec):
    return spans.per_level(rec, lambda name: name.startswith("launch."))
