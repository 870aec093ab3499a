"""The median over the window's calls of the blocking host reads
(`host_read` counts) under the timed search (the root's
`gt.entry.search`), over the call's levels or rounds
(`Stats.search_depth`)."""

from portbench.queries import spans


def read(rec):
    return spans.per_level(rec, lambda name: name == "host_read")
