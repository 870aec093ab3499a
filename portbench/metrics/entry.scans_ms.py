"""The median over the window's calls of the entry's host scans: argument
checks (SSSP's scan of every weight among them), reach masks and the
`Stats` block's sums (every `gt.entry.check`, `gt.entry.reach` and
`gt.entry.stats` span of the call).  Host work only: it moves the
caller's rate, and the card's only through the copies it holds up."""

from portbench.queries import spans

SCANS = ("gt.entry.check", "gt.entry.reach", "gt.entry.stats")


def read(rec):
    return spans.median(
        sum(s.elapsed_ms for s in spans.named(call, *SCANS))
        for _, call in spans.window_calls(rec))
