"""The median over the window's calls of the mean wall time of the
levels that the step kernel took in pull order: the `gt.driver.level`
spans under the root's `gt.entry.search` that count `level.pull` (a
launch and its one host read).  Calls without a pull level are left
out, so a program that counts no direction reads nothing."""

import statistics

from portbench.queries import spans


def read(rec):
    per_call = []
    for _, call in spans.window_calls(rec):
        pulls = [s.elapsed_ms
                 for found in spans.children(call, call.root,
                                             "gt.entry.search")
                 for s in spans.subtree(call, found)
                 if s.name == "gt.driver.level" and s.counts.get("level.pull")]
        if pulls:
            per_call.append(statistics.fmean(pulls))
    return spans.median(per_call)
