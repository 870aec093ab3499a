"""The median over the window's calls of the parents' pass and its
copies (every `gt.entry.preds` span of the call; calls without one are
left out)."""

from portbench.queries import spans


def read(rec):
    per_call = [spans.named(call, "gt.entry.preds")
                for _, call in spans.window_calls(rec)]
    return spans.median(sum(s.elapsed_ms for s in found)
                        for found in per_call if found)
