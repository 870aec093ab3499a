"""The median over the window's calls of the bytes copied between host
and card in the call (the `copy.d2h_bytes` and `copy.h2d_bytes` counts
of every span of the call, from the tensors' sizes), in 10^6 bytes."""

from portbench.queries import spans


def _copies(name):
    return name in ("copy.d2h_bytes", "copy.h2d_bytes")


def read(rec):
    return spans.median(spans.counted(call.spans, _copies) / 1e6
                        for _, call in spans.window_calls(rec))
