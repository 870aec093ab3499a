"""The share of the traced window in which no operation runs on the
card (the union of device intervals in the profiler's trace)."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.has_device_time or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
