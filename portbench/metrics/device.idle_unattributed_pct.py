"""The share of the traced window's idle card time that no program span
names: the idle seconds less those of the `breakdown.idle_gaps` labels
that start with `gt.`, over the idle seconds.  Labels outside the top
ten count as unattributed, so this reads high, never low."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.has_device_time or tr.window_s <= 0:
        return None
    idle = tr.window_s - tr.busy_s
    if idle <= 0:
        return 0.0
    named = sum(s for label, s in tr.idle_gaps if label.startswith("gt."))
    return 100.0 * (idle - named) / idle
