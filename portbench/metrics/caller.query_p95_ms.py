"""The 95th percentile of one call's wall time over all of the window's
queries (a failed query counts with the time it took to fail)."""

import numpy as np


def read(rec):
    if not rec.queries:
        return None
    return float(np.percentile([q.wall_s for q in rec.queries], 95)) * 1e3
