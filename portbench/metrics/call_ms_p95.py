"""call_ms_p95: the 95th percentile of one call's wall time, numpy in to
numpy out, over every call of the window (numpy's linear percentile)."""

import numpy as np


def read(run):
    if not run.calls:
        return None
    return float(np.percentile([c.wall_s for c in run.calls], 95)) * 1e3
