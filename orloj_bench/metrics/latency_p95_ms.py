"""The 95th percentile of release-to-finish time (ms, on the window's
clock) over the counted requests that finished, late ones included.  A
dropped request has no latency; it counts in ``finish_rate``."""

import numpy as np


def read(run):
    lat = [r.finished - r.release for r in run.counted if r.finished is not None]
    return float(np.percentile(lat, 95)) if lat else None
