"""The 90th percentile of the latency of every request of the window, from
the call to the answer on the host."""

import numpy as np


def read(run):
    """numpy's default percentile: linear between the order statistics."""
    lat = [1e3 * (r.t1 - r.t0) for r in run.records]
    return float(np.percentile(lat, 90)) if lat else None
