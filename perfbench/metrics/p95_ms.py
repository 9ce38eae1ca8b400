"""95th percentile of request latency, submit to ids on the host, over
every request of the window (host clock)."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(run.latencies_s, 95)) * 1e3
