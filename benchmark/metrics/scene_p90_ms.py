"""90th percentile of the per-scan latency over every scan of the window
(host clock, from the scan's host arrays to its matches on the host)."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 90)) * 1e3
