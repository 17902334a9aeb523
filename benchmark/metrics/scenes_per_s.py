"""Scans completed in the window over the window's seconds (host clock): the
closed loop's throughput."""


def read(run):
    return len(run.latencies_s) / run.window_s if run.window_s > 0 else None
