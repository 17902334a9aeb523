"""Kernel B2's device time per scan: the summed device time of every B2
(count mode) launch in the traced window, in ms, over the scans the window
traced."""


def read(run):
    times = (run.trace or {}).get("kernel_s", {}).get("B2", [])
    n = (run.trace or {}).get("range_n", {}).get("bench.request", 0)
    if not times or not n:
        return None
    return 1e3 * sum(times) / n
