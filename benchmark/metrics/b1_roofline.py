"""Kernel B1's share of its roofline: the least time the counted work of the
traced window's first B1 launches needs at the H100's peaks, over the device
time those launches took."""

from tmbench import counts


def read(run):
    inputs = run.kernel_inputs.get("B1") or []
    times = (run.trace or {}).get("kernel_s", {}).get("B1", [])[:len(inputs)]
    if not inputs or len(times) < len(inputs):
        return None
    bound = sum(counts.bound_s(*counts.b1_work(*x)) for x in inputs)
    return 100.0 * bound / sum(times)
