"""Host waits on the device (``cudaStreamSynchronize`` and
``cudaDeviceSynchronize`` inside a request's call into the program) per
scan in the traced window."""


def read(run):
    if not run.trace or not run.trace["range_n"]["bench.request"]:
        return None
    return run.trace["syncs"] / run.trace["range_n"]["bench.request"]
