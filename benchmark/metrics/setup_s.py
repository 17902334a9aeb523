"""Process start to the first timed scan: imports, CUDA set-up, the kernel
libraries, ``Model.init``, the scan pool and the warm-up over it."""


def read(run):
    return run.setup_s
