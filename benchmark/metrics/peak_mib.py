"""The device memory the window's searches held at their peak
(``torch.cuda.max_memory_allocated``, reset after the warm-up)."""


def read(run):
    return run.peak_bytes / 2**20 if run.peak_bytes else None
