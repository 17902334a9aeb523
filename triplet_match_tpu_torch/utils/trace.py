"""Device tracing on ``torch.profiler`` (counterpart of ``triplet_match_tpu.utils.trace``).

The reference instruments its hot loop with a stopwatch (impl/scene.hpp:259-264,
357-359); the JAX package wraps ``jax.profiler``.  Here :func:`device_trace`
records host and CUDA activity of a block and writes one Chrome trace
(``trace.json``, viewable in Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the enclosed block into ``<log_dir>/trace.json``.

    Usage::

        with device_trace("traces") as sync:
            result = sync(search_round(...))

    ``sync`` is the identity; the trace waits for the card before it stops
    (``torch.cuda.synchronize``), so kernels the block enqueued land inside
    it.  CUDA activity is recorded when a card is present.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield lambda value: value
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

