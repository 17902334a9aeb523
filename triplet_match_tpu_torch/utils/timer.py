"""Stopwatch and phase profiling (counterpart of ``triplet_match_tpu.utils.timer``).

Mirrors the reference ``timer`` (include/impl/timer.hpp:9-44) and the
streaming averages of ``find_in_subset`` (impl/scene.hpp:259-264, 357-359).
PyTorch returns before the card finishes, so a section that times device work
passes the tensors it produced through the yielded ``sync``, which waits for
their card before the stop stamp.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Timer:
    """Chrono stopwatch (impl/timer.hpp semantics: start/stop/reset, ms)."""

    def __init__(self):
        self._start = None
        self._elapsed = 0.0

    def start(self):
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None
        return self._elapsed * 1e3

    def reset(self):
        self._start = None
        self._elapsed = 0.0

    @property
    def milliseconds(self) -> float:
        extra = time.perf_counter() - self._start if self._start is not None else 0.0
        return (self._elapsed + extra) * 1e3


class StreamingAverage:
    """Numerically stable running mean (``average``, include/common:104-115)."""

    def __init__(self):
        self.count = 0
        self.value = 0.0

    def update(self, x: float) -> float:
        self.count += 1
        self.value += (x - self.value) / self.count
        return self.value


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of the tensors in ``value`` (nested tuples, lists and
    dicts are walked)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    return out


class Profiler:
    """Per-phase wall-clock accumulation with device sync."""

    def __init__(self):
        self.phases: dict[str, StreamingAverage] = defaultdict(StreamingAverage)

    @contextlib.contextmanager
    def section(self, name: str):
        """Time a phase.  Pass tensors produced INSIDE the block through the
        yielded ``sync`` (identity) so their device work is included::

            with profiler.section("round") as sync:
                out = sync(step(...))

        Before the stop stamp ``torch.cuda.synchronize`` runs once for each
        card those tensors lie on; CPU tensors need no wait."""
        pending: list = []

        def sync(value):
            pending.append(value)
            return value

        t0 = time.perf_counter()
        yield sync
        for dev in _cuda_devices(pending, set()):
            torch.cuda.synchronize(dev)
        self.phases[name].update((time.perf_counter() - t0) * 1e3)

    def report(self) -> str:
        return " | ".join(f"{k}: {v.value:.2f}ms (n={v.count})" for k, v in self.phases.items())
