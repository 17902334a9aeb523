"""Reduction of a ``torch.profiler`` trace of the window to the device's busy
time, the idle gaps by what the host was doing, the host ranges and syncs,
and the device time of the ranking kernels.

Busy time is the union of the device's kernel and copy intervals (the
ranges' own device-side markers excluded), as ``chip_smoke._profile``
computes it.  The host ranges are the program's ("hypothesize", "finalize":
the two halves of a search round) and the benchmark's own ("bench.request"
around one request's call into the program, "bench.upload" around the
scan's upload).
"""

from __future__ import annotations

import bisect
import dataclasses

PROGRAM_RANGES = ("hypothesize", "finalize")
BENCH_RANGES = ("bench.request", "bench.upload")
RANGES = PROGRAM_RANGES + BENCH_RANGES
# a gap's label: the innermost range open when it starts
INNERMOST_FIRST = ("hypothesize", "finalize", "bench.upload", "bench.request")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
# device kernel names of B1 and B2 (csrc/coarse_rank.cuh, csrc/exact_rank.cuh);
# the <true> instances are B4 and B3
KERNELS = {"B1": "coarse_rank::rank_kernel<false>", "B2": "exact_rank::rank_kernel<false>"}


@dataclasses.dataclass
class Event:
    name: str
    device: bool
    start_us: float
    end_us: float


def events_from_profiler(prof) -> list:
    """The trace's device operations, ranges and syncs, read from the
    profiler's raw events (building its event tree takes minutes at a few
    hundred thousand launches)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        dev = e.device_type() == DeviceType.CUDA
        if dev or name in RANGES or name in SYNCS:
            start = e.start_ns() / 1e3
            out.append(Event(name, dev, start, start + e.duration_ns() / 1e3))
    return out


def _union(spans) -> list:
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class _Spans:
    """Non-overlapping host intervals of one range name, for point queries."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _ in self.spans]

    def covers(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.spans[i][1] >= t

    def total(self) -> float:
        return sum(e - s for s, e in self.spans)


def reduce_trace(events: list, window_us: tuple) -> dict:
    """Busy and idle time inside ``window_us`` (start, end on the trace's
    clock), the top device operations, the longest idle gaps labelled by the
    innermost open host range, the host ranges' totals and counts, the syncs
    inside requests, and each ranking kernel's device times in launch order."""
    w0, w1 = window_us
    dev = [e for e in events if e.device and e.name not in RANGES and e.end_us > w0
           and e.start_us < w1]
    host = {r: _Spans([(e.start_us, e.end_us) for e in events if not e.device and e.name == r])
            for r in RANGES}
    merged = _union((max(e.start_us, w0), min(e.end_us, w1)) for e in dev)
    busy = sum(e - s for s, e in merged)
    gaps = []
    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            label = next((r for r in INNERMOST_FIRST if host[r].covers(s)), "outside")
            gaps.append((label, (e - s) / 1e6))
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end_us - e.start_us) / 1e6
    syncs = sum(1 for e in events if not e.device and e.name in SYNCS
                and host["bench.request"].covers(e.start_us))
    kernels = {k: [(e.end_us - e.start_us) / 1e6 for e in sorted(dev, key=lambda x: x.start_us)
                   if pat in e.name] for k, pat in KERNELS.items()}
    return {
        "busy_s": busy / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10],
        "idle_by_range": {r: sum(s for lab, s in gaps if lab == r)
                          for r in RANGES + ("outside",)},
        "range_s": {r: host[r].total() / 1e6 for r in RANGES},
        "range_n": {r: len(host[r].spans) for r in RANGES},
        "syncs": syncs,
        "kernel_s": kernels,
    }
