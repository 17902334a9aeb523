"""The trace reduction on a hand-made timeline."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "benchmark"))

from tmbench.trace import Event, reduce_trace  # noqa: E402


def test_busy_gaps_ranges_syncs_and_kernels():
    ev = [
        Event("bench.request", False, 0, 100), Event("bench.upload", False, 0, 10),
        Event("hypothesize", False, 10, 40), Event("finalize", False, 40, 90),
        Event("cudaStreamSynchronize", False, 50, 51), Event("cudaStreamSynchronize", False, 95, 96),
        Event("cudaDeviceSynchronize", False, 101, 102),
        Event("Memcpy HtoD", True, 2, 8),
        Event("void coarse_rank::rank_kernel<false>(float const*)", True, 12, 20),
        Event("hypothesize", True, 10, 40),  # the range's own device-side marker
        Event("void coarse_rank::rank_kernel<true>(float const*)", True, 22, 25),
        Event("gemm", True, 45, 60), Event("gemm", True, 55, 70),
        Event("void exact_rank::rank_kernel<false>(float const*)", True, 80, 84),
    ]
    r = reduce_trace(ev, (0, 100))
    assert r["busy_s"] == pytest.approx((6 + 8 + 3 + 25 + 4) / 1e6)
    assert r["window_s"] == pytest.approx(100 / 1e6)
    assert r["syncs"] == 2  # the one after the request is the benchmark's own
    assert r["range_n"]["hypothesize"] == 1 and r["range_s"]["finalize"] == pytest.approx(5e-5)
    assert r["kernel_s"]["B1"] == [pytest.approx(8e-6)] and r["kernel_s"]["B2"] == [
        pytest.approx(4e-6)]
    # gaps: [0,2] and [8,12] in the upload, [20,22] and [25,45] in
    # hypothesize, [70,80] and [84,100] in finalize
    assert r["idle_gaps"][0] == ("hypothesize", pytest.approx(20e-6))
    assert len(r["idle_gaps"]) == 6
    by = r["idle_by_range"]
    assert by["bench.upload"] == pytest.approx(6e-6)
    assert by["hypothesize"] == pytest.approx(22e-6)
    assert by["finalize"] == pytest.approx(26e-6)
    assert by["bench.request"] == 0 and by["outside"] == 0
    assert r["device_ops"][0] == ("gemm", pytest.approx(30e-6))
