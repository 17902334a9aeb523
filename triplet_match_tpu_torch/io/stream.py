"""Streaming PCD ingestion for out-of-core scans (counterpart of
``triplet_match_tpu.io.stream``).

``read_pcd`` holds the whole raw record buffer plus the output arrays; this
module streams fixed-size chunks out of a memory-mapped file instead:

* :func:`iter_pcd_chunks` yields (xyz, normal, tangent) chunk arrays;
* :func:`read_pcd_streaming` assembles a ``PointCloud`` with peak extra
  memory of one chunk's records.

Binary PCD streams off the mmap; ASCII parses line batches;
``binary_compressed`` decodes once (an LZF stream is sequential) and chunks
the raw rows.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.io.pcd import (
    _extract_columns,
    _field_layout,
    _parse_header,
    read_pcd_arrays,
)


def iter_pcd_chunks(path: str, chunk_points: int = 1_000_000
                    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (xyz, normal, tangent) float32 chunks of up to ``chunk_points``
    raw rows (NaN rows kept, as ``read_pcd_arrays`` returns them)."""
    with open(path, "rb") as f:
        head = f.read(65536)
    header, offset = _parse_header(head)
    n = int(header["POINTS"][0])
    mode = header["DATA"][0].lower()
    dt, names = _field_layout(header)

    if mode == "binary":
        mm = np.memmap(path, dtype=np.uint8, mode="r")
        for start in range(0, n, chunk_points):
            cnt = min(chunk_points, n - start)
            lo = offset + start * dt.itemsize
            arr = np.frombuffer(mm[lo:lo + cnt * dt.itemsize], dtype=dt, count=cnt)
            yield _extract_columns(arr, names)
    elif mode == "ascii":
        with open(path, "rb") as f:
            f.seek(offset)
            done = 0
            while done < n:
                cnt = min(chunk_points, n - done)
                lines = [f.readline().decode("ascii", "replace") for _ in range(cnt)]
                flat = np.loadtxt(lines, dtype=np.float64, ndmin=2)
                arr = np.zeros(cnt, dtype=dt)
                for i, name in enumerate(names):
                    arr[name] = flat[:cnt, i].astype(dt[name])
                done += cnt
                yield _extract_columns(arr, names)
    elif mode == "binary_compressed":
        xyz, nrm, tan = read_pcd_arrays(path)
        for start in range(0, n, chunk_points):
            sl = slice(start, min(start + chunk_points, n))
            yield xyz[sl], nrm[sl], tan[sl]
    else:
        raise ValueError(f"unsupported PCD DATA mode: {mode}")


def read_pcd_streaming(path: str, chunk_points: int = 1_000_000, capacity: int | None = None,
                       device="cuda") -> PointCloud:
    """Memory-bounded PCD load, one chunk of raw records live at a time, into
    a ``PointCloud`` on ``device`` (default the CUDA card)."""
    with open(path, "rb") as f:
        head = f.read(65536)
    header, _ = _parse_header(head)
    n = int(header["POINTS"][0])
    xyz = np.empty((n, 3), np.float32)
    nrm = np.empty((n, 3), np.float32)
    tan = np.empty((n, 3), np.float32)
    pos = 0
    for cx, cn, ct in iter_pcd_chunks(path, chunk_points):
        m = cx.shape[0]
        xyz[pos:pos + m] = cx
        nrm[pos:pos + m] = cn
        tan[pos:pos + m] = ct
        pos += m
    return PointCloud.from_arrays(xyz[:pos], nrm[:pos], tan[:pos], capacity=capacity,
                                  device=device)
