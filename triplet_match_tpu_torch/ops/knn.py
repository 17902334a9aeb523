"""Batched nearest-neighbour ops (counterpart of ``triplet_match_tpu.ops.knn``).

The JAX package selects candidates through the matmul expansion and re-ranks
them exactly, chunking both axes so the TPU's fast memory holds one tile.
Here every distance is the direct ``sum((q - r)^2)``, computed one query block
at a time so a block holds at most ``_TILE`` distances; ``radius_sample``
keeps the JAX package's matmul expansion and scans the reference points in
column chunks.  Indices are int64.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from triplet_match_tpu_torch.kernels.build import LaunchCounter

_INF = 3.0e38
_TILE = 1 << 24  # distances per query block
# bytes of temporaries in one column chunk of radius_sample: 512 MiB keeps the
# 131k recall scene in one chunk of its 256 queries
_RADIUS_CHUNK_BYTES = 1 << 29


def _block_rows(n_ref: int, block: int | None) -> int:
    return block or max(1, _TILE // max(n_ref, 1))


def sqdist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Exact squared distances [Q, N] by coordinate differences."""
    d = q[:, None, 0] - r[None, :, 0]
    out = d * d
    for c in (1, 2):
        d = q[:, None, c] - r[None, :, c]
        out = out + d * d
    return out


def knn(q: torch.Tensor, r: torch.Tensor, r_valid: torch.Tensor, k: int, *,
        block: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid reference points per query: (idx [Q, k], sqdist [Q, k]).

    Replaces ``pointcloud::knn_inclusive`` (impl/pointcloud.hpp:138-146).
    With fewer than k valid points the tail carries sqdist ``_INF``.
    """
    n = r.shape[0]
    kk = min(k, n)
    pen = torch.where(r_valid, 0.0, _INF).to(r.dtype)
    rows = _block_rows(n, block)
    idx_out, d2_out = [], []
    for s in range(0, q.shape[0], rows):
        d2 = torch.clamp(sqdist(q[s:s + rows], r) + pen, max=_INF)
        d2k, idx = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
        idx_out.append(idx)
        d2_out.append(d2k)
    idx, d2 = torch.cat(idx_out), torch.cat(d2_out)
    if kk < k:
        pad = k - kk
        idx = torch.cat([idx, idx.new_zeros((idx.shape[0], pad))], 1)
        d2 = torch.cat([d2, d2.new_full((d2.shape[0], pad), _INF)], 1)
    return idx, d2


def nn1(q: torch.Tensor, r: torch.Tensor, r_valid: torch.Tensor, *,
        block: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Single nearest valid neighbour (argmin; the voxel-LUT build primitive,
    impl/model.hpp:81-94).  Ties go to the lower reference index."""
    n = r.shape[0]
    pen = torch.where(r_valid, 0.0, _INF).to(r.dtype)
    rows = _block_rows(n, block)
    idx_out, d2_out = [], []
    for s in range(0, q.shape[0], rows):
        d2 = sqdist(q[s:s + rows], r) + pen
        d2m, idx = d2.min(dim=1)
        idx_out.append(idx)
        d2_out.append(d2m)
    return torch.cat(idx_out), torch.cat(d2_out)


def nearest_grid_plain(points: torch.Tensor, valid: torch.Tensor, to_voxel: torch.Tensor,
                       extents: tuple[int, int, int]) -> torch.Tensor:
    """[ex, ey, ez] int64: the nearest valid point to every voxel's sample
    point (the voxel at integer voxel coordinates mapped back to the world),
    by one ``nn1`` over all of them (impl/model.hpp:81-94): the table
    ``compile_model`` builds on its brute route, and ``nearest_grid``'s plain
    version."""
    ex, ey, ez = (int(e) for e in extents)
    dev = points.device
    inv = torch.linalg.inv(to_voxel)
    ii, jj, kk = torch.meshgrid(
        torch.arange(ex, dtype=torch.float32, device=dev),
        torch.arange(ey, dtype=torch.float32, device=dev),
        torch.arange(ez, dtype=torch.float32, device=dev), indexing="ij")
    centers = torch.stack([ii, jj, kk], dim=-1).reshape(-1, 3) @ inv[:3, :3].T + inv[:3, 3]
    idx, _ = nn1(centers, points, valid)
    return idx.reshape(ex, ey, ez)


NEAREST_GRID = LaunchCounter()


def nearest_grid(points: torch.Tensor, valid: torch.Tensor, to_voxel: torch.Tensor,
                 extents: tuple[int, int, int]) -> torch.Tensor:
    """``nearest_grid_plain``'s table: on the CPU the plain version, on the
    card one launch of ``csrc/nearest_grid.cu`` (ties may fall the other way
    where two points lie within float32 rounding of one distance)."""
    if points.device.type != "cuda":
        return nearest_grid_plain(points, valid, to_voxel, extents)
    from triplet_match_tpu_torch.kernels.build import load_nearest_grid

    ex, ey, ez = (int(e) for e in extents)
    inv = torch.linalg.inv(to_voxel.to(torch.float32)).cpu()
    if inv[0, 2] != 0 or inv[1, 2] != 0:
        raise ValueError("nearest_grid needs voxel x and y independent of the voxel's k")
    ids = torch.nonzero(valid)[:, 0]
    lut = torch.zeros((ex, ey, ez), dtype=torch.int64, device=points.device)
    if ids.numel() == 0 or lut.numel() == 0:
        return lut
    # float4 rows: x, y, z and the point's index, copied as bits
    pts = torch.empty((ids.numel(), 4), dtype=torch.int32, device=points.device)
    pts[:, :3] = points[ids].to(torch.float32).contiguous().view(torch.int32)
    pts[:, 3] = ids
    a = [float(inv[r, c]) for r, c in ((0, 0), (0, 1), (0, 3), (1, 0), (1, 1), (1, 3), (2, 0),
                                       (2, 1), (2, 2), (2, 3))]
    lib = load_nearest_grid()
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = lib.nearest_grid_launch(pts.data_ptr(), ids.numel(), lut.data_ptr(), ex, ey, ez,
                                  *(ctypes.c_float(x) for x in a), stream)
    if err != 0:
        raise RuntimeError("nearest_grid kernel launch failed: "
                           f"{lib.nearest_grid_error_string(err).decode()}")
    NEAREST_GRID.launches += 1
    return lut


def nn1_exclusive_dist(cloud, *, block: int | None = None) -> torch.Tensor:
    """Distance from each valid point to its nearest *other* valid point."""
    xyz, valid = cloud.xyz, cloud.valid
    n = xyz.shape[0]
    pen = torch.where(valid, 0.0, _INF).to(xyz.dtype)
    rows = _block_rows(n, block)
    out = []
    for s in range(0, n, rows):
        d2 = sqdist(xyz[s:s + rows], xyz) + pen
        i = torch.arange(s, min(s + rows, n), device=xyz.device)
        d2[i - s, i] = _INF
        out.append(d2.amin(dim=1))
    d2 = torch.clamp(torch.cat(out), max=_INF)
    return torch.where(valid, torch.sqrt(d2), torch.zeros_like(d2))


def radius_chunk_cols(n_ref: int, rows: int) -> int:
    """Reference columns per chunk of ``radius_sample`` for ``rows`` queries:
    the widest chunk whose temporaries fit ``_RADIUS_CHUNK_BYTES``, evened out
    over the chunks the scene needs."""
    # 13 bytes per (query, reference point) pair: float32 distance, bool, int64 key
    width = max(1, _RADIUS_CHUNK_BYTES // (13 * max(rows, 1)))
    chunks = -(-max(n_ref, 1) // width)
    return -(-max(n_ref, 1) // chunks)


def radius_sample(q: torch.Tensor, r: torch.Tensor, r_valid: torch.Tensor, radius, k: int,
                  prio: torch.Tensor, *,
                  block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Up to ``k`` in-radius points per query, the ``k`` lowest priorities.

    ``prio`` [N] are per-point uniform priorities >= 0 (the driver passes
    ``sampling.hash_uniform`` values), so this is a uniform sample of the
    ball, or the whole ball when it holds <= k points (impl/scene.hpp:273).
    Ties in priority go to the lower index, and empty slots carry index 0
    with mask False, as the JAX chunked top-k merge resolves both.  The
    in-radius test uses the JAX package's centred matmul expansion.

    The reference points are scanned ``radius_chunk_cols`` columns at a time
    (the chunk's temporaries stay within ``_RADIUS_CHUNK_BYTES``), merging
    each chunk's best ``k`` into a running best ``k``.  Every candidate
    carries one unique int64 key, the float32 bits of its priority above its
    index (non-negative floats order as their bits), so each top-k is exact
    and the result is the same for every chunk width.

    Returns (indices [Q, k] int64, mask [Q, k] bool).
    """
    rad = np.float32(float(radius))
    rad2 = float(rad * rad)  # float32 square, as the JAX package takes it
    n = r.shape[0]
    # + 0.0 maps -0.0 to +0.0: its sign bit would order it before every other 0
    prio = torch.where(r_valid, prio.to(torch.float32) + 0.0, _INF).contiguous()
    inf_key = int(np.array(_INF, np.float32).view(np.int32)) << 32
    keys = (prio.view(torch.int32).to(torch.int64) << 32) | torch.arange(n, device=r.device)
    wv = r_valid.to(r.dtype)
    center = (r * wv[:, None]).sum(0) / torch.clamp(wv.sum(), min=1.0)
    rc = r - center
    rr = (rc * rc).sum(-1)
    kk = min(k, n)
    width = radius_chunk_cols(n, min(block, q.shape[0]))
    best_out = []
    for s in range(0, q.shape[0], block):
        qc = q[s:s + block] - center
        qq = (qc * qc).sum(-1)[:, None]
        best = None
        for c in range(0, n, width):
            # qq - 2 q.r + rr, clamped at 0: the same roundings as one whole-row pass
            d2 = (qc @ rc[c:c + width].T).mul_(-2.0).add_(qq).add_(rr[c:c + width])
            cand = torch.where(d2.clamp_(min=0.0) <= rad2, keys[None, c:c + width], inf_key)
            cand = torch.topk(cand, min(kk, cand.shape[1]), dim=1, largest=False).values
            if best is not None:
                cand = torch.cat([best, cand], 1)
                cand = torch.topk(cand, min(kk, cand.shape[1]), dim=1, largest=False).values
            best = cand
        best_out.append(best)
    best = torch.cat(best_out)
    mask = best < inf_key
    idx = torch.where(mask, best & 0xFFFFFFFF, 0)
    if kk < k:
        idx = torch.cat([idx, idx.new_zeros((idx.shape[0], k - kk))], 1)
        mask = torch.cat([mask, mask.new_zeros((mask.shape[0], k - kk))], 1)
    return idx, mask
