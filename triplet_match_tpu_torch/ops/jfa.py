"""Jump-flood nearest-point volumes, the big-model voxel-LUT builder
(counterpart of ``triplet_match_tpu.ops.jfa``).

The brute LUT (one 1-NN of every voxel centre against the cloud) costs
O(V * N).  The jump flood costs O(V log V) and no per-point term:

* seed: each valid point falls into its containing voxel; where several
  share one, the point nearest the voxel centre wins (a segment minimum of
  the key ``quantised centre distance << 20 | index``);
* propagate: for steps 2^k ... 1, then one more step of 1 ("JFA+1"), every
  voxel adopts the best of its 26 neighbours at that offset when that
  neighbour's seed lies strictly nearer its own centre.  Neighbours come from
  ``torch.roll``, with the cells that wrapped round the volume masked out.

About 97 % of voxels get the exact nearest point (the JAX package's parity
test on the box model); the rest get a point a fraction of a voxel diagonal
farther (0.38 on that model, 0.55 on the recall box model: ROADMAP C20).  Every float sum follows the
JAX function's jitted order on the CPU (XLA fuses ``a*b + c`` into FMAs,
ROADMAP C7), so the two packages give the same integer LUT.  Seed indices
pack into 20 bits: clouds above 2^20 points raise ``ValueError``.
"""

from __future__ import annotations

import numpy as np
import torch

from triplet_match_tpu_torch.core.transforms import fma32

_FAR = 1.0e6
_BIG = 3.0e37
# the 26 neighbour offsets, in the JAX package's order
_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
            if (dx, dy, dz) != (0, 0, 0)]


def _sq3(x, y, z) -> torch.Tensor:
    """x^2 + y^2 + z^2 in XLA's fused order."""
    return fma32(z, z, fma32(x, x, y * y))


def nearest_point_volume(points: torch.Tensor, valid: torch.Tensor, to_voxel: torch.Tensor, *,
                         extents: tuple[int, int, int]) -> torch.Tensor:
    """[ex, ey, ez] int64: the (almost exact) nearest valid point of each
    voxel centre, on the points' device."""
    ex, ey, ez = (int(e) for e in extents)
    nvox = ex * ey * ez
    n = points.shape[0]
    if n > (1 << 20):
        raise ValueError("jump-flood LUT supports up to 2^20 points")
    dev = points.device
    to_voxel = to_voxel.to(torch.float32)

    # voxel centres in world coordinates (the inverse affine of integer coords)
    inv = torch.linalg.inv(to_voxel)
    ci = torch.arange(ex, dtype=torch.float32, device=dev)[:, None, None]
    cj = torch.arange(ey, dtype=torch.float32, device=dev)[None, :, None]
    ck = torch.arange(ez, dtype=torch.float32, device=dev)[None, None, :]

    def axis(r):
        return fma32(inv[r, 2], ck, fma32(inv[r, 0], ci, inv[r, 1] * cj)) + inv[r, 3]

    cx, cy, cz = axis(0), axis(1), axis(2)

    # --- seed: per containing voxel, the point nearest its centre ---
    pos = torch.where(valid[:, None], points.to(torch.float32), _FAR)
    v = pos @ to_voxel[:3, :3].T + to_voxel[:3, 3]
    hi = torch.tensor([ex - 1, ey - 1, ez - 1], device=dev)
    ijk = torch.minimum(torch.clamp(torch.floor(v).to(torch.int64), min=0), hi)
    vid = (ijk[:, 0] * ey + ijk[:, 1]) * ez + ijk[:, 2]
    vid = torch.where(valid, vid, nvox)  # invalid points into a spare segment
    vc = torch.clamp(vid, max=nvox - 1)
    d = [pos[:, 0] - cx.reshape(-1)[vc], pos[:, 1] - cy.reshape(-1)[vc],
         pos[:, 2] - cz.reshape(-1)[vc]]
    d2 = fma32(d[2], d[2], fma32(d[1], d[1], d[0] * d[0]))  # a sum over the last axis
    diag = torch.diagonal(inv[:3, :3])
    voxel_diag2 = fma32(diag[2], diag[2], fma32(diag[1], diag[1], diag[0] * diag[0])) + 1e-12
    # the quantised centre distance only picks WHICH in-voxel point seeds;
    # 4094, not 4095, keeps the largest key below the empty-segment sentinel
    q = torch.clamp(d2 / voxel_diag2 * 1365.0, 0.0, 4094.0).to(torch.int64)
    key = (q << 20) | torch.arange(n, device=dev)
    empty = 0xFFFFFFFF
    seed_key = torch.full((nvox + 1,), empty, dtype=torch.int64, device=dev)
    seed_key = seed_key.scatter_reduce(0, vid, key, "amin")[:nvox]
    seeded = seed_key != empty
    seed_idx = torch.where(seeded, seed_key & 0xFFFFF, -1)
    safe = torch.clamp(seed_idx, 0, max(n - 1, 0))
    shape = (ex, ey, ez)
    px = torch.where(seeded, pos[safe, 0], _FAR).reshape(shape)
    py = torch.where(seeded, pos[safe, 1], _FAR).reshape(shape)
    pz = torch.where(seeded, pos[safe, 2], _FAR).reshape(shape)
    pidx = seed_idx.to(torch.int32).reshape(shape)
    pd = _sq3(px - cx, py - cy, pz - cz)
    del seed_key, seeded, seed_idx, safe

    # --- propagate: halving steps + one extra unit round (JFA+1) ---
    n_halving = max(int(np.ceil(np.log2(max(ex, ey, ez, 2)))), 1)
    steps = [1 << (n_halving - 1 - k) for k in range(n_halving)] + [1]
    ii = torch.arange(ex, device=dev)[:, None, None]
    jj = torch.arange(ey, device=dev)[None, :, None]
    kk = torch.arange(ez, device=dev)[None, None, :]
    for s in steps:
        for ox, oy, oz in _OFFSETS:
            dx, dy, dz = ox * s, oy * s, oz * s

            def roll(a):
                return torch.roll(a, shifts=(dx, dy, dz), dims=(0, 1, 2))

            # wrapped-in cells came from the far side of the volume: invalid
            inb = (((ii - dx >= 0) & (ii - dx < ex)) & ((jj - dy >= 0) & (jj - dy < ey))
                   & ((kk - dz >= 0) & (kk - dz < ez)))
            nx, ny, nz = roll(px), roll(py), roll(pz)
            nd = torch.where(inb, _sq3(nx - cx, ny - cy, nz - cz), _BIG)
            take = nd < pd
            px = torch.where(take, nx, px)
            py = torch.where(take, ny, py)
            pz = torch.where(take, nz, pz)
            pidx = torch.where(take, roll(pidx), pidx)
            pd = torch.where(take, nd, pd)
    return pidx.to(torch.int64)
