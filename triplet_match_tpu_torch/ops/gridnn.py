"""Grid-bucketed nearest neighbours (counterpart of ``triplet_match_tpu.ops.gridnn``).

Points hash into a uniform grid with packed 30-bit cell ids (10 bits/axis);
the ids are sorted once and a query gathers candidates from its 27-cell
stencil through ``searchsorted``.  Distances are direct differences.  Cells
holding more than ``cap`` points contribute an even-strided subsample, and
neighbours beyond the one-ring stencil are never found (the same
approximation contract as the JAX package).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_SENTINEL = 0x7FFFFFFF
_INF = 3.0e38


class GridIndex(NamedTuple):
    sids: torch.Tensor  # [N] int64 sorted packed cell ids (invalid -> sentinel)
    order: torch.Tensor  # [N] int64 point index per sorted slot
    lo: torch.Tensor  # [3] grid origin
    inv_cell: torch.Tensor  # [3] cells per unit length per axis
    dims: torch.Tensor  # [3] int64 cells per axis (each <= 1024)


def _cell_coords(xyz, lo, inv_cell, dims) -> torch.Tensor:
    c = torch.floor((xyz - lo) * inv_cell).to(torch.int64)
    return torch.minimum(torch.clamp(c, min=0), dims - 1)


def _pack(c: torch.Tensor) -> torch.Tensor:
    return c[..., 0] | (c[..., 1] << 10) | (c[..., 2] << 20)


def build_grid(xyz: torch.Tensor, valid: torch.Tensor, cell_size) -> GridIndex:
    """Index ``xyz`` (with validity mask) at ``cell_size``."""
    v = valid[:, None]
    lo = torch.where(v, xyz, _INF).amin(0)
    hi = torch.where(v, xyz, -_INF).amax(0)
    ext = torch.clamp(hi - lo, min=1e-6)
    cell = torch.clamp(torch.as_tensor(cell_size, dtype=torch.float32, device=xyz.device), min=1e-6)
    # floor, not ceil: the effective edge ext/dims must be >= cell_size or the
    # one-ring stencil misses true neighbours
    dims = torch.clamp(torch.floor(ext / cell).to(torch.int64), 1, 1024)
    inv_cell = dims.to(torch.float32) / ext
    ids = torch.where(valid, _pack(_cell_coords(xyz, lo, inv_cell, dims)), _SENTINEL)
    sids, order = torch.sort(ids, stable=True)
    return GridIndex(sids=sids, order=order, lo=lo, inv_cell=inv_cell, dims=dims)


def grid_neighbors(grid: GridIndex, r_xyz: torch.Tensor, q_xyz: torch.Tensor, k: int, *,
                   cap: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Up to ``k`` nearest indexed points per query from the 27-cell stencil.

    Returns (idx [B, k] int64, mask [B, k] bool); masked slots carry
    arbitrary indices.
    """
    b = q_xyz.shape[0]
    dev = q_xyz.device
    qc = _cell_coords(q_xyz, grid.lo, grid.inv_cell, grid.dims)
    r3 = torch.arange(-1, 2, device=dev)
    offs = torch.stack(torch.meshgrid(r3, r3, r3, indexing="ij"), dim=-1).reshape(27, 3)
    cells = qc[:, None, :] + offs[None]
    in_range = ((cells >= 0) & (cells < grid.dims)).all(-1)
    clipped = torch.minimum(torch.clamp(cells, min=0), grid.dims - 1)
    cids = torch.where(in_range, _pack(clipped), _SENTINEL).reshape(-1)
    start = torch.searchsorted(grid.sids, cids, right=False).reshape(b, 27)
    end = torch.searchsorted(grid.sids, cids, right=True).reshape(b, 27)
    count = end - start
    slot = torch.arange(cap, device=dev)
    pos = torch.where(count[..., None] <= cap, slot, (slot * count[..., None]) // cap)
    n = grid.sids.shape[0]
    cand = grid.order[torch.clamp(start[..., None] + pos, max=n - 1)].reshape(b, 27 * cap)
    cand_ok = (in_range[..., None] & (slot < count[..., None])).reshape(b, 27 * cap)
    diff = r_xyz[cand] - q_xyz[:, None, :]
    d2 = torch.where(cand_ok, (diff * diff).sum(-1), _INF)
    d2k, pos = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    idx = torch.gather(cand, 1, pos)
    return idx, d2k < _INF


def estimate_knn_radius(xyz: torch.Tensor, valid: torch.Tensor, k: int, *, n_sample: int = 2048,
                        quantile: float = 0.9, focus: torch.Tensor | None = None,
                        min_focus: int = 64) -> torch.Tensor:
    """Typical k-NN radius from a strided subsample (sizes the grid cell).

    Exact brute kNN of ``n_sample`` strided queries against the whole cloud,
    the ``quantile`` of the k-th neighbour distance; ``focus`` restricts the
    statistic to the points whose neighbourhoods matter, falling back to the
    global estimate below ``min_focus`` focus samples.
    """
    from triplet_match_tpu_torch.ops.knn import knn

    n = xyz.shape[0]
    step = max(-(-n // n_sample), 1)
    sub_idx = torch.arange(0, n, step, device=xyz.device)[:n_sample]
    _, d2 = knn(xyz[sub_idx], xyz, valid, k)
    dk = torch.sqrt(torch.clamp(d2[:, -1], min=0.0))
    ok = valid[sub_idx] & (d2[:, -1] < _INF)
    nan = torch.full_like(dk, float("nan"))
    r_all = torch.nanquantile(torch.where(ok, dk, nan), quantile)
    if not torch.isfinite(r_all):
        v = valid[:, None]
        box = torch.where(v, xyz, -_INF).amax(0) - torch.where(v, xyz, _INF).amin(0)
        r_all = torch.clamp(torch.linalg.vector_norm(box), min=1e-6)
    if focus is None:
        return r_all
    f = ok & focus[sub_idx]
    r_focus = torch.nanquantile(torch.where(f, dk, nan), quantile)
    if int(f.sum()) >= min_focus and torch.isfinite(r_focus):
        return r_focus
    return r_all
