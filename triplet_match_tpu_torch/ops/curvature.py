"""Principal curvatures (counterpart of ``triplet_match_tpu.ops.curvature``).

Mirrors ``principal_curvatures`` (impl/pointcloud.hpp:3-44): project the k-NN
neighbourhood normals onto the point's tangent plane, take the covariance of
the demeaned projections, and eigendecompose; pc_min = ev[1] / k,
pc_max = ev[2] / k.  Only the ratio pc_min / pc_max reaches the match path,
through the edge filter (impl/model.hpp:96-99, impl/scene.hpp:50).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from triplet_match_tpu_torch.ops.knn import _INF, knn


class CurvatureInfo(NamedTuple):
    pc_max_dir: torch.Tensor  # [N, 3]
    pc_min: torch.Tensor  # [N]
    pc_max: torch.Tensor  # [N]


def curvature_from_neighbors(q_normal: torch.Tensor, nbr_normals: torch.Tensor,
                             nbr_mask: torch.Tensor | None = None) -> CurvatureInfo:
    """Curvature statistics from gathered neighbourhood normals.

    q_normal [..., 3]; nbr_normals [..., K, 3]; nbr_mask optional [..., K]
    (masked slots leave the centroid, the covariance and the 1/count scale).
    """
    n = q_normal
    dots = (nbr_normals * n[..., None, :]).sum(-1)
    proj = nbr_normals - dots[..., None] * n[..., None, :]
    if nbr_mask is None:
        cnt = torch.full(proj.shape[:-2], float(proj.shape[-2]), device=proj.device)
        demean = proj - proj.mean(-2, keepdim=True)
    else:
        m = nbr_mask[..., None].to(proj.dtype)
        cnt = torch.clamp(nbr_mask.to(torch.float32).sum(-1), min=1.0)
        centroid = (proj * m).sum(-2, keepdim=True) / cnt[..., None, None]
        demean = (proj - centroid) * m
    cov = demean.transpose(-1, -2) @ demean  # raw scatter; 1/k lands on the eigenvalues
    evs, evecs = torch.linalg.eigh(cov)  # ascending
    return CurvatureInfo(pc_max_dir=evecs[..., 2], pc_min=evs[..., 1] / cnt,
                         pc_max=evs[..., 2] / cnt)


def principal_curvatures(cloud, k: int = 30) -> CurvatureInfo:
    """Per-point principal curvature info over the whole (padded) cloud."""
    idx, d2 = knn(cloud.xyz, cloud.xyz, cloud.valid, k)
    return curvature_from_neighbors(cloud.normal, cloud.normal[idx], nbr_mask=d2 < _INF)


def estimate_edge_tangents(cloud, k: int = 30, *, curvature_ratio_threshold: float = 0.2,
                           min_pc_max: float = 1e-3) -> torch.Tensor:
    """Edge tangents for clouds that lack them: ``normal x pc_max_dir`` (unit)
    where the curvature ratio marks a crease and the normal variation clears
    the ``min_pc_max`` floor, zero elsewhere (the convention of the edge
    filter, impl/model.hpp:96-99).  Returns [N, 3]."""
    curv = principal_curvatures(cloud, k=k)
    is_edge = (cloud.valid & (curvature_ratio(curv) < curvature_ratio_threshold)
               & (curv.pc_max > min_pc_max))
    t = torch.linalg.cross(cloud.normal, curv.pc_max_dir, dim=-1)
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    return torch.where(is_edge[:, None], t, torch.zeros_like(t))


def curvature_ratio(curv: CurvatureInfo) -> torch.Tensor:
    """pc_min / pc_max, +inf where pc_max is 0 (never an edge, impl/model.hpp:98)."""
    ratio = curv.pc_min / torch.clamp(curv.pc_max, min=1e-30)
    return torch.where(curv.pc_max > 0.0, ratio, torch.full_like(ratio, float("inf")))


def edge_mask(cloud, curv: CurvatureInfo, *, tangent_norm_threshold: float = 0.7,
              curvature_ratio_threshold: float = 0.2) -> torch.Tensor:
    """``tangent.norm() > 0.7 && pc_min/pc_max < 0.2`` (impl/model.hpp:96-99)."""
    tnorm = torch.linalg.vector_norm(cloud.tangent, dim=-1)
    return (cloud.valid & (tnorm > tangent_norm_threshold)
            & (curvature_ratio(curv) < curvature_ratio_threshold))
