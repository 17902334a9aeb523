"""Batched correspondence ICP (counterpart of ``triplet_match_tpu.refine.icp``;
``scene::icp_``, impl/scene.hpp:369-404).

Poses refine together along a leading batch dim: each pose runs the
reference's loop — score at the relaxed gate (2 x dist_thres), Kabsch fit of
the correspondences, rescore, iterate while the count does not shrink — and
stops on its own; a finished pose keeps its state while the others go on.

The scene is one shared cloud ([N] fields, every pose scores all of it) or a
batch of per-pose sub-clouds ([F, C] fields, the candidate-subset join).
Under a mesh the scene is one shard of a scene sharded over ``group`` (a
``parallel.mesh.MeshAxis``): every count, score and fit is summed over the
shards, so each loop's stopping test reads the same value on every shard.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from triplet_match_tpu_torch.core.transforms import (
    gauss_newton_pose_step,
    transform_points,
    weighted_kabsch,
)
from triplet_match_tpu_torch.index.model import CompiledModel
from triplet_match_tpu_torch.parallel.mesh import psum, sharded
from triplet_match_tpu_torch.search.score import DenseCorrs, finish_find


class IcpResult(NamedTuple):
    transform: torch.Tensor  # [F, 4, 4] scene -> model
    corrs: DenseCorrs
    iterations: torch.Tensor  # [F] int64


def _select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)


def icp_refine(model: CompiledModel, scene, tangent_mask, consumed, t0: torch.Tensor,
               dist_thres, max_iterations: int, tight_iterations: int = 2,
               weighted_distance: bool = False, negative_scores: bool = False,
               point_to_plane: bool = False, samples_on_all: bool = True,
               group=None) -> IcpResult:
    """Refine poses ``t0`` [F, 4, 4].

    After the relaxed loop, ``tight_iterations`` extra steps run at the
    unrelaxed gate (``tight_polish``, Gauss-Newton with ``point_to_plane``)
    and the correspondences are re-derived at the relaxed gate.
    """
    relaxed = 2.0 * dist_thres

    def _ff(t, thres):
        return finish_find(model, scene, tangent_mask, consumed, t, thres,
                           weighted_distance=weighted_distance,
                           negative_scores=negative_scores, samples_on_all=samples_on_all,
                           group=group)

    f = t0.shape[0]
    if max_iterations == 0:
        # impl/scene.hpp:371: the match returns untouched, corrs at the unrelaxed gate
        return IcpResult(t0, _ff(t0, dist_thres), torch.zeros(f, dtype=torch.int64, device=t0.device))

    t_best, corrs = t0, _ff(t0, relaxed)
    it = torch.zeros(f, dtype=torch.int64, device=t0.device)
    done = corrs.count < 3  # impl/scene.hpp:381
    for _ in range(max_iterations):
        active = ~done & (it < max_iterations)
        if not bool(active.any()):
            break
        t_new = weighted_kabsch(scene.xyz, model.cloud.xyz[corrs.model_idx],
                                corrs.valid.to(torch.float32), group=group)
        proj = _ff(t_new, relaxed)
        improved = proj.count >= corrs.count  # a strict shrink stops (impl/scene.hpp:396)
        take = active & improved
        t_best = _select(take, t_new, t_best)
        corrs = DenseCorrs(*(_select(take, a, b) for a, b in zip(proj, corrs)))
        it = it + active.to(torch.int64)
        done = done | (active & ~improved)

    if tight_iterations > 0:
        t_best = tight_polish(model, scene, tangent_mask, consumed, t_best, dist_thres,
                              tight_iterations, weighted_distance=weighted_distance,
                              negative_scores=negative_scores, point_to_plane=point_to_plane,
                              samples_on_all=samples_on_all, group=group)
        corrs = _ff(t_best, relaxed)
    return IcpResult(t_best, corrs, it)


def tight_polish(model: CompiledModel, scene, tangent_mask, consumed, t0: torch.Tensor,
                 dist_thres, iterations: int = 2, weighted_distance: bool = False,
                 negative_scores: bool = False, point_to_plane: bool = False,
                 samples_on_all: bool = True, orientation_weight: bool = False,
                 anneal: float = 1.0, edges_only: bool = False,
                 point_to_line_at_floor: bool = False, group=None) -> torch.Tensor:
    """Fitting steps at the unrelaxed gate with exact (LUT-seeded) corrs.

    Step i runs at dist_thres * max(anneal**i, 1/16); ``orientation_weight``
    weights each corr by |scene_dir . model_dir| (impl/scene.hpp:430).
    ``edges_only`` replaces the tangent mask with the raw ``|tangent| > 0.7``
    mask for the whole polish and fits each step on edge corrs, falling back
    to all-point weights below 12 of them.  ``point_to_plane`` fits every
    step, and ``point_to_line_at_floor`` the steps whose band is within 2x of
    the 1/16 floor, with the hybrid Gauss-Newton step
    (``gauss_newton_pose_step``), composed as ``upd @ t``.  A step with fewer
    than 3 corrs keeps the pose.  Changes only the reported transform, never
    which matches are accepted.  t0 [F, 4, 4] -> [F, 4, 4].  ``group``: as in
    ``icp_refine``.
    """
    if edges_only:
        tangent_mask = torch.linalg.vector_norm(scene.tangent, dim=-1) > 0.7
        raw_edges = tangent_mask.to(torch.float32)
    t = t0
    floor = np.float32(2.001) * np.float32(dist_thres) / np.float32(16.0)
    for i in range(iterations):
        factor = max(np.float32(anneal) ** np.float32(i), np.float32(1.0 / 16.0))
        thres = np.float32(dist_thres) * np.float32(factor)
        corrs = finish_find(model, scene, tangent_mask, consumed, t, float(thres), exact=True,
                            weighted_distance=weighted_distance,
                            negative_scores=negative_scores, samples_on_all=samples_on_all,
                            group=group)
        w = corrs.valid.to(torch.float32)
        if edges_only:
            we = w * raw_edges
            cnt_e = we.sum(-1, keepdim=True)
            if sharded(group):
                cnt_e = psum(cnt_e, *group)
            w = torch.where(cnt_e >= 12.0, we, w)
        midx = corrs.model_idx
        if orientation_weight:
            ref = torch.where(tangent_mask[..., None], scene.tangent, scene.normal)
            tref = ref @ t[..., :3, :3].transpose(-1, -2)
            mtan = model.cloud.tangent[midx]
            is_tan = torch.linalg.vector_norm(mtan, dim=-1) > 0.7
            ref_n = torch.where(is_tan[..., None], mtan, model.cloud.normal[midx])
            w = w * (tref * ref_n).sum(-1).abs()
        if point_to_plane or (point_to_line_at_floor and thres <= floor):
            mtan = model.cloud.tangent[midx]
            is_edge = torch.linalg.vector_norm(mtan, dim=-1) > 0.7
            m_dir = torch.where(is_edge[..., None], mtan, model.cloud.normal[midx])
            m_dir = m_dir / torch.clamp(torch.linalg.vector_norm(m_dir, dim=-1, keepdim=True),
                                        min=1e-12)
            upd = gauss_newton_pose_step(transform_points(t, scene.xyz), model.cloud.xyz[midx],
                                         m_dir, is_edge, w, group=group)
            t_new = upd @ t
        else:
            t_new = weighted_kabsch(scene.xyz, model.cloud.xyz[midx], w, group=group)
        t = _select(corrs.count >= 3, t_new, t)
    return t
