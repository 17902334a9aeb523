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

Each step's fit (``_fit``) is, on a CUDA tensor, one call of
``csrc/join_fit.cu`` (``JOIN_FIT`` counts them; under a sharded group its
per-pose totals are summed over the shards in one ``psum`` before the solve),
and on the CPU the plain fit ``_fit_plain`` (``weighted_kabsch`` or
``gauss_newton_pose_step`` with the polish's weights).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from triplet_match_tpu_torch.core.transforms import (
    gauss_newton_pose_step,
    transform_points,
    weighted_kabsch,
)
from triplet_match_tpu_torch.index.model import CompiledModel
from triplet_match_tpu_torch.kernels.build import LaunchCounter, load_join_fit
from triplet_match_tpu_torch.parallel.mesh import psum, sharded
from triplet_match_tpu_torch.search.score import (
    DenseCorrs,
    finish_find,
    kernel_field,
    scene_batches,
)


class IcpResult(NamedTuple):
    transform: torch.Tensor  # [F, 4, 4] scene -> model
    corrs: DenseCorrs
    iterations: torch.Tensor  # [F] int64


def _select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)


def _fit_plain(model: CompiledModel, scene, tangent_mask, t, corrs: DenseCorrs, *,
               gauss_newton: bool = False, edges_only: bool = False,
               orientation_weight: bool = False, keep: bool = False,
               group=None) -> torch.Tensor:
    """One step's fit of poses ``t`` [F, 4, 4] to their corrs, in plain
    PyTorch (any float dtype: the scene's).  Weights: ``corrs.valid``;
    under ``edges_only`` the corrs on ``tangent_mask`` (the raw-edge mask)
    alone where a pose has 12 of them, else all; under
    ``orientation_weight`` times |(R ref) . ref_n| (``tight_polish``).  The
    fit: ``weighted_kabsch``, or with ``gauss_newton`` the damped
    Gauss-Newton step at the transformed points, composed as ``upd @ t``.
    ``keep``: a pose with fewer than 3 corrs keeps its pose."""
    w = corrs.valid.to(scene.xyz.dtype)
    midx = corrs.model_idx
    if edges_only:
        we = w * tangent_mask.to(w.dtype)
        cnt_e = we.sum(-1, keepdim=True)
        if sharded(group):
            cnt_e = psum(cnt_e, *group)
        w = torch.where(cnt_e >= 12.0, we, w)
    if orientation_weight:
        ref = torch.where(tangent_mask[..., None], scene.tangent, scene.normal)
        tref = ref @ t[..., :3, :3].transpose(-1, -2)
        mtan = model.cloud.tangent[midx]
        is_tan = torch.linalg.vector_norm(mtan, dim=-1) > 0.7
        ref_n = torch.where(is_tan[..., None], mtan, model.cloud.normal[midx])
        w = w * (tref * ref_n).sum(-1).abs()
    if gauss_newton:
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
    return _select(corrs.count >= 3, t_new, t) if keep else t_new


JOIN_FIT = LaunchCounter()  # fits made by csrc/join_fit.cu, one a `_fit_cuda` call


def _fit_cuda(model: CompiledModel, scene, tangent_mask, t, corrs: DenseCorrs, *,
              gauss_newton: bool = False, edges_only: bool = False,
              orientation_weight: bool = False, keep: bool = False, group=None) -> torch.Tensor:
    """``_fit_plain`` on the card, in float64 with the pose rounded to float32
    once; float32 poses and points only (the kernel reads float32).  Poses
    ``t`` [..., 4, 4] with corrs [..., N]; the scene's fields [..., N] with
    leading dims as ``search.score.scene_batches`` takes them.  One launch;
    under a sharded ``group`` the launch stops at the per-pose totals, which
    are summed over the shards (one ``psum``) and solved by a second, the
    same on every shard."""
    lead, s_lead = scene_batches("join_fit", scene.xyz, t)
    n, dev = scene.xyz.shape[-2], t.device
    if t.dtype != torch.float32 or scene.xyz.dtype != torch.float32:
        raise ValueError(f"join_fit: float32 poses and points only, got {t.dtype} poses and "
                         f"{scene.xyz.dtype} points")
    if tuple(corrs.valid.shape) != lead + (n,):
        raise ValueError(f"join_fit: corrs {tuple(corrs.valid.shape)} for poses {lead} over "
                         f"{n} scene points")
    n_poses = math.prod(lead)
    if n_poses == 0:
        return t.clone()
    if n_poses > 65535:  # the moments kernel takes one pose per grid row
        raise ValueError(f"join_fit: {n_poses} poses in one call, at most 65535")

    def field(x, dtype, shape):
        return kernel_field("join_fit", x, dtype, shape, dev)

    def check(err):
        if err != 0:
            raise RuntimeError(f"join_fit kernel launch failed: "
                               f"{lib.join_fit_error_string(err).decode()}")

    xyz, nrm, tan = (field(v, torch.float32, s_lead + (n, 3))
                     for v in (scene.xyz, scene.normal, scene.tangent))
    tmask = field(tangent_mask, torch.bool, s_lead + (n,))
    valid = field(corrs.valid, torch.bool, lead + (n,))
    midx = field(corrs.model_idx, torch.int64, lead + (n,))
    count = field(corrs.count, torch.int64, lead) if keep else None
    mxyz, mnrm, mtan = (field(v, torch.float32, v.shape) for v in (
        model.cloud.xyz, model.cloud.normal, model.cloud.tangent))
    poses = field(t, torch.float32, t.shape)
    lib = load_join_fit()
    gn, eo = int(gauss_newton), int(edges_only)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = torch.empty(lib.join_fit_part_doubles(n, n_poses, gn, eo), dtype=torch.float64,
                       device=dev)
    tot = (torch.empty((n_poses, lib.join_fit_totals(gn, eo)), dtype=torch.float64, device=dev)
           if sharded(group) else None)
    out = torch.empty(lead + (4, 4), dtype=torch.float32, device=dev)
    check(lib.join_fit_launch(
        poses.data_ptr(), n_poses, xyz.data_ptr(), nrm.data_ptr(), tan.data_ptr(),
        tmask.data_ptr(), n, math.prod(s_lead), valid.data_ptr(), midx.data_ptr(),
        None if count is None else count.data_ptr(), mxyz.data_ptr(), mnrm.data_ptr(),
        mtan.data_ptr(), gn, eo, int(orientation_weight), part.data_ptr(),
        None if tot is None else tot.data_ptr(), out.data_ptr(), stream))
    if tot is not None:
        tot = psum(tot, *group)
        check(lib.join_fit_solve(poses.data_ptr(), n_poses,
                                 None if count is None else count.data_ptr(), gn, eo,
                                 tot.data_ptr(), out.data_ptr(), stream))
    JOIN_FIT.launches += 1
    return out


def _fit(model: CompiledModel, scene, tangent_mask, t, corrs: DenseCorrs, group=None,
         **mode) -> torch.Tensor:
    """One step's fit (``_fit_plain``'s arguments): the kernel on a CUDA
    tensor, the plain fit on the CPU."""
    if t.is_cuda:
        return _fit_cuda(model, scene, tangent_mask, t, corrs, group=group, **mode)
    return _fit_plain(model, scene, tangent_mask, t, corrs, group=group, **mode)


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
        t_new = _fit(model, scene, tangent_mask, t_best, corrs, group=group)
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
    t = t0
    floor = np.float32(2.001) * np.float32(dist_thres) / np.float32(16.0)
    for i in range(iterations):
        factor = max(np.float32(anneal) ** np.float32(i), np.float32(1.0 / 16.0))
        thres = np.float32(dist_thres) * np.float32(factor)
        corrs = finish_find(model, scene, tangent_mask, consumed, t, float(thres), exact=True,
                            weighted_distance=weighted_distance,
                            negative_scores=negative_scores, samples_on_all=samples_on_all,
                            group=group)
        t = _fit(model, scene, tangent_mask, t, corrs, group=group,
                 gauss_newton=bool(point_to_plane or (point_to_line_at_floor and thres <= floor)),
                 edges_only=edges_only, orientation_weight=orientation_weight, keep=True)
    return t
