"""Batched point-sphere visibility verification (counterpart of
``triplet_match_tpu.verify.raycast``, the OptiX raycaster analog).

For every model point a ray goes from a camera ``origin`` to the
pose-transformed point; the point is visible iff no occluder sphere (the
transformed model points and the scene points, radius ``point_radius``) is
hit strictly in front of it, with ``depth_tolerance`` slack
(RayCaster.cu:30-110, include/raycaster:18-21).  The ray-sphere tests are a
tiled product, lambda[i, j] = (occ_j - origin) . dir_i, in true float32
(``strict_fp32``), with the perpendicular-distance and depth gates
elementwise and visibility a row reduction.  Plain PyTorch on the tensors'
device: the JAX package computes this outside any Pallas kernel.

The reference's usage (disabled at impl/scene.hpp:173-187) ORs visibility
over several origins and divides by the visible count (:func:`cast_score`,
:func:`cast_score_matched`).
"""

from __future__ import annotations

import numpy as np
import torch

from triplet_match_tpu_torch.core.transforms import strict_fp32


def _visible_against(targets, t_lambda, dirs, origin, occ, occ_valid, point_radius: float,
                     depth_tolerance: float, block: int = 4096) -> torch.Tensor:
    """Any-hit accumulation of occluders ``occ`` [N, 3] against every ray
    (``targets`` / ``dirs`` [M, 3], ``t_lambda`` [M]), ``block`` occluder
    columns at a time.  Returns [M] bool, True where an occluder blocks the
    ray."""
    hit = torch.zeros(targets.shape[0], dtype=torch.bool, device=targets.device)
    r2 = float(np.float32(point_radius) ** 2)
    far = t_lambda[:, None] - float(np.float32(depth_tolerance))
    dx, dy, dz = (dirs[:, i, None] for i in range(3))
    for s in range(0, occ.shape[0], block):
        rel = occ[s:s + block] - origin  # [B, 3]
        lam = dirs @ rel.T  # [M, B]
        # perpendicular distance through the cross product |rel x dir|^2: the
        # |rel|^2 - lam^2 form cancels in float32 for occluders far from the
        # origin (|rel|^2 ~ 1e2 carries ~1e-5 of error, the size of r^2 for
        # millimetre radii), while each cross component differences products
        # of mixed magnitude (error ~ |rel| * eps)
        rx, ry, rz = (rel[None, :, i] for i in range(3))
        c0 = dy * rz - dz * ry
        c1 = dz * rx - dx * rz
        c2 = dx * ry - dy * rx
        d2 = c0 * c0 + c1 * c1 + c2 * c2
        blocked = ((lam > 0.0)  # RayCaster.cu:58 (hitLambda < 0 -> miss)
                   & (d2 <= r2)  # RayCaster.cu:62
                   & (lam < far)  # RayCaster.cu:67
                   & occ_valid[None, s:s + block])
        hit |= blocked.any(1)
    return hit


def _ray_bundle(origin, model_xyz, transform):
    """Transformed targets, their distances and unit ray directions for one
    origin."""
    targets = model_xyz @ transform[:3, :3].T + transform[:3, 3]
    delta = targets - origin
    t_lambda = torch.linalg.vector_norm(delta, dim=-1)
    dirs = delta / torch.clamp(t_lambda[:, None], min=1e-12)
    return targets, t_lambda, dirs


def _cone_keep_mask(origin, targets, t_lambda, dirs, model_valid, scene_xyz, scene_valid,
                    point_radius: float) -> torch.Tensor:
    """Conservative occluder cull for the ray bundle origin -> targets.

    All rays share one origin, so the bundle lies inside a cone: axis = the
    normalised mean direction, half-angle alpha = the widest valid ray.  An
    occluder sphere (centre o, radius r) can block some ray only if

      * angle(o - origin, axis) <= alpha + asin(min(r / |o - origin|, 1)), and
      * |o - origin|^2 <= max t_lambda^2 + r^2 (a hit needs lambda < t_lambda
        and perp^2 <= r^2).

    Both are necessary conditions, so a cast over the survivors returns the
    same mask as one over every occluder.  Returns [N] bool."""
    axis = torch.where(model_valid[:, None], dirs, 0.0).sum(0)
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis), min=1e-12)
    cos_r = torch.where(model_valid, dirs @ axis, 1.0)
    alpha = torch.arccos(torch.clamp(cos_r.min(), -1.0, 1.0))
    t_max = torch.where(model_valid, t_lambda, 0.0).max()
    r = float(np.float32(point_radius))
    rel = scene_xyz - origin
    dist2 = (rel * rel).sum(-1)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-24))
    beta = torch.arcsin(torch.clamp(r / dist, 0.0, 1.0))
    cos_gate = torch.cos(torch.clamp(alpha + beta, max=float(np.float32(np.pi))))
    cos_o = (rel @ axis) / dist
    return scene_valid & (cos_o >= cos_gate) & (dist2 <= t_max * t_max + r * r)


def cast_visibility(origin, model_xyz: torch.Tensor, model_valid: torch.Tensor,
                    transform: torch.Tensor, scene_xyz: torch.Tensor, scene_valid: torch.Tensor,
                    point_radius: float, depth_tolerance: float, *, block: int = 4096,
                    prune: bool = True, stats: dict | None = None) -> torch.Tensor:
    """Visibility mask of the transformed model points from one origin
    (``raycaster::cast``, include/raycaster:18-21): [M] bool, True = visible.
    Occluders are the transformed model points themselves (self-occlusion)
    and the scene points.  Runs on the model tensors' device.

    ``prune`` first culls scene occluders with the cone-and-range test
    (:func:`_cone_keep_mask`, the OptiX BVH's broad phase) and sweeps only
    the survivors, compacted with ``torch.nonzero`` (one host sync, as the
    JAX package's survivor count is); the mask is the brute sweep's.  With
    ``stats`` the survivor count is appended to ``stats["survivors"]``."""
    dev = model_xyz.device
    origin = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    with strict_fp32():
        targets, t_lambda, dirs = _ray_bundle(origin, model_xyz, transform.to(dev))
        hit = _visible_against(targets, t_lambda, dirs, origin, targets, model_valid,
                               point_radius, depth_tolerance,
                               block=min(block, max(targets.shape[0], 1)))
        occ, occ_valid = scene_xyz, scene_valid
        if prune:
            keep = _cone_keep_mask(origin, targets, t_lambda, dirs, model_valid, scene_xyz,
                                   scene_valid, point_radius)
            occ = scene_xyz[torch.nonzero(keep)[:, 0]]
            occ_valid = torch.ones(occ.shape[0], dtype=torch.bool, device=dev)
            if stats is not None:
                stats.setdefault("survivors", []).append(int(occ.shape[0]))
        hit |= _visible_against(targets, t_lambda, dirs, origin, occ, occ_valid, point_radius,
                                depth_tolerance, block=block)
    return model_valid & ~hit


def cast_visibility_multi(origins, model_xyz, model_valid, transform, scene_xyz, scene_valid,
                          point_radius: float, depth_tolerance: float, *, block: int = 4096,
                          prune: bool = True, stats: dict | None = None) -> torch.Tensor:
    """OR of visibility over several origins (impl/scene.hpp:175-179).  The
    origins iterate on the host, each cast with its own cull."""
    origins = np.asarray(origins, np.float32).reshape(-1, 3)
    if origins.shape[0] == 0:
        raise ValueError("cast_visibility_multi needs at least one origin; pass "
                         "raycast_origins=None to skip verification entirely")
    vis = None
    for o in origins:
        v = cast_visibility(o, model_xyz, model_valid, transform, scene_xyz, scene_valid,
                            point_radius, depth_tolerance, block=block, prune=prune, stats=stats)
        vis = v if vis is None else vis | v
    return vis


def cast_score(visible: torch.Tensor, corr_count) -> torch.Tensor:
    """matched / possible given a visibility mask (impl/scene.hpp:180-186),
    the reference's raw formula: the numerator is a scene correspondence
    count, so the ratio can exceed 1.  Verification uses
    :func:`cast_score_matched`."""
    possible = visible.sum().to(torch.float32)
    if float(possible) <= 0.0:
        return torch.zeros((), dtype=torch.float32, device=visible.device)
    return torch.as_tensor(corr_count, dtype=torch.float32, device=visible.device) / possible


def cast_score_matched(visible: torch.Tensor, model_corrs) -> torch.Tensor:
    """Fraction of the visible model points that found a correspondence, at
    most 1 by construction (``model_corrs``: matched model indices, repeats
    allowed)."""
    matched = torch.zeros_like(visible)
    matched[torch.as_tensor(model_corrs, dtype=torch.long, device=visible.device)] = True
    num = (matched & visible).sum().to(torch.float32)
    possible = visible.sum().to(torch.float32)
    if float(possible) <= 0.0:
        return torch.zeros((), dtype=torch.float32, device=visible.device)
    return num / possible
