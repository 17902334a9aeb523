"""Pair-feature descriptor (counterpart of ``triplet_match_tpu.features.pairfeat``).

Mirrors ``feature()`` (impl/feature.hpp:15-34):

  f0 = ||p1 - p0||
  f1 = angle(d, tangent0)   with angle(a,b) = atan2(||a x b||, |a . b|)
  f2 = angle(d, tangent1)
  f3 = f0                   (the curvature-ratio slot is commented out
                             upstream, impl/feature.hpp:31 — kept so the
                             discretized keys match)
"""

from __future__ import annotations

import math

import torch


def unsigned_angle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """atan2(||a x b||, |a . b|) along the last axis (impl/feature.hpp:5-8)."""
    cross = torch.linalg.cross(a, b, dim=-1)
    return torch.atan2(torch.linalg.vector_norm(cross, dim=-1), (a * b).sum(-1).abs())


def pair_feature(p0, p1, t0, t1) -> torch.Tensor:
    """Batched pair feature [..., 4] from endpoint positions and tangents."""
    d = p1 - p0
    f0 = torch.linalg.vector_norm(d, dim=-1)
    return torch.stack([f0, unsigned_angle(d, t0), unsigned_angle(d, t1), f0], dim=-1)


def feature_valid(f: torch.Tensor, bounds_min: torch.Tensor, bounds_max: torch.Tensor) -> torch.Tensor:
    """Distance within [min0, max0] and both angles in [0, pi] (impl/feature.hpp:48-88)."""
    pi = math.pi
    dist_ok = (f[..., 0] >= bounds_min[0]) & (f[..., 0] <= bounds_max[0])
    ang_ok = (f[..., 1] >= 0.0) & (f[..., 1] <= pi) & (f[..., 2] >= 0.0) & (f[..., 2] <= pi)
    return dist_ok & ang_ok


def valid_bounds(bounds_min, bounds_max, min_rel_dist: float = 0.0, max_rel_dist: float = 1.0):
    """Rescale the distance dims of the bounds (impl/feature.hpp:90-114).

    The live call's (0, 1) arguments make this the identity.
    """
    bmin = bounds_min.clone()
    bmax = bounds_max.clone()
    diag = bounds_max - bounds_min
    for i in (0, 3):
        bmin[i] = bounds_min[i] + min_rel_dist * diag[i]
        bmax[i] = bounds_min[i] + max_rel_dist * diag[i]
    return bmin, bmax


def pair_gates(p0, p1, t0, lower, upper, parallel_eps: float = 0.01) -> torch.Tensor:
    """Distance band + tangent-parallel rejection (impl/model.hpp:107-111,
    impl/scene.hpp:293-297): reject if dist is outside [lower, upper] or
    1 - |d_hat . t0| < eps."""
    d = p1 - p0
    dist = torch.linalg.vector_norm(d, dim=-1)
    dhat = d / torch.clamp(dist, min=1e-30)[..., None]
    in_band = (dist >= lower) & (dist <= upper)
    not_parallel = (1.0 - (dhat * t0).sum(-1).abs()) >= parallel_eps
    return in_band & not_parallel
