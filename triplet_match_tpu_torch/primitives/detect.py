"""Primitive detection: batched-RANSAC plane, cylinder and sphere extraction
(counterpart of ``triplet_match_tpu.primitives.detect``).

The acceptance configs (BASELINE.json 1-2) detect planes and cylinders.
The reference delegates cylinder fitting to PCL MSAC
(impl/cylinder_traits.hpp:6-51) and wires no detection loop; here detection
is a batched op on the cloud's device: minimal-sample hypotheses, one MSAC
pass over every point (in chunks of hypotheses), the argmin, then an inlier
mask.  The hypotheses' samples are drawn uniformly from the masked points
by a CPU ``torch.Generator`` (default seeded with 0); the JAX package draws
them by threefry, which torch does not reproduce, so each detector has a
private entry (``_detect_plane``, ``_detect_cylinder``, ``_detect_sphere``)
that takes the sample indices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from triplet_match_tpu_torch.primitives import cylinder as cyl
from triplet_match_tpu_torch.primitives import plane as pln
from triplet_match_tpu_torch.primitives import sphere as sph
from triplet_match_tpu_torch.primitives.base import (
    apply_h,
    draw_samples,
    msac_best,
    resolved_threshold,
)

class PlaneDetection(NamedTuple):
    state: pln.PlaneState
    inliers: torch.Tensor  # [N] bool


class CylinderDetection(NamedTuple):
    state: cyl.CylinderState
    inliers: torch.Tensor  # [N] bool


class SphereDetection(NamedTuple):
    state: sph.SphereState
    inliers: torch.Tensor  # [N] bool


def _detect_plane(cloud, idx: torch.Tensor, mask, threshold: torch.Tensor) -> PlaneDetection:
    """Plane detection from the point-and-normal hypotheses at ``idx`` [H]:
    the least summed min(height^2, threshold^2) over the masked points, then
    its inliers (|height| <= threshold)."""
    states, _ = pln.fit_from_samples(pln.reference_state(threshold), cloud.xyz[idx],
                                     cloud.normal[idx])

    def height(s, e):
        row = states.g2l[s:e, 2]  # the height row of each frame
        return (row[:, None, :3] * cloud.xyz).sum(-1) + row[:, 3:]

    best = msac_best(height, idx.shape[0], mask, threshold)
    state = pln.PlaneState(*(a[best] for a in states))
    h = apply_h(state.g2l, cloud.xyz)[..., 2]
    return PlaneDetection(state, mask & (h.abs() <= threshold))


def detect_plane(cloud, mask=None, *, generator: torch.Generator | None = None,
                 num_hypotheses: int = 256, threshold=None) -> PlaneDetection:
    """RANSAC plane detection from one-point-and-normal hypotheses
    (plane_traits' init_from_samples, impl/plane_traits.hpp:44-62); the
    threshold defaults to 3 x the cloud's resolution."""
    if mask is None:
        mask = cloud.valid
    return _detect_plane(cloud, draw_samples(mask, num_hypotheses, generator), mask,
                         resolved_threshold(cloud, threshold, 3.0))


def _detect_cylinder(cloud, idx: torch.Tensor, mask, threshold: torch.Tensor) -> CylinderDetection:
    """Cylinder detection from the sample pairs ``idx`` [2, H]."""
    state = cyl._fit_from_indices(cloud, idx, mask, threshold)
    loc = apply_h(state.g2l, cloud.xyz)
    radial = (torch.linalg.vector_norm(loc[..., :2], dim=-1) - state.radius).abs()
    return CylinderDetection(state, mask & (radial <= state.threshold))


def detect_cylinder(cloud, mask=None, *, generator: torch.Generator | None = None,
                    num_hypotheses: int = 256, threshold=None) -> CylinderDetection:
    """RANSAC cylinder detection (for PCL's MSAC): ``cylinder.fit_from_cloud``
    and the points within the threshold of its surface."""
    if mask is None:
        mask = cloud.valid
    idx = draw_samples(mask, 2 * num_hypotheses, generator).reshape(2, num_hypotheses)
    return _detect_cylinder(cloud, idx, mask, resolved_threshold(cloud, threshold, 5.0))


def _detect_sphere(cloud, idx: torch.Tensor, mask, threshold: torch.Tensor) -> SphereDetection:
    """Sphere detection from the sample pairs ``idx`` [2, H]."""
    state = sph._fit_from_indices(cloud, idx, mask, threshold)
    radial = (torch.linalg.vector_norm(cloud.xyz - state.center, dim=-1) - state.radius).abs()
    return SphereDetection(state, mask & (radial <= state.threshold))


def detect_sphere(cloud, mask=None, *, generator: torch.Generator | None = None,
                  num_hypotheses: int = 256, threshold=None) -> SphereDetection:
    """RANSAC sphere detection from two-point-and-normal hypotheses
    (``sphere.fit_from_cloud``) and its inliers."""
    if mask is None:
        mask = cloud.valid
    idx = draw_samples(mask, 2 * num_hypotheses, generator).reshape(2, num_hypotheses)
    return _detect_sphere(cloud, idx, mask, resolved_threshold(cloud, threshold, 5.0))
