"""Sphere projector: a (u, v, w) spherical chart and a batched-RANSAC fit
(counterpart of ``triplet_match_tpu.primitives.sphere``).

The cylinder_traits recipe (closed-form minimal fit from point-and-normal
samples, then batched MSAC, impl/cylinder_traits.hpp:6-51) on the one
quadric the reference's trait set lacks:

  * minimal fit: two points with normals; the centre is the midpoint of the
    closest-approach segment between the two normal lines, the radius the
    mean centre distance;
  * chart: u = r * azimuth, v = r * (polar - pi/2), w = radial deviation / r
    (the cylinder chart's convention, impl/cylinder_traits.hpp:100-114);
  * intrinsic distance: the great-circle arc between the chart directions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from triplet_match_tpu_torch.core.transforms import invert_rigid
from triplet_match_tpu_torch.primitives.base import (
    apply_h,
    cross,
    draw_samples,
    eye4,
    frame_to_g2l,
    msac_best,
    normalize,
    resolved_threshold,
    rotate,
    unit_orthogonal,
)

_TWO_PI = 6.283185307179586


class SphereState(NamedTuple):
    g2l: torch.Tensor  # [..., 4, 4] world -> sphere frame (origin = centre)
    l2g: torch.Tensor
    center: torch.Tensor  # [..., 3]
    radius: torch.Tensor  # [...]
    threshold: torch.Tensor  # [...]


def _state_from_center(center, radius, threshold, *, ez=None) -> SphereState:
    """A frame at the centre; ``ez`` picks the chart's pole (default world z)."""
    if ez is None:
        ez = torch.tensor([0.0, 0.0, 1.0], device=center.device).expand(center.shape)
    ez = normalize(ez)
    ex = unit_orthogonal(ez)
    g2l = frame_to_g2l(center, ex, cross(ez, ex), ez)
    return SphereState(g2l, invert_rigid(g2l), center, radius, threshold)


def fit_from_samples(ref_state, p1, p2, n1, n2) -> tuple[SphereState, torch.Tensor]:
    """Closed-form two-point-and-normals sphere, batched over leading axes:
    the closest-approach midpoint of the lines (p1, n1) and (p2, n2) as the
    centre, the mean point distance as the radius.  Plausibility rejects
    near-parallel normals and samples whose two radii, or whose two line
    points, disagree by more than 20 % of the radius."""
    w = p1 - p2
    a = (n1 * n1).sum(-1)
    b = (n1 * n2).sum(-1)
    c = (n2 * n2).sum(-1)
    d = (n1 * w).sum(-1)
    e = (n2 * w).sum(-1)
    denom = a * c - b * b
    safe = torch.where(denom == 0, 1.0, denom)
    sc = (b * e - c * d) / safe
    tc = (a * e - b * d) / safe
    q1 = p1 + sc[..., None] * n1
    q2 = p2 + tc[..., None] * n2
    center = 0.5 * (q1 + q2)
    r1 = torch.linalg.vector_norm(p1 - center, dim=-1)
    r2 = torch.linalg.vector_norm(p2 - center, dim=-1)
    radius = 0.5 * (r1 + r2)
    gap = torch.linalg.vector_norm(q1 - q2, dim=-1)
    thr = (torch.as_tensor(ref_state.threshold, device=radius.device) if ref_state is not None
           else torch.zeros((), device=radius.device)).expand(radius.shape)
    tol = 0.2 * torch.clamp(radius, min=1e-9)
    ok = ((denom > 1e-8) & (radius > 1e-6) & torch.isfinite(radius)
          & ((r1 - r2).abs() <= tol) & (gap <= tol))
    return _state_from_center(center, radius, thr), ok


def _fit_from_indices(cloud, idx: torch.Tensor, mask, threshold: torch.Tensor) -> SphereState:
    """MSAC over the hypotheses of sample pairs ``idx`` [2, H], as
    ``cylinder._fit_from_indices`` with the spherical residual."""
    p1, p2 = cloud.xyz[idx[0]], cloud.xyz[idx[1]]
    n1, n2 = cloud.normal[idx[0]], cloud.normal[idx[1]]
    eye = eye4(threshold)
    ref = SphereState(eye, eye, threshold.new_zeros(3), threshold.new_ones(()), threshold)
    states, ok = fit_from_samples(ref, p1, p2, n1, n2)

    def radial(s, e):
        return (torch.linalg.vector_norm(cloud.xyz - states.center[s:e, None], dim=-1)
                - states.radius[s:e, None])

    best = msac_best(radial, idx.shape[1], mask, threshold, ok)
    st = SphereState(*(a[best] for a in states))
    return st._replace(threshold=threshold.expand(st.radius.shape))


def fit_from_cloud(cloud, mask=None, *, generator: torch.Generator | None = None,
                   num_hypotheses: int = 256, threshold=None) -> SphereState:
    """Batched-RANSAC MSAC sphere fit on the cloud's device (the
    cylinder_traits recipe, impl/cylinder_traits.hpp:6-51): ``num_hypotheses``
    sample pairs drawn by ``generator`` as ``cylinder.fit_from_cloud`` does;
    the threshold defaults to 5 x the cloud's resolution."""
    if mask is None:
        mask = cloud.valid
    idx = draw_samples(mask, 2 * num_hypotheses, generator).reshape(2, num_hypotheses)
    return _fit_from_indices(cloud, idx, mask, resolved_threshold(cloud, threshold, 5.0))


def project(state: SphereState, xyz: torch.Tensor):
    """(uvw, valid): u = r azimuth, v = r (polar - pi/2), w = radial
    deviation / r; rejects |radial - r| > threshold."""
    loc = apply_h(state.g2l, xyz)
    rad = torch.linalg.vector_norm(loc, dim=-1)
    height = rad - state.radius
    valid = height.abs() <= state.threshold
    az = torch.atan2(loc[..., 1], loc[..., 0])
    az = torch.where(az < 0, az + _TWO_PI, az)
    polar = torch.arccos(torch.clamp(loc[..., 2] / torch.clamp(rad, min=1e-12), -1.0, 1.0))
    uvw = torch.stack([az * state.radius, (polar - 0.5 * math.pi) * state.radius,
                       height / state.radius], dim=-1)
    return uvw, valid


def unproject(state: SphereState, uvw: torch.Tensor) -> torch.Tensor:
    r = (uvw[..., 2] + 1.0) * state.radius
    az = uvw[..., 0] / state.radius
    polar = uvw[..., 1] / state.radius + 0.5 * math.pi
    sp = torch.sin(polar)
    loc = torch.stack([r * sp * torch.cos(az), r * sp * torch.sin(az), r * torch.cos(polar)],
                      dim=-1)
    return apply_h(state.l2g, loc)


def _chart_pushforward(state: SphereState, xyz: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Analytic Jacobian push-forward of a world vector at a point into uvw
    (the cylinder pattern, impl/cylinder_traits.hpp:132-154)."""
    loc = apply_h(state.g2l, xyz)
    lv = normalize(rotate(state.g2l, vec))
    r = state.radius
    x, y, z = loc[..., 0], loc[..., 1], loc[..., 2]
    s2 = torch.clamp(x * x + y * y, min=1e-18)  # squared distance to the pole axis
    rad = torch.clamp(torch.linalg.vector_norm(loc, dim=-1), min=1e-12)
    # du = r d(atan2(y, x)); dv = r d(acos(z / |p|)); dw = d(|p|) / r
    t0 = r * (lv[..., 1] * x - lv[..., 0] * y) / s2
    dzn = lv[..., 2] / rad - z * (lv * loc).sum(-1) / (rad ** 3)
    t1 = r * (-dzn) / torch.clamp(
        torch.sqrt(1.0 - torch.clamp((z / rad) ** 2, 0.0, 1.0 - 1e-12)), min=1e-9)
    t2 = (lv * loc).sum(-1) / rad
    return normalize(torch.stack([t0, t1, t2], dim=-1))


def tangent(state: SphereState, xyz, tan) -> torch.Tensor:
    return _chart_pushforward(state, xyz, tan)


def normal(state: SphereState, xyz, tan, nrm) -> torch.Tensor:
    """The cross product of two pushed-forward surface tangents (the cylinder
    normal recipe, impl/cylinder_traits.hpp:156-178)."""
    t2 = normalize(cross(tan, nrm))
    return normalize(cross(_chart_pushforward(state, xyz, tan),
                           _chart_pushforward(state, xyz, t2)))


def intrinsic_distance(state: SphereState, uvw0, uvw1) -> torch.Tensor:
    """Great-circle distance between the chart directions."""
    def direction(uvw):
        az = uvw[..., 0] / state.radius
        polar = uvw[..., 1] / state.radius + 0.5 * math.pi
        sp = torch.sin(polar)
        return torch.stack([sp * torch.cos(az), sp * torch.sin(az), torch.cos(polar)], dim=-1)

    cosang = torch.clamp((direction(uvw0) * direction(uvw1)).sum(-1), -1.0, 1.0)
    return state.radius * torch.arccos(cosang)
