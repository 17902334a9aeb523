"""Cylinder projector (``cylinder_traits``; counterpart of
``triplet_match_tpu.primitives.cylinder``).

The reference fits with PCL's MSAC (impl/cylinder_traits.hpp:6-51); here the
fit is a batched RANSAC: the closed-form two-point-and-normals cylinder
(impl:53-98) for many sample pairs, every hypothesis scored against every
point with the truncated squared radial residual, the best kept.  The chart
is the unrolled cylinder: u = r * theta in [0, 2 pi r), v = height along the
axis, w = radial deviation / r (impl:100-114); tangents and normals push
forward through the chart's Jacobian (impl:132-178); the intrinsic distance
wraps around u (impl:180-189).
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

_TWO_PI = 2.0 * math.pi


class CylinderState(NamedTuple):
    g2l: torch.Tensor  # [..., 4, 4] world -> cylinder frame (z = axis)
    l2g: torch.Tensor
    origin: torch.Tensor  # [..., 3] a point on the axis
    radius: torch.Tensor  # [...]
    threshold: torch.Tensor  # [...]


def _state_from_axis(origin, axis, radius, threshold) -> CylinderState:
    ref = unit_orthogonal(axis)
    g2l = frame_to_g2l(origin, ref, cross(ref, axis), axis)
    return CylinderState(g2l, invert_rigid(g2l), origin, radius, threshold)


def fit_from_samples(ref_state, p1, p2, n1, n2) -> tuple[CylinderState, torch.Tensor]:
    """Closed-form two-point-and-normals cylinder (impl/cylinder_traits.hpp:53-98):
    the axis is the closest-approach line between the two normal lines.
    Batched over leading axes.  Returns (state, plausibility), which rejects
    non-finite and degenerate solutions."""
    w = n1 + p1 - p2
    a = (n1 * n1).sum(-1)
    b = (n1 * n2).sum(-1)
    c = (n2 * n2).sum(-1)
    d = (n1 * w).sum(-1)
    e = (n2 * w).sum(-1)
    denom = a * c - b * b
    tc_deg = torch.where(b > c, d / torch.where(b == 0, 1.0, b), e / torch.where(c == 0, 1.0, c))
    safe = torch.where(denom == 0, 1.0, denom)
    sc = torch.where(denom < 1e-8, 0.0, (b * e - c * d) / safe)
    tc = torch.where(denom < 1e-8, tc_deg, (a * e - b * d) / safe)
    origin = p1 + n1 + sc[..., None] * n1
    axis = p2 + tc[..., None] * n2 - origin
    axis_norm = torch.linalg.vector_norm(axis, dim=-1)
    axis = axis / torch.clamp(axis_norm[..., None], min=1e-12)
    radius = torch.linalg.vector_norm(cross(axis, origin - p1), dim=-1)
    thr = (torch.as_tensor(ref_state.threshold, device=radius.device) if ref_state is not None
           else torch.zeros((), device=radius.device)).expand(radius.shape)
    ok = (axis_norm > 1e-8) & (radius > 1e-6) & torch.isfinite(radius)
    return _state_from_axis(origin, axis, radius, thr), ok


def _fit_from_indices(cloud, idx: torch.Tensor, mask, threshold: torch.Tensor) -> CylinderState:
    """MSAC over the hypotheses of sample pairs ``idx`` [2, H]: the state of
    least summed min(radial residual^2, threshold^2) over the masked points
    (non-plausible hypotheses cost +inf; the first of equal costs wins)."""
    p1, p2 = cloud.xyz[idx[0]], cloud.xyz[idx[1]]
    n1, n2 = cloud.normal[idx[0]], cloud.normal[idx[1]]
    eye = eye4(threshold)
    ref = CylinderState(eye, eye, threshold.new_zeros(3), threshold.new_ones(()), threshold)
    states, ok = fit_from_samples(ref, p1, p2, n1, n2)  # batched [H]

    def radial(s, e):
        loc = apply_h(states.g2l[s:e, None], cloud.xyz)  # [e - s, N, 3]
        return torch.linalg.vector_norm(loc[..., :2], dim=-1) - states.radius[s:e, None]

    best = msac_best(radial, idx.shape[1], mask, threshold, ok)
    st = CylinderState(*(a[best] for a in states))
    return st._replace(threshold=threshold.expand(st.radius.shape))


def fit_from_cloud(cloud, mask=None, *, generator: torch.Generator | None = None,
                   num_hypotheses: int = 256, threshold=None) -> CylinderState:
    """Batched-RANSAC MSAC cylinder fit (for PCL's
    MEstimatorSampleConsensus, impl/cylinder_traits.hpp:6-51), on the cloud's
    device: ``num_hypotheses`` sample pairs drawn uniformly from the masked
    points by ``generator`` (a CPU generator, default seeded with 0; the JAX
    package draws by threefry, which torch does not reproduce).  The
    threshold defaults to 5 x the cloud's resolution (impl:19)."""
    if mask is None:
        mask = cloud.valid
    idx = draw_samples(mask, 2 * num_hypotheses, generator).reshape(2, num_hypotheses)
    return _fit_from_indices(cloud, idx, mask, resolved_threshold(cloud, threshold, 5.0))


def project(state: CylinderState, xyz: torch.Tensor):
    """(uvw, valid): u = r theta, v = z, w = radial deviation / r; rejects
    |radial - r| > threshold (impl/cylinder_traits.hpp:100-114)."""
    loc = apply_h(state.g2l, xyz)
    height = torch.linalg.vector_norm(loc[..., :2], dim=-1) - state.radius
    valid = height.abs() <= state.threshold
    theta = torch.atan2(loc[..., 1], loc[..., 0])
    theta = torch.where(theta < 0, theta + _TWO_PI, theta)
    uvw = torch.stack([theta * state.radius, loc[..., 2], height / state.radius], dim=-1)
    return uvw, valid


def unproject(state: CylinderState, uvw: torch.Tensor) -> torch.Tensor:
    """(impl/cylinder_traits.hpp:116-130)."""
    r = (uvw[..., 2] + 1.0) * state.radius
    ang = uvw[..., 0] / state.radius
    loc = torch.stack([r * torch.cos(ang), r * torch.sin(ang), uvw[..., 1]], dim=-1)
    return apply_h(state.l2g, loc)


def _chart_pushforward(state: CylinderState, xyz: torch.Tensor,
                       vec: torch.Tensor) -> torch.Tensor:
    """Jacobian push-forward of a world vector at a point into uvw
    (impl/cylinder_traits.hpp:132-154)."""
    loc = apply_h(state.g2l, xyz)
    lv = normalize(rotate(state.g2l, vec))
    r = state.radius
    n = torch.linalg.vector_norm(loc[..., :2], dim=-1)
    s = n * n
    t0 = lv[..., 0] * (-r * loc[..., 1] / s) + lv[..., 1] * (r * loc[..., 0] / s)
    t2 = lv[..., 0] * loc[..., 0] / n + lv[..., 1] * loc[..., 1] / n
    return normalize(torch.stack([t0, lv[..., 2], t2], dim=-1))


def tangent(state: CylinderState, xyz, tan) -> torch.Tensor:
    return _chart_pushforward(state, xyz, tan)


def normal(state: CylinderState, xyz, tan, nrm) -> torch.Tensor:
    """Both surface tangents pushed forward, then their cross product
    (impl/cylinder_traits.hpp:156-178)."""
    t2 = normalize(cross(tan, nrm))
    return normalize(cross(_chart_pushforward(state, xyz, tan),
                           _chart_pushforward(state, xyz, t2)))


def intrinsic_distance(state: CylinderState, uvw0, uvw1) -> torch.Tensor:
    """Wrap-around chart distance (impl/cylinder_traits.hpp:180-189)."""
    d_u = (uvw1[..., 0] - uvw0[..., 0]).abs()
    d_u = torch.minimum(d_u, _TWO_PI * state.radius - d_u)
    d_v = (uvw1[..., 1] - uvw0[..., 1]).abs()
    return torch.sqrt(d_u * d_u + d_v * d_v)
