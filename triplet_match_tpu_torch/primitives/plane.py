"""Plane projectors (``plane_traits`` and ``plane2_traits``; counterpart of
``triplet_match_tpu.primitives.plane``).

State: a g2l / l2g frame pair, the origin and a height threshold.  ``plane``
projects with height rejection (|w| > threshold -> invalid) and a 3-D
intrinsic distance; ``plane2`` projects without rejection, builds
hypotheses from three points with a normal-consistency gate, and measures
2-D distances (impl/plane_traits.hpp, impl/plane2_traits.hpp).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from triplet_match_tpu_torch.core.transforms import invert_rigid, strict_fp32
from triplet_match_tpu_torch.primitives.base import (
    apply_h,
    cross,
    eye4,
    frame_to_g2l,
    normalize,
    rotate,
    unit_orthogonal,
)


class PlaneState(NamedTuple):
    g2l: torch.Tensor  # [..., 4, 4]
    l2g: torch.Tensor  # [..., 4, 4]
    origin: torch.Tensor  # [..., 3]
    threshold: torch.Tensor  # [...]


def fit_from_cloud(cloud, mask=None) -> PlaneState:
    """Eigen plane fit (impl/plane_traits.hpp:4-42): the centroid and the
    eigenvectors of the centred scatter; rows of g2l are the eigenvectors by
    descending eigenvalue (3rd row = normal); threshold = 2 * max |height|.
    The normal's sign, and the order of near-equal eigenvalues, are the
    eigen solver's, which differ between libraries."""
    if mask is None:
        mask = cloud.valid
    w = mask.to(torch.float32)
    centroid = (cloud.xyz * w[:, None]).sum(0) / torch.clamp(w.sum(), min=1.0)
    d = (cloud.xyz - centroid) * w[:, None]
    with strict_fp32():
        cov = d.T @ d
    _, vecs = torch.linalg.eigh(cov)  # ascending: vecs[:, 0] is the normal
    g2l = frame_to_g2l(centroid, vecs[:, 2], vecs[:, 1], vecs[:, 0])
    threshold = 2.0 * ((apply_h(g2l, cloud.xyz)[..., 2]).abs() * w).max()
    return PlaneState(g2l, invert_rigid(g2l), centroid, threshold)


def fit_from_samples(ref_state: PlaneState, p: torch.Tensor,
                     n: torch.Tensor) -> tuple[PlaneState, torch.Tensor]:
    """One-sample hypothesis from a point and its normal
    (impl/plane_traits.hpp:44-62)."""
    ey = unit_orthogonal(n)
    ex = normalize(cross(ey, n))
    g2l = frame_to_g2l(p, ex, ey, n)
    thr = torch.as_tensor(ref_state.threshold, device=p.device).expand(p.shape[:-1])
    state = PlaneState(g2l, invert_rigid(g2l), p, thr)
    return state, torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device)


def project(state: PlaneState, xyz: torch.Tensor, *, reject_height: bool = True):
    """(uvw, valid).  plane_traits rejects |w| > threshold
    (impl/plane_traits.hpp:64-72); plane2 does not (impl/plane2_traits.hpp:84-88)."""
    uvw = apply_h(state.g2l, xyz)
    if reject_height:
        valid = uvw[..., 2].abs() <= state.threshold
    else:
        valid = torch.ones(uvw.shape[:-1], dtype=torch.bool, device=uvw.device)
    return uvw, valid


def unproject(state: PlaneState, uvw: torch.Tensor) -> torch.Tensor:
    return apply_h(state.l2g, uvw)


def tangent(state: PlaneState, xyz, tan) -> torch.Tensor:
    """(impl/plane_traits.hpp:80-85), normalised for both plane kinds."""
    return normalize(rotate(state.g2l, tan))


def normal(state: PlaneState, xyz, tan, nrm) -> torch.Tensor:
    return normalize(rotate(state.g2l, nrm))


def intrinsic_distance(state: PlaneState, uvw0, uvw1, *, planar: bool = False) -> torch.Tensor:
    """3-D L2 for plane (impl/plane_traits.hpp:94-100); ``planar`` gives
    plane2's 2-D distance (impl/plane2_traits.hpp:111-116)."""
    d = uvw1 - uvw0
    if planar:
        d = d[..., :2]
    return torch.linalg.vector_norm(d, dim=-1)


def fit_from_samples3(ref_state: PlaneState, p1, p2, p3, n1, n2,
                      n3) -> tuple[PlaneState, torch.Tensor]:
    """plane2's three-point hypothesis, rejected if any sample normal's
    cosine to the plane normal is more than 0.1 from +-1
    (impl/plane2_traits.hpp:48-82)."""
    d1 = p2 - p1
    d2 = p3 - p1
    nrm = normalize(cross(d1, d2))
    ok = torch.ones(p1.shape[:-1], dtype=torch.bool, device=p1.device)
    for n in (n1, n2, n3):
        ok = ok & ((1.0 - (n * nrm).sum(-1).abs()) <= 0.1)
    d1p = normalize(d1 - (d1 * nrm).sum(-1, keepdim=True) * nrm)
    d2p = cross(nrm, d1p)
    g2l = frame_to_g2l(p1, d1p, d2p, nrm)
    thr = torch.as_tensor(ref_state.threshold, device=p1.device).expand(p1.shape[:-1])
    return PlaneState(g2l, invert_rigid(g2l), p1, thr), ok


def reference_state(threshold: torch.Tensor) -> PlaneState:
    """An identity-frame state carrying ``threshold`` (a hypothesis batch's
    reference)."""
    e = eye4(threshold)
    return PlaneState(e, e, torch.zeros(3, device=threshold.device), threshold)
