"""Identity projector (``identity_traits``; counterpart of
``triplet_match_tpu.primitives.identity``): project / unproject are the
identity, tangent and normal pass through, the intrinsic distance is
Euclidean (impl/identity_traits.hpp)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class IdentityState(NamedTuple):
    pass


def fit_from_cloud(cloud, mask=None) -> IdentityState:
    return IdentityState()


def fit_from_samples(ref_state, *samples) -> tuple[IdentityState, torch.Tensor]:
    return IdentityState(), torch.tensor(True)


def project(state: IdentityState, xyz: torch.Tensor):
    return xyz, torch.ones(xyz.shape[:-1], dtype=torch.bool, device=xyz.device)


def unproject(state: IdentityState, uvw: torch.Tensor) -> torch.Tensor:
    return uvw


def tangent(state: IdentityState, xyz, tan) -> torch.Tensor:
    return tan


def normal(state: IdentityState, xyz, tan, nrm) -> torch.Tensor:
    return nrm


def intrinsic_distance(state: IdentityState, uvw0, uvw1) -> torch.Tensor:
    return torch.linalg.vector_norm(uvw1 - uvw0, dim=-1)
