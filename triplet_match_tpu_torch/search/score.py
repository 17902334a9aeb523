"""Pose scoring against the model voxel LUT (counterpart of
``triplet_match_tpu.search.score``; ``scene::project_``, impl/scene.hpp:411-510).

Push scene points through a pose, look up the nearest model point in the voxel
LUT, gate on distance (thres = dist_thres * model resolution) and tangent/
normal kind agreement, and accumulate |ref . ref_n| orientation scores plus
correspondences.  ICP, the acceptance pass and the polish read this scorer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from triplet_match_tpu_torch.index.model import CompiledModel, voxel_query, voxel_query_exact


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


def _score_points(model: CompiledModel, scene, tangent_mask, consumed, ts, idx, idx_valid,
                  thres, exact: bool = False, weighted_distance: bool = False,
                  negative_scores: bool = False, samples_on_all: bool = True):
    """Score gathered scene points under poses.

    ts [..., 4, 4]; idx / idx_valid [..., K] (``idx=None`` scores every scene
    point, broadcast against the poses' leading dims).  Returns (score [...],
    count [...], ok [..., K], model_idx [..., K]).  ``weighted_distance``
    applies exp(-d^2 / (2 thres)) (impl/scene.hpp:430,468 — thres, not
    thres^2, as upstream); ``negative_scores`` subtracts the weight of
    kind-mismatched corrs (impl/scene.hpp:473-475); ``samples_on_all=False``
    keeps only tangent-bearing points (impl/scene.hpp:534-536).
    """
    def g(a):
        return a if idx is None else a[idx]

    r = ts[..., :3, :3]
    pos = g(scene.xyz)
    tpos = pos @ r.transpose(-1, -2) + ts[..., None, :3, 3]
    midx, inb = (voxel_query_exact if exact else voxel_query)(model, tpos)
    dist = _norm(tpos - model.cloud.xyz[midx])

    use_tangent = g(tangent_mask)
    ref = torch.where(use_tangent[..., None], g(scene.tangent), g(scene.normal))
    tref = ref @ r.transpose(-1, -2)
    mtan = model.cloud.tangent[midx]
    is_tangent = _norm(mtan) > 0.7
    ref_n = torch.where(is_tangent[..., None], mtan, model.cloud.normal[midx])

    eligible = g(scene.valid) & ~g(consumed) & inb & (dist <= thres)
    if idx_valid is not None:
        eligible = eligible & idx_valid
    if not samples_on_all:
        eligible = eligible & (_norm(g(scene.tangent)) > 0.7)
    kind_ok = use_tangent == is_tangent
    ok = eligible & kind_ok
    weight = torch.exp(-dist * dist / (2.0 * thres)) if weighted_distance else torch.ones_like(dist)
    w = weight * (tref * ref_n).sum(-1).abs()
    score = torch.where(ok, w, 0.0).sum(-1)
    if negative_scores:
        score = score - torch.where(eligible & ~kind_ok, weight, 0.0).sum(-1)
    return score, ok.sum(-1), ok, midx


class DenseCorrs(NamedTuple):
    """Dense correspondence set of a full-cloud scoring pass."""

    model_idx: torch.Tensor  # [..., N] int64
    valid: torch.Tensor  # [..., N] bool
    score: torch.Tensor  # [...] float32 (unnormalized signed score)
    count: torch.Tensor  # [...] int64


def finish_find(model: CompiledModel, scene, tangent_mask, consumed, t, dist_thres,
                exact: bool = False, weighted_distance: bool = False,
                negative_scores: bool = False, samples_on_all: bool = True) -> DenseCorrs:
    """Score poses ``t`` [..., 4, 4] against ALL scene points (``scene::finish_find``,
    impl/scene.hpp:100-106); ``dist_thres`` is a float or a [...] tensor.
    ``exact=True`` takes LUT-seeded exact nearest neighbours."""
    thres = torch.as_tensor(dist_thres, dtype=torch.float32, device=t.device) * model.resolution
    if thres.dim():
        thres = thres[..., None]
    score, count, ok, midx = _score_points(
        model, scene, tangent_mask, consumed, t, None, None, thres, exact=exact,
        weighted_distance=weighted_distance, negative_scores=negative_scores,
        samples_on_all=samples_on_all)
    return DenseCorrs(model_idx=midx, valid=ok, score=score, count=count)


def normalize_score(model: CompiledModel, score):
    """score / model cloud size (impl/scene.hpp:406-409)."""
    return score / torch.clamp(model.n_all.to(torch.float32), min=1.0)
