"""Pose scoring against the model voxel LUT (counterpart of
``triplet_match_tpu.search.score``; ``scene::project_``, impl/scene.hpp:411-510).

Push scene points through a pose, look up the nearest model point in the voxel
LUT, gate on distance (thres = dist_thres * model resolution) and tangent/
normal kind agreement, and accumulate |ref . ref_n| orientation scores plus
correspondences.  ICP, the acceptance pass and the polish read this scorer,
and ``score_hypotheses`` ranks hypotheses through it on the voxel-LUT route
(``scorer="jnp"``, the JAX package's plain ``jnp`` scorer; no kernel).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from triplet_match_tpu_torch.index.model import CompiledModel, voxel_query, voxel_query_exact
from triplet_match_tpu_torch.parallel.mesh import psum, sharded


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


class ScoreResult(NamedTuple):
    score: torch.Tensor  # [...] float32, signed orientation score (unnormalized)
    count: torch.Tensor  # [...] int64, number of correspondences


def score_hypotheses(model: CompiledModel, scene, tangent_mask, consumed, ts, nbr_idx,
                     nbr_valid, dist_thres, *, chunk: int = 2048) -> ScoreResult:
    """Score H pose hypotheses over their neighbour sets, ``chunk`` poses at a
    time (peak memory ``chunk * K``).

    ts [H, 4, 4] scene -> model poses; nbr_idx / nbr_valid [H, K] scene-point
    neighbourhoods (the radius-search subset, impl/scene.hpp:273); dist_thres
    in multiples of the model resolution (impl/scene.hpp:413).  Returns
    ScoreResult([H] score, [H] count).
    """
    thres = float(np.float32(dist_thres) * np.float32(float(model.resolution)))
    scores, counts = [], []
    for s in range(0, ts.shape[0], chunk):
        sc, c, _, _ = _score_points(model, scene, tangent_mask, consumed, ts[s:s + chunk],
                                    nbr_idx[s:s + chunk], nbr_valid[s:s + chunk], thres)
        scores.append(sc)
        counts.append(c)
    return ScoreResult(torch.cat(scores), torch.cat(counts))


def get_bench_scorer(*, chunk: int = 8192):
    """The scoring step of the JAX package's bench and kernel parity tests:
    ``step(model, cloud, tangent_mask, consumed, ts, nbr_idx, nbr_valid,
    dist_thres)`` -> ScoreResult."""
    def step(model, cloud, tangent_mask, consumed, ts, nbr_idx, nbr_valid, dist_thres):
        return score_hypotheses(model, cloud, tangent_mask, consumed, ts, nbr_idx, nbr_valid,
                                dist_thres, chunk=chunk)

    return step


class DenseCorrs(NamedTuple):
    """Dense correspondence set of a full-cloud scoring pass."""

    model_idx: torch.Tensor  # [..., N] int64
    valid: torch.Tensor  # [..., N] bool
    score: torch.Tensor  # [...] float32 (unnormalized signed score)
    count: torch.Tensor  # [...] int64


def finish_find(model: CompiledModel, scene, tangent_mask, consumed, t, dist_thres,
                exact: bool = False, weighted_distance: bool = False,
                negative_scores: bool = False, samples_on_all: bool = True,
                group=None) -> DenseCorrs:
    """Score poses ``t`` [..., 4, 4] against ALL scene points (``scene::finish_find``,
    impl/scene.hpp:100-106); ``dist_thres`` is a float or a [...] tensor.
    ``exact=True`` takes LUT-seeded exact nearest neighbours.

    ``group``: a ``parallel.mesh.MeshAxis`` when ``scene`` is one shard of a
    scene sharded over it; the per-point outputs stay shard-local and score
    and count are summed over the shards (one collective, in float64: the
    counts stay exact)."""
    thres = torch.as_tensor(dist_thres, dtype=torch.float32, device=t.device) * model.resolution
    if thres.dim():
        thres = thres[..., None]
    score, count, ok, midx = _score_points(
        model, scene, tangent_mask, consumed, t, None, None, thres, exact=exact,
        weighted_distance=weighted_distance, negative_scores=negative_scores,
        samples_on_all=samples_on_all)
    if sharded(group):
        both = psum(torch.stack([score.double(), count.double()], -1), *group)
        score, count = both[..., 0].float(), both[..., 1].to(count.dtype)
    return DenseCorrs(model_idx=midx, valid=ok, score=score, count=count)


def normalize_score(model: CompiledModel, score):
    """score / model cloud size (impl/scene.hpp:406-409)."""
    return score / torch.clamp(model.n_all.to(torch.float32), min=1.0)
