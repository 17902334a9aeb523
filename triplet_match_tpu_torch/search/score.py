"""Pose scoring against the model voxel LUT (counterpart of
``triplet_match_tpu.search.score``; ``scene::project_``, impl/scene.hpp:411-510).

Push scene points through a pose, look up the nearest model point in the voxel
LUT, gate on distance (thres = dist_thres * model resolution) and tangent/
normal kind agreement, and accumulate |ref . ref_n| orientation scores plus
correspondences.  ICP, the acceptance pass and the polish read this scorer,
and ``score_hypotheses`` ranks hypotheses through it on the voxel-LUT route
(``scorer="jnp"``, the JAX package's plain ``jnp`` scorer; no kernel).

``finish_find``, the join's pass, runs ``_score_points`` on a CPU tensor and,
on a CUDA tensor, one launch of ``csrc/join_score.cu``, which reproduces the
plain pass's ``ok``, ``model_idx`` and count on the card bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from triplet_match_tpu_torch.index.model import CompiledModel, voxel_query, voxel_query_exact
from triplet_match_tpu_torch.kernels.build import LaunchCounter, load_join_score
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


JOIN_SCORE = LaunchCounter()  # launches of csrc/join_score.cu
_MAX_GRID_Y = 65535  # the kernel's grid takes one pose per row


class _JoinInputs(NamedTuple):
    """``finish_find``'s inputs in ``csrc/join_score.cu``'s layout: P poses
    and B scene batches of N points, contiguous; pose p scores scene batch
    p % B.  The fields keep the scene's leading dims, the poses theirs."""

    lead: tuple  # the poses' leading dims: P = prod(lead)
    batches: int  # B
    poses: torch.Tensor  # [..., 4, 4] float32, contiguous: [P, 16]
    dist_p: torch.Tensor | None  # [P] float32 per-pose dist_thres, or None: ``dist``
    dist: float  # dist_thres (a float32 value) when ``dist_p`` is None
    xyz: torch.Tensor  # [..., N, 3] float32: [B, N, 3]
    normal: torch.Tensor
    tangent: torch.Tensor
    valid: torch.Tensor  # [..., N] bool: [B, N]
    tangent_mask: torch.Tensor
    consumed: torch.Tensor


def scene_batches(kernel: str, xyz: torch.Tensor, ts: torch.Tensor) -> tuple[tuple, tuple]:
    """(the poses' leading dims, the scene's) of a join kernel's call, poses
    ``ts`` [..., 4, 4] over scene points ``xyz`` [..., N, 3]; raises unless
    the scene's leading dims are none (one scene for every pose) or the
    poses' trailing ones (per-pose sub-scenes, e.g. [F, C] under [F] poses)."""
    lead, s_lead = tuple(ts.shape[:-2]), tuple(xyz.shape[:-2])
    if len(s_lead) > len(lead) or lead[len(lead) - len(s_lead):] != s_lead:
        raise ValueError(f"{kernel}: scene batch {s_lead} is not a suffix of the poses' {lead}")
    return lead, s_lead


def kernel_field(kernel: str, x: torch.Tensor, dtype, shape: tuple, device) -> torch.Tensor:
    """``x`` as a join kernel reads it: on ``device`` (else raise), of
    ``dtype``, broadcast to ``shape`` and contiguous."""
    if x.device != device:
        raise ValueError(f"{kernel}: a field on {x.device}, the poses on {device}")
    x = x if x.dtype == dtype else x.to(dtype)
    x = x if x.shape == shape else torch.broadcast_to(x, shape)
    return x if x.is_contiguous() else x.contiguous()


def _join_inputs(scene, tangent_mask, consumed, ts, dist_thres) -> _JoinInputs:
    """``finish_find``'s inputs, checked and made contiguous.  ``ts`` [..., 4,
    4]; the scene's fields are [..., N] (with [..., N, 3] vectors) whose
    leading dims are those ``scene_batches`` takes."""
    lead, s_lead = scene_batches("join_score", scene.xyz, ts)
    n = scene.xyz.shape[-2]
    if isinstance(dist_thres, torch.Tensor):
        dist = dist_thres.to(device=ts.device, dtype=torch.float32)
        dist_p, dist_f = torch.broadcast_to(dist, lead).reshape(-1).contiguous(), 0.0
    else:
        dist_p, dist_f = None, float(np.float32(dist_thres))

    def field(x, dtype, tail=()):
        return kernel_field("join_score", x, dtype, s_lead + (n,) + tail, ts.device)

    poses = ts if ts.dtype == torch.float32 else ts.float()
    return _JoinInputs(lead, math.prod(s_lead), poses.contiguous(), dist_p, dist_f,
                       *(field(v, torch.float32, (3,)) for v in (scene.xyz, scene.normal,
                                                                 scene.tangent)),
                       *(field(v, torch.bool) for v in (scene.valid, tangent_mask, consumed)))


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 and x.is_contiguous() else x.float().contiguous()


def _score_points_cuda(model: CompiledModel, scene, tangent_mask, consumed, ts, dist_thres,
                       exact: bool, weighted_distance: bool, negative_scores: bool,
                       samples_on_all: bool, count_only: bool):
    """``finish_find``'s pass as one launch of ``csrc/join_score.cu`` (layouts
    as ``_join_inputs``).  Returns (score [...], count [...], ok [..., N] or
    None, model_idx [..., N] or None): ``ok``, ``model_idx`` and ``count``
    equal ``_score_points`` on the card bit for bit; ``score`` its sum
    reassociated."""
    inp = _join_inputs(scene, tangent_mask, consumed, ts, dist_thres)
    lead, dev, n = inp.lead, ts.device, inp.valid.shape[-1]
    n_poses = math.prod(lead)
    empty = n_poses == 0 or n == 0  # nothing to launch: no pair scores

    def out(shape, dtype):
        return (torch.zeros if empty else torch.empty)(shape, dtype=dtype, device=dev)

    score, count = out(lead, torch.float32), out(lead, torch.int64)
    ok = None if count_only else out(lead + (n,), torch.bool)
    midx = None if count_only else out(lead + (n,), torch.int64)
    if empty:
        return score, count, ok, midx
    if n_poses > _MAX_GRID_Y:
        raise ValueError(f"join_score: {n_poses} poses in one call, at most {_MAX_GRID_Y}")
    if model.lut.device != dev:
        raise ValueError(f"join_score: the model on {model.lut.device}, the poses on {dev}")
    res, mxyz, mnrm, mtan, to_voxel = (_f32(x) for x in (
        model.resolution, model.cloud.xyz, model.cloud.normal, model.cloud.tangent,
        model.to_voxel))
    lut = model.lut
    lut = lut if lut.dtype == torch.int64 and lut.is_contiguous() else lut.long().contiguous()
    lib = load_join_score()
    part = torch.empty(lib.join_score_part_floats(n, n_poses), dtype=torch.float32, device=dev)
    err = lib.join_score_launch(
        inp.poses.data_ptr(), n_poses, None if inp.dist_p is None else inp.dist_p.data_ptr(),
        ctypes.c_float(inp.dist), res.data_ptr(), inp.xyz.data_ptr(), inp.normal.data_ptr(),
        inp.tangent.data_ptr(), inp.valid.data_ptr(), inp.tangent_mask.data_ptr(),
        inp.consumed.data_ptr(), n, inp.batches, mxyz.data_ptr(), mnrm.data_ptr(),
        mtan.data_ptr(), lut.data_ptr(), *lut.shape, to_voxel.data_ptr(), int(exact),
        int(weighted_distance), int(negative_scores), int(samples_on_all),
        None if count_only else ok.data_ptr(), None if count_only else midx.data_ptr(),
        part.data_ptr(), score.data_ptr(), count.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"join_score kernel launch failed: "
                           f"{lib.join_score_error_string(err).decode()}")
    JOIN_SCORE.launches += 1
    return score, count, ok, midx


def finish_find(model: CompiledModel, scene, tangent_mask, consumed, t, dist_thres,
                exact: bool = False, weighted_distance: bool = False,
                negative_scores: bool = False, samples_on_all: bool = True,
                group=None, count_only: bool = False) -> DenseCorrs:
    """Score poses ``t`` [..., 4, 4] against ALL scene points (``scene::finish_find``,
    impl/scene.hpp:100-106); ``dist_thres`` is a float or a [...] tensor.
    ``exact=True`` takes LUT-seeded exact nearest neighbours.  The scene's
    fields are [N] (every pose scores them all) or [..., C] per-pose
    sub-scenes whose leading dims are the poses' trailing ones.

    On a CPU tensor the plain pass (``_score_points``); on a CUDA tensor one
    launch of ``csrc/join_score.cu`` (``JOIN_SCORE`` counts them), equal to
    the plain pass on the card in ``valid``, ``model_idx`` and ``count``.
    ``count_only``: ``model_idx`` and ``valid`` are None (the card writes
    neither).

    ``group``: a ``parallel.mesh.MeshAxis`` when ``scene`` is one shard of a
    scene sharded over it; the per-point outputs stay shard-local and score
    and count are summed over the shards (one collective, in float64: the
    counts stay exact)."""
    if t.is_cuda:
        score, count, ok, midx = _score_points_cuda(
            model, scene, tangent_mask, consumed, t, dist_thres, exact, weighted_distance,
            negative_scores, samples_on_all, count_only)
    else:
        thres = torch.as_tensor(dist_thres, dtype=torch.float32, device=t.device)
        thres = thres * model.resolution
        if thres.dim():
            thres = thres[..., None]
        score, count, ok, midx = _score_points(
            model, scene, tangent_mask, consumed, t, None, None, thres, exact=exact,
            weighted_distance=weighted_distance, negative_scores=negative_scores,
            samples_on_all=samples_on_all)
        if count_only:
            ok = midx = None
    if sharded(group):
        both = psum(torch.stack([score.double(), count.double()], -1), *group)
        score, count = both[..., 0].float(), both[..., 1].to(count.dtype)
    return DenseCorrs(model_idx=midx, valid=ok, score=score, count=count)


def normalize_score(model: CompiledModel, score):
    """score / model cloud size (impl/scene.hpp:406-409)."""
    return score / torch.clamp(model.n_all.to(torch.float32), min=1.0)
