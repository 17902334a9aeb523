"""Multi-instance search driver (counterpart of ``triplet_match_tpu.search.driver``).

Mirrors the control flow of impl/scene.hpp:39-240:

  prepare scene (curvature -> edge mask)                 impl/scene.hpp:41-58
  WHILE matches found:                                   impl/scene.hpp:70-95
    sample first/second pairs, query model,              impl/scene.hpp:242-353
    pose hypotheses (base_transform) + force_up gate,    impl/scene.hpp:315-319
    rank hypotheses (score_kernel.rank_groups),          impl/scene.hpp:326
    promote finalists (prescreen) -> ICP,                impl/scene.hpp:361-366,171
    sort by corr count, greedy non-overlap acceptance,   impl/scene.hpp:193-237
    mask accepted scene points.                          impl/scene.hpp:87-93

Each round scores a whole hypothesis batch ([B1, B2, Q] poses) at once; the
only sequential state is the mask update between rounds.  A dense scene
switches to the fog-density route (``fog_policy``): exact ranking, a wider
funnel with a prescreen, edge-anchored ranking and polish, and a join over
per-finalist candidate subsets.  Under a ``mesh=`` (a ``DeviceMesh``, one
process per rank) the rounds run hypothesis-parallel (``parallel/search.py``)
or with the scene sharded as well (``parallel/search2d.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from triplet_match_tpu_torch.config import (
    DEFAULT_DISCRETIZATION,
    DEFAULT_POLICY,
    DEFAULT_SAMPLE_PARAMS,
    DiscretizationParams,
    SampleParams,
    SearchPolicy,
)
from triplet_match_tpu_torch.core import cloud as cl
from triplet_match_tpu_torch.core.transforms import base_transform, invert_rigid, strict_fp32
from triplet_match_tpu_torch.features import pairfeat as pf
from triplet_match_tpu_torch.index.model import CompiledModel, query_pairs
from triplet_match_tpu_torch.ops.curvature import (
    curvature_from_neighbors,
    curvature_ratio,
    edge_mask as edge_mask_op,
    principal_curvatures,
)
from triplet_match_tpu_torch.ops.knn import radius_sample
from triplet_match_tpu_torch.parallel.mesh import (
    all_gather,
    broadcast_first,
    check_mesh,
    flat_rank,
    group_extent,
    pmax,
    psum,
    sharded,
)
from triplet_match_tpu_torch.refine.icp import JOIN_FIT, icp_refine, tight_polish
from triplet_match_tpu_torch.search import score_kernel as sk
from triplet_match_tpu_torch.search.sampling import (
    RoundDraws,
    draw_round,
    hash_uniform,
    sample_firsts,
    sample_seconds,
)
from triplet_match_tpu_torch.search.score import (
    JOIN_SCORE,
    _score_points,
    finish_find,
    normalize_score,
)

@dataclasses.dataclass(frozen=True)
class ScenePrep:
    """Per-scene preprocessing (impl/scene.hpp:41-58)."""

    cloud: cl.PointCloud
    tangent_mask: torch.Tensor  # [N] bool — edge points
    n_edge: torch.Tensor


def _prepare_scene_whole(cloud: cl.PointCloud, policy: SearchPolicy) -> ScenePrep:
    cloud = cl.finite_filter(cloud)
    curv = principal_curvatures(cloud, k=policy.curvature_k)
    tm = edge_mask_op(cloud, curv, tangent_norm_threshold=policy.tangent_norm_threshold,
                      curvature_ratio_threshold=policy.curvature_ratio_threshold)
    return ScenePrep(cloud=cloud, tangent_mask=tm, n_edge=tm.sum())


def _mesh_tiles(tile, starts: list, n: int, chunk: int, mesh, device) -> torch.Tensor:
    """``torch.cat([tile(s) for s in starts])`` with the tiles dealt to the
    ranks of ``mesh`` in contiguous runs (the same tiles as one device, so the
    same values) and all-gathered back in order."""
    ndev = mesh.size()
    per = -(-len(starts) // ndev)
    lengths = [sum(min(chunk, n - s) for s in starts[r * per:(r + 1) * per])
               for r in range(ndev)]
    me = flat_rank(mesh)
    mine = [tile(s) for s in starts[me * per:(me + 1) * per]]
    out = torch.zeros(per * chunk, dtype=torch.float32, device=device)
    if mine:
        local = torch.cat(mine)
        out[:local.numel()] = local
    parts = all_gather(out[None], mesh, mesh.mesh_dim_names)
    return torch.cat([parts[r, :lengths[r]] for r in range(ndev)])


def _prepare_scene_grid(cloud: cl.PointCloud, *, policy: SearchPolicy, chunk: int = 4096,
                        cap: int = 64, mesh=None) -> ScenePrep:
    """Grid-bucketed edge classification for large scenes.

    Curvature is evaluated only for tangent-bearing points (the edge mask is
    ``tnorm > 0.7 AND ratio < 0.2``, impl/scene.hpp:50), with neighbours from
    a 27-cell grid stencil sized for that population.  With ``mesh`` the query
    tiles are dealt to every rank of the mesh and the ratios all-gathered, so
    every rank holds the same mask (``_mesh_tiles``).
    """
    from triplet_match_tpu_torch.ops import gridnn

    cloud = cl.finite_filter(cloud)
    tb = cloud.valid & (torch.linalg.vector_norm(cloud.tangent, dim=-1)
                        > policy.tangent_norm_threshold)
    qidx = torch.nonzero(tb)[:, 0]
    tm = torch.zeros_like(tb)
    if qidx.numel():
        cell = gridnn.estimate_knn_radius(cloud.xyz, cloud.valid, policy.curvature_k, focus=tb)
        grid = gridnn.build_grid(cloud.xyz, cloud.valid, cell)

        def tile(s):
            q = qidx[s:s + chunk]
            idx, mask = gridnn.grid_neighbors(grid, cloud.xyz, cloud.xyz[q],
                                              policy.curvature_k, cap=cap)
            return curvature_ratio(curvature_from_neighbors(cloud.normal[q], cloud.normal[idx],
                                                            mask))

        starts = list(range(0, qidx.numel(), chunk))
        if mesh is None:
            ratios = torch.cat([tile(s) for s in starts])
        else:
            ratios = _mesh_tiles(tile, starts, qidx.numel(), chunk, mesh, cloud.device)
        tm[qidx] = ratios < policy.curvature_ratio_threshold
    tm = tm & cloud.valid
    return ScenePrep(cloud=cloud, tangent_mask=tm, n_edge=tm.sum())


def prepare_scene(cloud: cl.PointCloud, policy: SearchPolicy = DEFAULT_POLICY, *,
                  grid_threshold: int = 32768, mesh=None) -> ScenePrep:
    """Per-scene preprocessing (impl/scene.hpp:41-58) on the cloud's device.

    Scenes above ``grid_threshold`` points take the grid-bucketed pass,
    smaller ones the brute-force pass over the whole cloud.  ``mesh``: a
    ``DeviceMesh`` covering every rank; every rank passes the full cloud, the
    grid pass's query tiles are shared out over the ranks, and every rank
    gets the whole (replicated) preparation back, the same as one device's.
    """
    if mesh is not None:
        check_mesh(mesh)
        return _prepare_scene_grid(cloud, policy=policy, mesh=mesh)
    if cloud.capacity <= grid_threshold:
        return _prepare_scene_whole(cloud, policy)
    return _prepare_scene_grid(cloud, policy=policy)


class RoundResult(NamedTuple):
    transform: torch.Tensor  # [F, 4, 4] scene -> model (pre-inversion)
    accept: torch.Tensor  # [F] bool
    new_corr: torch.Tensor  # [F, N] bool — newly claimed scene corrs
    model_idx: torch.Tensor  # [F, N] int64
    count: torch.Tensor  # [F] int64 total corrs from ICP finish_find
    score: torch.Tensor  # [F] float32 signed score (unnormalized)
    hypotheses_scored: torch.Tensor  # 0-d int64
    join_overflow: torch.Tensor  # 0-d int64, worst candidate overflow of the subset join


def _rank_on_all(policy) -> bool:
    """Effective ``samples_on_all`` for the ranking surfaces."""
    return policy.samples_on_all and not bool(policy.rank_edges_only)


def _f32(x) -> np.float32:
    return np.float32(float(x))


def pose_hypotheses(model: CompiledModel, p0, t0, p1, t1, pair_valid, *,
                    discretization: DiscretizationParams, sample_params: SampleParams,
                    policy: SearchPolicy):
    """Pair gates -> features -> model query -> pose hypotheses
    (impl/scene.hpp:299-319) for firsts (p0, t0 [B1, 1, 3]) and their seconds
    (p1, t1 [B1, B2, 3], ``pair_valid`` [B1, B2]).  Returns (ts [B1, B2, Q, 4, 4],
    hyp_ok [B1, B2, Q])."""
    b1, b2 = p1.shape[0], p1.shape[1]
    qcap = policy.query_cap
    lower = model.diameter * sample_params.min_diameter_factor
    upper = model.diameter * sample_params.max_diameter_factor
    gates = pf.pair_gates(p0, p1, t0, lower, upper, policy.pair_parallel_epsilon)
    feats = pf.pair_feature(p0, p1, t0, t1)
    pair_ok = pair_valid & gates & pf.feature_valid(feats, model.bounds_min, model.bounds_max)

    mpairs, mvalid = query_pairs(model, feats, discretization, qcap, limit=policy.query_limit)
    hyp_ok = pair_ok[..., None] & mvalid  # [B1, B2, Q]
    shape = (b1, b2, qcap, 3)
    ts = base_transform(p0[:, :, None].expand(shape), p1[:, :, None].expand(shape),
                        t0[:, :, None].expand(shape), model.cloud.xyz[mpairs[..., 0]],
                        model.cloud.xyz[mpairs[..., 1]], model.cloud.tangent[mpairs[..., 0]])
    if sample_params.force_up:
        hyp_ok = hyp_ok & ((1.0 - ts[..., 2, 2]).abs() <= 0.01)
    return ts, hyp_ok


# (hypothesis, neighbour) pairs the voxel-LUT ranking scores in one batch
_LUT_SCORE_ELEMS = 1 << 22


def _lut_scores(model, prep, consumed, ts, hyp_ok, nbr_idx, nbr_in_r, thres, policy):
    """Rank every hypothesis by the voxel-LUT scorer over its first's
    neighbourhood (the JAX package's ``jnp`` route, ``_score_points`` per
    first): [B1, H] poses and masks -> [B1 * H] scores, ``-1.0`` (``-1e12``
    under ``negative_scores``) where a hypothesis is invalid.  Firsts are
    scored in batches of at most ``_LUT_SCORE_ELEMS`` pairs."""
    b1, h = hyp_ok.shape
    ks = nbr_idx.shape[1]
    invalid = -1.0e12 if policy.negative_scores else -1.0
    step = max(1, _LUT_SCORE_ELEMS // max(h * ks, 1))
    out = []
    for s in range(0, b1, step):
        e = min(s + step, b1)
        idx = nbr_idx[s:e, None, :].expand(e - s, h, ks)
        iv = nbr_in_r[s:e, None, :].expand(e - s, h, ks)
        sc, _, _, _ = _score_points(model, prep.cloud, prep.tangent_mask, consumed, ts[s:e], idx,
                                    iv, thres, weighted_distance=policy.weighted_distance,
                                    negative_scores=policy.negative_scores,
                                    samples_on_all=_rank_on_all(policy))
        out.append(torch.where(hyp_ok[s:e], sc, invalid))
    return torch.cat(out).reshape(-1)


def hypothesize_and_score(model: CompiledModel, prep: ScenePrep, consumed: torch.Tensor,
                          fp_mask: torch.Tensor, draws: RoundDraws, dist_thres, mpack, *,
                          discretization: DiscretizationParams, sample_params: SampleParams,
                          policy: SearchPolicy):
    """Sample pairs, query the model, build and rank pose hypotheses
    (``find_in_subset``, impl/scene.hpp:242-367).

    Ranks through the kernels (``score_kernel.rank_groups``) with a model pack
    ``mpack``, and through the voxel-LUT scorer (``_lut_scores``) without one.
    Returns (ts_flat [H, 4, 4], scores [H], first_idx [B1], first_valid [B1],
    n_hypotheses), a pure function of ``draws``.
    """
    cloud = prep.cloud
    b1, b2 = policy.num_first_samples, policy.num_second_samples
    qcap = policy.query_cap
    ks = policy.score_neighbors
    thres = _f32(dist_thres) * _f32(model.resolution)

    eligible_first = prep.tangent_mask & ~consumed & ~fp_mask & cloud.valid
    firsts = sample_firsts(draws.first_words, eligible_first, b1)
    # scoring neighbourhood: a uniform sample of the model-diameter ball (any
    # point kind, impl/scene.hpp:273,432); balls smaller than K come whole
    gidx = torch.arange(cloud.capacity, device=cloud.device)
    q = cloud.xyz[firsts.idx]
    blk = min(b1, 256)
    nbr_idx, nbr_in_r = radius_sample(q, cloud.xyz, cloud.valid, model.diameter, ks,
                                      hash_uniform(draws.nbr_words, gidx), block=blk)
    # second-point pool: edge points of the ball, uniformly (impl/scene.hpp:284-290)
    second_eligible = prep.tangent_mask & ~consumed & cloud.valid
    pool_idx, pool_in_r = radius_sample(q, cloud.xyz, second_eligible, model.diameter,
                                        policy.second_pool, hash_uniform(draws.pool_words, gidx),
                                        block=blk)
    seconds = sample_seconds(draws.gumbel, firsts, pool_idx, pool_in_r, second_eligible, b2)

    ts, hyp_ok = pose_hypotheses(
        model, q[:, None, :], cloud.tangent[firsts.idx][:, None, :], cloud.xyz[seconds.idx],
        cloud.tangent[seconds.idx], seconds.valid, discretization=discretization,
        sample_params=sample_params, policy=policy)
    ts_g, ok_g = ts.reshape(b1, b2 * qcap, 4, 4), hyp_ok.reshape(b1, b2 * qcap)
    if mpack is None:
        scores = _lut_scores(model, prep, consumed, ts_g, ok_g, nbr_idx, nbr_in_r, float(thres),
                             policy)
    else:
        groups = sk.pack_groups(cloud, prep.tangent_mask, consumed, nbr_idx, nbr_in_r,
                                samples_on_all=_rank_on_all(policy))
        scores = sk.rank_groups(mpack, groups, sk.poses_to_rows(ts_g), float(thres * thres), ok_g,
                                policy).reshape(-1)
    return ts.reshape(-1, 4, 4), scores, firsts.idx, firsts.valid, hyp_ok.sum()


# Finalist x scene rows that one batched pass of the join may hold (the JAX
# package's budget): above it the finalists run in chunks of the largest
# batch that fits, so no [F, N, 3] temporary outgrows it at 2M-8M points.
_FINALIST_ROW_BUDGET = 8 * 1024 * 1024


def _tuple(like, items):
    """A tuple or NamedTuple of ``like``'s type holding ``items``."""
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def _rows(x, s: int, e: int):
    """Finalists ``s:e`` of a per-finalist tensor, cloud or tuple of them."""
    if isinstance(x, torch.Tensor):
        return x[s:e]
    if isinstance(x, cl.PointCloud):
        return cl.PointCloud(x.xyz[s:e], x.normal[s:e], x.tangent[s:e], x.valid[s:e])
    return _tuple(x, (_rows(v, s, e) for v in x))


def _cat(parts):
    """Concatenate per-chunk results (tensors or NamedTuples of them) along
    the finalist dim."""
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return _tuple(parts[0], (_cat(list(p)) for p in zip(*parts)))


def _finalist_map(fn, ts, rows: int, *extra):
    """``fn(ts, *extra)`` over the finalist poses ``ts`` [F, 4, 4] (and the
    per-finalist ``extra`` inputs), in chunks of finalists when F x ``rows``
    exceeds ``_FINALIST_ROW_BUDGET``.  Finalists are independent, so chunking
    only regroups the work (batched and unbatched SVDs may round apart)."""
    f = ts.shape[0]
    if f * rows <= _FINALIST_ROW_BUDGET:
        return fn(ts, *extra)
    fc = max(1, _FINALIST_ROW_BUDGET // max(rows, 1))
    return _cat([fn(ts[s:s + fc], *(_rows(x, s, s + fc) for x in extra))
                 for s in range(0, f, fc)])


def _auto_join_capacity(n_scene: int) -> int:
    """Fog-switch default for ``policy.join_subset_capacity``: the power of
    two of max(65536, N/16), at most N.  The in-grid candidate population of
    a posed model is a few percent of a dense scene; an overflow is counted
    exactly and published as ``join_overflow_max``."""
    want = max(65536, n_scene // 16)
    cap = 1 << (want - 1).bit_length()
    return int(min(cap, n_scene))


def _candidate_subset(model: CompiledModel, cloud, tangent_mask, consumed, ts, dist_thres,
                      capacity: int, slack: float):
    """Per-finalist candidate sub-scenes for the join's scene-sized passes.

    A scene point can correspond to a posed model only if its transformed
    position lands inside the voxel grid (every scoring surface gates on
    ``voxel_query``'s in_bounds), so the points whose voxel coordinates fall
    within the grid plus a slack border (``slack`` relaxed 2x gates, plus
    1.5 voxels for ``voxel_query_exact``) are an exact eligibility superset
    while the pose stays within the slack.  Each finalist keeps its first
    ``capacity`` candidates in index order, compacted on the device by a
    cumulative sum (no host sync).

    Returns (sub_cloud, sub_tangent_mask, sub_consumed, idx, idx_valid,
    n_candidates), each with a leading finalist dim; padding rows carry
    index N, valid=False and consumed=True.  ``n_candidates`` above
    ``capacity`` means the subset passes undercounted (the join overflow).
    Finalists are scanned in chunks of ``_FINALIST_ROW_BUDGET`` scene rows.
    """
    n = cloud.capacity
    cap = int(min(int(capacity), n))
    relaxed_w = model.resolution.to(torch.float32) * float(2.0 * _f32(dist_thres))
    hi = torch.tensor(model.lut.shape, dtype=torch.float32, device=cloud.device) - 1.0
    s_vox = relaxed_w * float(_f32(slack)) * torch.diagonal(model.to_voxel)[:3] + 1.5

    def one(t):
        m = model.to_voxel @ t  # scene point -> voxel coordinates, one affine
        v = cloud.xyz @ m[:, :3, :3].transpose(-1, -2) + m[:, None, :3, 3]
        mask = ((v >= -s_vox) & (v <= hi + s_vox)).all(-1) & cloud.valid
        slot = torch.cumsum(mask, dim=-1) - 1
        slot = torch.where(mask & (slot < cap), slot, cap)  # overflow and misses -> dump column
        idx = torch.full((t.shape[0], cap + 1), n, dtype=torch.int64, device=t.device)
        idx = idx.scatter(1, slot, torch.arange(n, device=t.device).expand_as(slot))
        return idx[:, :cap], mask.sum(-1)

    idx, n_cand = _finalist_map(one, ts, n)  # no [F, N] temporaries above the budget
    idx_valid = idx < n
    idxc = torch.clamp(idx, max=n - 1)
    sub = cl.PointCloud(cloud.xyz[idxc], cloud.normal[idxc], cloud.tangent[idxc],
                        cloud.valid[idxc] & idx_valid)
    return sub, tangent_mask[idxc], consumed[idxc] | ~idx_valid, idx, idx_valid, n_cand


def _scatter_corrs(idx, idx_valid, sub_valid, sub_midx, n: int):
    """Scatter per-finalist subset correspondences back to scene shape
    ([F, C] -> [F, N]); padding rows (index n) land in a dropped column."""
    f = idx.shape[0]
    full_v = torch.zeros((f, n + 1), dtype=torch.bool, device=idx.device)
    full_m = torch.zeros((f, n + 1), dtype=sub_midx.dtype, device=idx.device)
    full_v = full_v.scatter(1, idx, sub_valid & idx_valid)[:, :n]
    full_m = full_m.scatter(1, idx, torch.where(idx_valid, sub_midx, 0))[:, :n]
    return full_v, full_m


class _JoinPasses:
    """Runs the join's scene-sized passes over the finalists, in chunks of
    ``_finalist_map``: on per-finalist candidate subsets, gathered at each
    pass's own poses, when ``policy.join_subset_capacity`` is below the scene
    size, else on the whole scene.  ``flags``: the scoring flags and
    ``group`` every pass takes (``group`` as in ``accept_and_polish``)."""

    def __init__(self, model: CompiledModel, cloud, tangent_mask, consumed, dist_thres,
                 policy: SearchPolicy, group=None):
        self.model, self.cloud, self.tangent_mask = model, cloud, tangent_mask
        self.consumed, self.dist_thres, self.slack = consumed, dist_thres, policy.join_subset_slack
        cap = int(policy.join_subset_capacity or 0)
        self.cap = cap if 0 < cap < cloud.capacity else 0
        self.rows = self.cap or cloud.capacity * group_extent(group)
        self.flags = dict(weighted_distance=policy.weighted_distance,
                          negative_scores=policy.negative_scores, group=group)

    def __call__(self, fn, ts, corrs_of=None):
        """``fn(t, scene, tangent_mask, consumed)`` over the finalist poses
        ``ts`` [F, 4, 4].  Returns (its result, the (valid, model_idx) of the
        ``DenseCorrs`` that ``corrs_of`` picks from it, at scene shape [F, N],
        the finalists' candidate counts [F]); None for the corrs without
        ``corrs_of`` and for the counts on the whole scene."""
        if self.cap:
            sub, stm, scons, idx, idx_valid, n_cand = _candidate_subset(
                self.model, self.cloud, self.tangent_mask, self.consumed, ts, self.dist_thres,
                self.cap, self.slack)
            out = _finalist_map(fn, ts, self.cap, sub, stm, scons)
            to_scene = functools.partial(_scatter_corrs, idx, idx_valid, n=self.cloud.capacity)
        else:
            out = _finalist_map(lambda t: fn(t, self.cloud, self.tangent_mask, self.consumed), ts,
                                self.rows)
            to_scene, n_cand = (lambda valid, midx: (valid, midx)), None
        corrs = None if corrs_of is None else corrs_of(out)
        return out, None if corrs is None else to_scene(corrs.valid, corrs.model_idx), n_cand


def _greedy_walk(corr_valid, consumed, order, decide):
    """Greedy non-overlap claims (impl/scene.hpp:193-237): the finalists in
    ``order`` each claim their corrs ``corr_valid`` [F, N] not yet used, and
    a finalist that ``decide(f, new)`` accepts marks its corrs used.  The
    host reads ``order`` once; the decisions stay on the device.  Returns
    (accept [F], new_corr [F, N], consumed') in finalist order."""
    used = consumed
    acc_ord, new_ord = [], []
    for f in order.tolist():
        cv = corr_valid[f]
        new = cv & ~used
        ok = decide(f, new)
        used = torch.where(ok, used | cv, used)
        acc_ord.append(ok)
        new_ord.append(new)
    inv_order = torch.argsort(order)
    accept, new_corr = torch.stack(acc_ord)[inv_order], torch.stack(new_ord)[inv_order]
    return accept, new_corr, consumed | (new_corr & accept[:, None]).any(0)


def accept_and_polish(model: CompiledModel, cloud, tangent_mask, consumed, t_best, dist_thres,
                      model_match_factor, *, policy: SearchPolicy, max_icp_iterations: int,
                      group=None):
    """Finalist prescreen + relaxed ICP + greedy acceptance + acceptance-gated
    tight polish.

    With ``finalist_prescreen`` below the funnel width, one full relaxed-count
    pass per finalist (ranking eligibility, ``_rank_on_all``) keeps a stable
    top-``finalist_prescreen``.  Every scene-sized pass runs through one
    ``_JoinPasses``: on per-finalist candidate subsets, regathered at each
    phase boundary, with ``join_subset_capacity`` below the scene size.
    Returns (t_fin, accept, new_corr, model_idx, counts, scores, consumed',
    join_overflow), the last the worst candidate overflow of the prescreen's
    and the ICP's gathers (0 when exact or off).

    ``group``: a ``parallel.mesh.MeshAxis`` when ``cloud`` (and the masks) are
    one shard of a scene sharded over it (the sp-sharded round).  Every count,
    score and fit then sums over the shards, so the prescreen, the greedy
    acceptance and the polish gate read the same values on every shard; the
    per-point outputs stay shard-local, and the join overflow is the worst
    over the shards.  The finalist chunks follow the global scene size.
    """
    passes = _JoinPasses(model, cloud, tangent_mask, consumed, dist_thres, policy, group)
    pre_cand = None
    keep = int(policy.finalist_prescreen)
    if 0 < keep < t_best.shape[0]:
        def pre_count(t, sc, tm, co):
            return finish_find(model, sc, tm, co, t, 2.0 * dist_thres,
                               samples_on_all=_rank_on_all(policy), count_only=True,
                               **passes.flags).count

        pre, _, pre_cand = passes(pre_count, t_best)
        # ties break toward the higher-ranked hypothesis, as lax.top_k does
        t_best = t_best[torch.sort(pre, descending=True, stable=True)[1][:keep]]

    # reference-faithful relaxed ICP only; the tight polish runs after (and
    # gated on) acceptance
    def icp(t, sc, tm, co):
        return icp_refine(model, sc, tm, co, t, dist_thres, max_icp_iterations,
                          tight_iterations=0, point_to_plane=policy.icp_point_to_plane,
                          samples_on_all=policy.samples_on_all, **passes.flags)

    res, (corr_valid, corr_midx), icp_cand = passes(icp, t_best, corrs_of=lambda r: r.corrs)
    join_overflow = torch.zeros((), dtype=torch.int64, device=t_best.device)
    for n_cand in (pre_cand, icp_cand):  # the polish's gathers count none, as in the JAX package
        if n_cand is not None:
            join_overflow = torch.maximum(join_overflow, n_cand.max() - passes.cap)
    t_fin, fin_counts, fin_scores = res.transform, res.corrs.count, res.corrs.score

    order = torch.sort(-fin_counts, stable=True)[1]
    mmf = _f32(model_match_factor)
    min_pts = int(np.floor(mmf * _f32(model.n_edge)))
    min_pts_all = int(np.floor(mmf * _f32(model.n_all)))

    def count_test(f, new):
        if not sharded(group):
            return ((new & tangent_mask).sum() >= min_pts) & (new.sum() >= min_pts_all)
        # one collective for both counts
        counts = psum(torch.stack([(new & tangent_mask).sum(), new.sum()]), *group)
        return (counts[0] >= min_pts) & (counts[1] >= min_pts_all)

    accept, new_corr, consumed_next = _greedy_walk(corr_valid, consumed, order, count_test)

    if max_icp_iterations > 0 and bool(accept.any()):
        if model.orbit is not None and model.orbit.shape[0] > 1:
            t_fin = resolve_orbit(model, cloud, tangent_mask, consumed, t_fin, accept,
                                  dist_thres, policy, group=group)
        t_fin, new_corr, corr_midx, fin_counts, fin_scores, consumed_next = polish_accepted(
            passes, policy, t_fin, accept, order)
    if sharded(group):
        join_overflow = pmax(join_overflow, *group)  # per-shard candidate counts differ
    return (t_fin, accept, new_corr, corr_midx, fin_counts, fin_scores, consumed_next,
            join_overflow)


def resolve_orbit(model: CompiledModel, cloud, tangent_mask, consumed, t_fin, accept,
                  dist_thres, policy: SearchPolicy, group=None) -> torch.Tensor:
    """Move each accepted finalist to the member of the model's orbit with
    the most scene points within the hypotheses' own gate (``dist_thres``,
    the count their ranking takes); ties keep the pose as it is.  ``t_fin``
    [F, 4, 4] is scene -> model, so a member S (S @ model ~= model) turns a
    pose into S @ t.  The counts run on the whole scene, one pose per
    accepted finalist and member.  ``group``: as in ``accept_and_polish``."""
    acc = torch.nonzero(accept)[:, 0]
    cand = model.orbit[None] @ t_fin[acc][:, None]  # [A, K, 4, 4]
    count = finish_find(model, cloud, tangent_mask, consumed, cand, dist_thres,
                        weighted_distance=policy.weighted_distance,
                        negative_scores=policy.negative_scores,
                        samples_on_all=_rank_on_all(policy), group=group,
                        count_only=True).count
    best = torch.argmax(count, dim=1)  # the first of equal counts: the identity first
    out = t_fin.clone()
    out[acc] = cand[torch.arange(acc.numel(), device=acc.device), best]
    return out


def polish_accepted(passes: _JoinPasses, policy: SearchPolicy, t_fin, accept, order):
    """Tight-polish every finalist of an accepting round, then re-derive the
    reported corrs, counts, scores and point claims at the polished poses,
    walking the same ``order`` with the ``accept`` decisions frozen: the
    acceptance decision stays at the unpolished pose (impl/scene.hpp:193-237).
    On candidate subsets the polish gathers at the relaxed-ICP poses and the
    claim pass at the polished poses."""
    model, dist_thres = passes.model, passes.dist_thres

    def polish(t, sc, tm, co):
        return tight_polish(
            model, sc, tm, co, t, dist_thres, iterations=policy.tight_icp_iterations,
            orientation_weight=policy.tight_orientation_weight, anneal=policy.tight_anneal,
            edges_only=bool(policy.tight_edges_only), point_to_plane=policy.icp_point_to_plane,
            point_to_line_at_floor=bool(policy.tight_point_to_line),
            samples_on_all=policy.samples_on_all, **passes.flags)

    def claim_pass(t, sc, tm, co):
        return finish_find(model, sc, tm, co, t, 2.0 * dist_thres,
                           samples_on_all=policy.samples_on_all, **passes.flags)

    t_pol, _, _ = passes(polish, t_fin)
    corrs, (corr_v, corr_m), _ = passes(claim_pass, t_pol, corrs_of=lambda c: c)
    _, new_c, consumed2 = _greedy_walk(corr_v, passes.consumed, order, lambda f, new: accept[f])
    return t_pol, new_c, corr_m, corrs.count, corrs.score, consumed2


def finalize_round(model: CompiledModel, prep: ScenePrep, consumed, fp_mask, t_best, first_idx,
                   first_valid, n_hyp, dist_thres, model_match_factor, *, policy: SearchPolicy,
                   max_icp_iterations: int):
    """ICP-refine the finalists and run greedy acceptance (impl/scene.hpp:168-240).
    Returns (RoundResult, consumed', fp')."""
    fp_next = fp_mask.clone()
    fp_next[first_idx[first_valid]] = True
    (t_fin, accept, new_corr, corr_midx, counts, scores, consumed_next,
     join_overflow) = accept_and_polish(
        model, prep.cloud, prep.tangent_mask, consumed, t_best, dist_thres, model_match_factor,
        policy=policy, max_icp_iterations=max_icp_iterations)
    return (RoundResult(t_fin, accept, new_corr, corr_midx, counts, scores, n_hyp,
                        join_overflow), consumed_next, fp_next)


def search_round(model: CompiledModel, prep: ScenePrep, consumed, fp_mask, draws: RoundDraws,
                 dist_thres, model_match_factor, mpack, *, discretization: DiscretizationParams,
                 sample_params: SampleParams, policy: SearchPolicy, max_icp_iterations: int):
    """One single-device search round.  Returns (RoundResult, consumed', fp').

    Its two halves are ``torch.profiler`` ranges, "hypothesize" and
    "finalize", which a profile of the search splits its time by."""
    with torch.profiler.record_function("hypothesize"):
        ts_flat, scores, first_idx, first_valid, n_hyp = hypothesize_and_score(
            model, prep, consumed, fp_mask, draws, dist_thres, mpack,
            discretization=discretization, sample_params=sample_params, policy=policy)
    with torch.profiler.record_function("finalize"):
        # finalists: highest scores, ties to the lower index (lax.top_k order)
        best = torch.sort(scores, descending=True, stable=True)[1][:policy.finalists]
        return finalize_round(model, prep, consumed, fp_mask, ts_flat[best], first_idx,
                              first_valid, n_hyp, dist_thres, model_match_factor,
                              policy=policy, max_icp_iterations=max_icp_iterations)


def adaptive_outer_bound(n_model: int, n_left: int, n_scene: int, policy: SearchPolicy) -> int:
    """Adaptive RANSAC outer sampling bound (impl/scene.hpp:131-141):
    log(1-p) / log(1 - n_model/n_left) clamped to [min_sample_count, n_scene]."""
    if policy.force_exhaustive:
        return max(int(n_scene), 1)
    if n_left <= 0:
        return 0
    outer_prob = min(float(n_model) / float(n_left), 1.0)
    if outer_prob >= 1.0:
        bound = policy.min_sample_count
    else:
        bound = int(np.log(1.0 - policy.match_probability) / np.log(1.0 - outer_prob))
    bound = max(bound, policy.min_sample_count)
    return min(bound, max(int(n_scene), 1))


def ball_population_quantile(prep: ScenePrep, model: CompiledModel, *, sample: int = 256,
                             ref_sample: int = 65536, quantile: float = 0.95,
                             seed: int = 0) -> float:
    """Estimated ``quantile`` population of the model-diameter ball around
    eligible first points (the ``radius_search_inclusive`` count,
    impl/scene.hpp:276), from ``sample`` random eligible firsts against a
    ``ref_sample``-point scene subsample.  The draws come from a CPU
    generator seeded with ``seed``, independent of the search's.  0.0 when
    the scene has no eligible edge points."""
    gen = torch.Generator().manual_seed(seed)
    xyz, valid = prep.cloud.xyz, prep.cloud.valid
    n = xyz.shape[0]
    edge_ok = prep.tangent_mask & valid
    ru = torch.rand(n, generator=gen).to(xyz.device)
    ru2 = torch.rand(n, generator=gen).to(xyz.device)
    f_score = torch.where(edge_ok, ru, -1.0)
    fidx = torch.topk(f_score, min(sample, n))[1]
    f_ok = f_score[fidx] >= 0.0
    s_score = torch.where(valid, ru2, -1.0)
    sidx = torch.topk(s_score, min(ref_sample, n))[1]
    s_ok = s_score[sidx] >= 0.0
    d2 = ((xyz[fidx][:, None, :] - xyz[sidx][None, :, :]) ** 2).sum(-1)
    dia = _f32(model.diameter)
    in_ball = (d2 <= float(dia * dia)) & s_ok[None, :]
    frac = in_ball.sum(1) / torch.clamp(s_ok.sum(), min=1).to(torch.float32)
    pop = torch.where(f_ok, frac * valid.sum().to(torch.float32), float("nan"))
    q = float(torch.nanquantile(pop, quantile))
    return 0.0 if (int(edge_ok.sum()) == 0 or math.isnan(q)) else q


def adaptive_inner_bound(prep: ScenePrep, model: CompiledModel, policy: SearchPolicy, *,
                         ball_q: float | None = None, **ball_kw) -> int:
    """Per-first adaptive inner sampling bound (impl/scene.hpp:276-282) at the
    ``quantile`` ball population: -log(1-p) * |ball| / n_model_all, clamped to
    [min_sample_count, |ball|]."""
    if ball_q is None:
        ball_q = ball_population_quantile(prep, model, **ball_kw)
    if ball_q <= 0.0:
        return policy.min_sample_count
    if policy.force_exhaustive:
        return max(int(math.ceil(ball_q)), policy.min_sample_count)
    n_all = max(int(model.n_all), 1)
    bound = max(-math.log(1.0 - policy.match_probability) * ball_q / n_all,
                policy.min_sample_count)
    return int(math.ceil(min(bound, ball_q)))


def adaptive_policy(prep: ScenePrep, model: CompiledModel, policy: SearchPolicy,
                    mesh=None) -> tuple[SearchPolicy, float | None]:
    """The policy a search of this scene runs, and the ball-population q95
    it was read from (None when no adaptive knob needs it).

    With ``adaptive_second_samples``, an inner bound above
    ``num_second_samples`` raises it to ``max_second_samples`` (the JAX
    package's two-rung ladder), widening ``second_pool`` to match.  Under a
    ``mesh`` every rank computes the q95 from the full prep and takes rank
    0's value, so every rank runs the same policy.
    """
    ball_q = None
    if policy.adaptive_second_samples or policy.adaptive_fine_rescore:
        ball_q = ball_population_quantile(prep, model)
        if mesh is not None:
            ball_q = broadcast_first(ball_q, mesh)
    if policy.adaptive_second_samples:
        bound = adaptive_inner_bound(prep, model, policy, ball_q=ball_q)
        if bound > policy.num_second_samples:
            b2 = policy.max_second_samples
            policy = dataclasses.replace(policy, num_second_samples=b2,
                                         second_pool=max(policy.second_pool, 2 * b2))
    return policy, ball_q


def fog_policy(policy: SearchPolicy, prep: ScenePrep,
               model: CompiledModel) -> tuple[SearchPolicy, ScenePrep]:
    """The policy and scene preparation of the fog-density route.

    A fog-dominated diameter ball blurs any coverage-radius block ranking, so
    both ranking phases go exact (B2 on the compact blocks, keep 1/8, full-K
    phase 2; full mode keeps its configured stride), the finalist funnel
    widens to ``adaptive_finalists`` with a prescreen back to ``finalists``,
    and, when the model has edge points, ranking and the tight polish run on
    edge corrs (the polish point-to-line at the band's floor) and the scene's
    edges come from its raw tangents (``|tangent| > tangent_norm_threshold``).
    The join gathers candidate subsets (``_auto_join_capacity``).  Explicit
    policy values win over each automatic one.
    """
    has_edges = int(model.n_edge) > 0

    def auto(value):
        return value if value is not None else has_edges

    policy = dataclasses.replace(
        policy, two_phase_coarse_model=False, two_phase_fine_coarse=False,
        two_phase_fine_stride=(policy.two_phase_fine_stride if policy.ranking_mode == "full"
                               else 1),
        two_phase_keep_frac=min(policy.two_phase_keep_frac, 8),
        finalists=max(policy.finalists, policy.adaptive_finalists),
        finalist_prescreen=policy.finalist_prescreen or policy.finalists,
        rank_edges_only=auto(policy.rank_edges_only),
        tight_edges_only=auto(policy.tight_edges_only),
        tight_point_to_line=auto(policy.tight_point_to_line),
        join_subset_capacity=(policy.join_subset_capacity
                              if policy.join_subset_capacity is not None
                              else _auto_join_capacity(prep.cloud.capacity)),
        scene_raw_tangents=auto(policy.scene_raw_tangents))
    if policy.scene_raw_tangents:
        raw = ((torch.linalg.vector_norm(prep.cloud.tangent, dim=-1)
                > policy.tangent_norm_threshold) & prep.cloud.valid)
        prep = ScenePrep(cloud=prep.cloud, tangent_mask=raw, n_edge=raw.sum())
    return policy, prep


LAST_SEARCH_STATS: dict = {}


@dataclasses.dataclass
class Match:
    """Accepted match (``match_t``, include/scene:23-28); ``transform`` maps
    model -> scene (the reference inverts before returning, impl/scene.hpp:92)."""

    transform: np.ndarray  # [4, 4] model -> scene
    scene_corrs: np.ndarray  # [K] scene point indices (newly claimed)
    model_corrs: np.ndarray  # [K] model point indices
    signed_score: float  # normalized signed score (score / model size)
    cast_score: float | None = None


def _round_backend(mesh, n: int):
    """(round function, RANSAC chunks per round) of a search: the
    single-device ``search_round``; a 1-axis mesh's ``search_round_dp``, one
    chunk per rank; a 2- or 3-axis mesh's ``search_round_2d_prep``, one chunk
    per (dcn, dp) coordinate, the scene sharded over the last axis."""
    if mesh is None:
        return search_round, 1
    check_mesh(mesh)
    names = mesh.mesh_dim_names
    if len(names) >= 2:
        from triplet_match_tpu_torch.parallel.search2d import search_round_2d_prep

        sp_ext = mesh.size(len(names) - 1)
        if n % sp_ext:
            raise ValueError(f"scene capacity {n} not divisible by sp extent {sp_ext}; pad the "
                             "cloud capacity (core.cloud.pad_capacity)")
        return (functools.partial(search_round_2d_prep, mesh),
                math.prod(mesh.size(i) for i in range(len(names) - 1)))
    from triplet_match_tpu_torch.parallel.search import search_round_dp

    return functools.partial(search_round_dp, mesh), mesh.size(0)


def find_all(model: CompiledModel, scene_cloud: cl.PointCloud, *, dist_thres: float | None = None,
             model_match_factor: float = 0.4, early_out_factor: float = 0.9,
             sample_params: SampleParams = DEFAULT_SAMPLE_PARAMS,
             discretization: DiscretizationParams = DEFAULT_DISCRETIZATION,
             policy: SearchPolicy = DEFAULT_POLICY, max_icp_iterations: int = 10,
             seed: int = 13, prep: ScenePrep | None = None, mesh=None,
             generator: torch.Generator | None = None, device=None,
             progress=None) -> list[Match]:
    """Find all model instances in the scene (``scene::find_all_parallel``,
    include/scene:47-48), on ``device`` (default: the model's).

    Phases run the adaptive RANSAC outer bound as rounds of
    ``num_first_samples`` firsts per RANSAC chunk (impl/scene.hpp:70-95,
    131-141); a phase without an accepted match ends the search, and
    ``early_out`` stops a phase once a match reaches ``early_out_factor *
    possible_model`` corrs.  The rounds' random inputs come from
    ``generator`` (a CPU generator, default seeded with ``seed``), so a seed
    gives the same search on every device but not the JAX package's
    (threefry) samples.  Runs under ``strict_fp32``.

    ``policy.scorer``: "auto" and "pallas" rank through the kernels; "jnp"
    ranks through the voxel-LUT scorer (``_lut_scores``, no kernel, no fog
    switch), as the JAX package does off the TPU.  When the ball population
    q95 exceeds ``fine_full_rescore_ratio * score_neighbors`` the
    fog-density switch fires (``fog_policy``).

    ``mesh``: a ``DeviceMesh`` over every rank of the process group, each
    rank a process that calls ``find_all`` with identical inputs.  A 1-axis
    mesh runs hypothesis data parallelism (each rank is a RANSAC chunk,
    ``parallel.search.search_round_dp``); a ("dp", "sp") mesh also shards
    the scene over sp (``parallel.search2d.search_round_2d``; the capacity
    must be divisible by the sp extent; always the kernels); a ("dcn", "dp",
    "sp") mesh runs one chunk per (dcn, dp) pair with a hierarchical
    finalist join.  Each round the host draws every chunk's ``RoundDraws``
    from the one generator, in chunk order, and each rank takes its own, so
    chunk 0 draws the single-device round's samples and a one-chunk mesh
    repeats the single-device search.  Every rank returns the same matches.

    ``progress``: optional callable polled with the fraction of the current
    phase done, 0.0 at each phase's start and after every round (the
    reference's per-``find_parallel`` progress bar, src/progress_bar.cpp:10-48),
    e.g. ``utils.progress.ProgressBar.poll``.

    ``LAST_SEARCH_STATS`` gets the JAX package's keys (without its
    executable-cache entry; ``round_ms_avg`` and ``profile`` from a
    ``utils.timer.Profiler``) plus the launches of each ranking kernel in
    this search (on this rank): ``coarse_kernel_launches`` (B1),
    ``exact_kernel_launches`` (B2), ``full_kernel_launches`` (B3) and
    ``coarse_linear_kernel_launches`` (B4), of the join's scoring pass,
    ``join_score_kernel_launches`` (one per ``finish_find`` call on the
    card, 0 on the CPU), and of its pose fit, ``join_fit_kernel_launches``
    (one per ICP or polish fit on the card outside a sharded group, 0 on the
    CPU).
    """
    from triplet_match_tpu_torch.utils.timer import Profiler

    if policy.scorer not in ("auto", "pallas", "jnp"):
        raise ValueError(f"unknown scorer {policy.scorer!r}")
    device = torch.device(device) if device is not None else model.cloud.device
    if dist_thres is None:
        dist_thres = policy.corr_dist_factor
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    counters = {"coarse_kernel_launches": sk.COARSE_RANK, "exact_kernel_launches": sk.EXACT_RANK,
                "full_kernel_launches": sk.FULL_RANK,
                "coarse_linear_kernel_launches": sk.COARSE_LINEAR_RANK,
                "join_score_kernel_launches": JOIN_SCORE,
                "join_fit_kernel_launches": JOIN_FIT}
    launches0 = {key: c.launches for key, c in counters.items()}
    profiler = Profiler()
    with strict_fp32():
        if prep is None:
            prep = prepare_scene(scene_cloud.to(device), policy, mesh=mesh)
        round_fn, n_chunks = _round_backend(mesh, prep.cloud.capacity)
        # the 2-D round ranks through the kernels whatever the scorer
        use_kernels = policy.scorer != "jnp" or (mesh is not None
                                                 and len(mesh.mesh_dim_names) >= 2)
        stats = {"rounds": 0, "phases": 0, "hypotheses_scored": 0, "finalists": 0,
                 "accepted": 0, "join_overflow_max": 0}

        timed = policy.adaptive_second_samples or policy.adaptive_fine_rescore
        with profiler.section("ball_quantile") if timed else contextlib.nullcontext():
            policy, ball_q = adaptive_policy(prep, model, policy, mesh)
        stats["num_second_samples_effective"] = policy.num_second_samples
        stats["fine_rescore_full"] = False
        if (policy.adaptive_fine_rescore and use_kernels and policy.two_phase_scoring
                and policy.two_phase_fine_coarse and ball_q is not None
                and ball_q > policy.fine_full_rescore_ratio * policy.score_neighbors):
            policy, prep = fog_policy(policy, prep, model)
            if policy.scene_raw_tangents:
                stats["scene_raw_tangents"] = True
                stats["scene_n_edge_raw"] = int(prep.n_edge)
            stats["fine_rescore_full"] = True
            stats["finalist_prescreen"] = int(policy.finalist_prescreen)
            stats["rank_edges_only"] = bool(policy.rank_edges_only)
            stats["tight_edges_only"] = bool(policy.tight_edges_only)
            stats["tight_point_to_line"] = bool(policy.tight_point_to_line)
            stats["join_subset_capacity"] = int(policy.join_subset_capacity or 0)
            stats["finalist_funnel"] = int(policy.finalists)
        if ball_q is not None:
            stats["ball_population_q95"] = int(ball_q)
        mpack = None
        if use_kernels:
            mpack = sk.pack_model_cached(model, coarse_points=policy.coarse_model_points,
                                         fine_points=policy.fine_model_points)

        n = prep.cloud.capacity
        consumed = torch.zeros(n, dtype=torch.bool, device=device)
        fp = torch.zeros(n, dtype=torch.bool, device=device)
        edge_valid = prep.tangent_mask & prep.cloud.valid
        n_scene_edge = int(edge_valid.sum())
        n_model = int(model.n_edge)
        if policy.samples_on_all:
            possible_model = int(model.n_all)
        else:
            possible_model = int(((torch.linalg.vector_norm(model.cloud.tangent, dim=-1) > 0.7)
                                  & model.cloud.valid).sum())
        early_out_threshold = early_out_factor * possible_model

        def publish():
            LAST_SEARCH_STATS.clear()
            LAST_SEARCH_STATS.update(stats)
            LAST_SEARCH_STATS["rejection_rate"] = (1.0 - stats["accepted"]
                                                   / max(stats["finalists"], 1))
            if "round" in profiler.phases:
                LAST_SEARCH_STATS["round_ms_avg"] = profiler.phases["round"].value
                LAST_SEARCH_STATS["profile"] = profiler.report()
            for key, c in counters.items():
                LAST_SEARCH_STATS[key] = c.launches - launches0[key]

        matches: list[Match] = []
        rnd = 0
        while rnd < policy.max_rounds:  # safety valve; phases end the search
            n_left = int((edge_valid & ~consumed & ~fp).sum())
            outer_bound = adaptive_outer_bound(n_model, n_left, n_scene_edge, policy)
            if outer_bound == 0:
                break
            phase_rounds = max(1, -(-outer_bound // (policy.num_first_samples * n_chunks)))
            stats["phases"] += 1
            phase_accepted = phase_early_out = False
            if progress is not None:
                progress(0.0)
            for round_in_phase in range(phase_rounds):
                if rnd >= policy.max_rounds:
                    break
                draws = [draw_round(gen, policy.num_first_samples, policy.second_pool, device)
                         for _ in range(n_chunks)]
                # the accept flags' copy to the host waits for the round: the
                # section adds no sync of its own
                with profiler.section("round"):
                    res, consumed, fp = round_fn(
                        model, prep, consumed, fp, draws[0] if mesh is None else draws,
                        dist_thres, model_match_factor, mpack, discretization=discretization,
                        sample_params=sample_params, policy=policy,
                        max_icp_iterations=max_icp_iterations)
                    accept = res.accept.cpu().numpy()
                rnd += 1
                if progress is not None:
                    progress((round_in_phase + 1) / phase_rounds)
                stats["rounds"] += 1
                stats["hypotheses_scored"] += int(res.hypotheses_scored)
                stats["finalists"] += accept.shape[0]
                stats["accepted"] += int(accept.sum())
                stats["join_overflow_max"] = max(stats["join_overflow_max"],
                                                 int(res.join_overflow))
                if not accept.any():
                    continue
                phase_accepted = True
                counts = res.count.cpu().numpy()
                for f in np.argsort(-counts, kind="stable"):
                    if not accept[f]:
                        continue
                    new = res.new_corr[f]
                    sidx = torch.nonzero(new)[:, 0]
                    matches.append(Match(
                        transform=invert_rigid(res.transform[f]).cpu().numpy(),
                        scene_corrs=sidx.cpu().numpy(),
                        model_corrs=res.model_idx[f][sidx].cpu().numpy(),
                        signed_score=float(normalize_score(model, res.score[f])),
                    ))
                    if policy.early_out and counts[f] >= early_out_threshold:
                        phase_early_out = True
                    if len(matches) >= policy.max_instances:
                        publish()
                        return matches
                if phase_early_out:
                    break  # impl/scene.hpp:341-347
            if not phase_accepted:
                break  # the full no-match budget is spent (impl/scene.hpp:70-73)
        publish()
        return matches


LAST_MULTI_SEARCH_STATS: list = []


def find_all_multi(models: list[CompiledModel], scene_cloud: cl.PointCloud, *,
                   raycast_origins: np.ndarray | None = None, min_cast_score: float | None = None,
                   point_radius: float | None = None, depth_tolerance: float | None = None,
                   policy: SearchPolicy = DEFAULT_POLICY, prep: ScenePrep | None = None,
                   mesh=None, **kwargs) -> list[list[Match]]:
    """Search several models in one scene (BASELINE config 5), on the first
    model's device.

    One ``prepare_scene`` (or the caller's ``prep``) serves every model.  The
    models search in order over a shared consumed-points mask: a scene point
    claimed by one model's kept match is invalid, and no edge, in the prep
    the later models search (the multi-model extension of the masking
    protocol, impl/scene.hpp:87-93); each model's ``find_all`` takes its fog
    switch on that prep.  With ``raycast_origins`` each match is verified
    (``verify/raycast.py``) against the unpatched scene, so a point claimed
    by one model still occludes for the next: ``cast_score`` = matched
    visible model points / model points visible from any origin, and matches
    below ``min_cast_score`` are dropped (``None`` keeps every match,
    annotated).  ``point_radius`` and ``depth_tolerance`` default to the
    model's resolution and twice it.  Keyword arguments pass to ``find_all``.

    ``LAST_MULTI_SEARCH_STATS`` gets one dict per model: ``find_all``'s
    ``LAST_SEARCH_STATS`` (the six ``*_kernel_launches`` included) plus
    ``search_s`` and, with origins, ``raycast_s`` and ``cast_survivors`` (the
    cone cull's survivors per cast, origin by origin for each match).
    ``mesh`` goes to the scene preparation and to every model's search
    (each match is raycast on every rank, from the replicated matches).
    """
    from triplet_match_tpu_torch.verify.raycast import cast_score_matched, cast_visibility_multi

    if prep is None:
        with strict_fp32():
            prep = prepare_scene(scene_cloud.to(models[0].cloud.device), policy, mesh=mesh)
    consumed: torch.Tensor | None = None
    all_matches: list[list[Match]] = []
    LAST_MULTI_SEARCH_STATS.clear()
    for model in models:
        prep_m = prep
        if consumed is not None:
            prep_m = ScenePrep(cloud=dataclasses.replace(prep.cloud,
                                                         valid=prep.cloud.valid & ~consumed),
                               tangent_mask=prep.tangent_mask & ~consumed, n_edge=prep.n_edge)
        t0 = time.perf_counter()
        matches = find_all(model, scene_cloud, policy=policy, prep=prep_m, mesh=mesh, **kwargs)
        mstats = dict(LAST_SEARCH_STATS)
        mstats["search_s"] = time.perf_counter() - t0
        LAST_MULTI_SEARCH_STATS.append(mstats)
        if raycast_origins is not None:
            t0 = time.perf_counter()
            res = float(model.resolution)
            pr = point_radius if point_radius is not None else res
            dt = depth_tolerance if depth_tolerance is not None else 2.0 * res
            cast_stats: dict = {"survivors": []}
            kept = []
            for m in matches:
                vis = cast_visibility_multi(raycast_origins, model.cloud.xyz, model.cloud.valid,
                                            torch.as_tensor(m.transform), prep.cloud.xyz,
                                            prep.cloud.valid, pr, dt, stats=cast_stats)
                m.cast_score = float(cast_score_matched(vis, m.model_corrs))
                if min_cast_score is None or m.cast_score >= min_cast_score:
                    kept.append(m)
            matches = kept
            mstats["raycast_s"] = time.perf_counter() - t0
            mstats["cast_survivors"] = cast_stats["survivors"]
        if consumed is None:
            consumed = torch.zeros(prep.cloud.capacity, dtype=torch.bool,
                                   device=prep.cloud.device)
        for m in matches:
            consumed[torch.as_tensor(m.scene_corrs, dtype=torch.long,
                                     device=consumed.device)] = True
        all_matches.append(matches)
    return all_matches


def instantiate(model: CompiledModel, match: Match, instantiate_all: bool = True) -> np.ndarray:
    """Place the model into the scene under a match transform
    (``scene::instantiate``, impl/scene.hpp:512-531): every valid model point,
    or with ``instantiate_all=False`` the match's model corrs."""
    xyz = model.cloud.xyz.cpu().numpy()
    idx = (np.flatnonzero(model.cloud.valid.cpu().numpy()) if instantiate_all
           else match.model_corrs)
    return xyz[idx] @ match.transform[:3, :3].T + match.transform[:3, 3]
