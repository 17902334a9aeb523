"""2-D / 3-D mesh search: hypothesis data parallelism x scene sharding
(counterpart of ``triplet_match_tpu.parallel.search2d``).

Extends the 1-D round of ``parallel/search.py`` to a ("dp", "sp") mesh,
optionally prefixed by a "dcn" axis:

* the **dp** axis replays the reference's ``std::async`` chunking
  (impl/scene.hpp:146-166): each dp coordinate samples its own RANSAC chunk
  and the finalists join over dp;
* the **sp** axis shards every scene-length tensor (positions, normals,
  tangents, masks): within a dp coordinate the sp ranks cooperate on the SAME
  sample set, each scanning only its shard;
* the optional **dcn** axis (the JAX package's multi-slice axis, here another
  node or group of cards) runs extra chunks, and the finalist join is
  hierarchical: top-F over dp first, then one small all-gather of F poses
  per dcn coordinate, so the slow hop carries F poses per round, never scene
  data.

Cooperation without replicating the scene needs every random choice to be a
pure function of (chunk draws, global point index): ``sampling.hash_uniform``
priorities of the global index make the first samples and the balls
shard-invariant, and ``_merge_sp_topk`` breaks priority ties by shard, then
by local order (the global index order), as ``lax.top_k`` does over the
gathered slots; so a (1, 1), a (1, 2) and a (2, 4) mesh draw the same samples
for the same draws.

One round, on every rank:
  1. firsts:   local top-B1 by hash priority -> merged over sp
  2. balls:    ops.knn.radius_sample on the LOCAL shard with global-index
               priorities -> per-first top-K merged over sp, carrying the 8
               group channels the kernels read, and the second pool likewise
  3. pairs:    gates / features / query / poses on the replicated samples
  4. ranking:  score_kernel.rank_groups on the merged groups (the kernels)
  5. join:     local top-F -> all_gather(dp) -> top-F [-> all_gather(dcn)]
  6. finalize: driver.accept_and_polish with the sp group (every count,
               score and fit summed over the shards); first marks OR-reduced
               over (dcn, dp).
"""

from __future__ import annotations

import torch

from triplet_match_tpu_torch.config import DiscretizationParams, SampleParams, SearchPolicy
from triplet_match_tpu_torch.ops.knn import radius_sample
from triplet_match_tpu_torch.parallel.distributed import shard_bounds
from triplet_match_tpu_torch.parallel.mesh import (  # noqa: F401 (the axis names live here too)
    DCN_AXIS,
    DP_AXIS,
    SP_AXIS,
    MeshAxis,
    all_gather,
    init_mesh,
    por,
    psum,
)
from triplet_match_tpu_torch.search import score_kernel as sk
from triplet_match_tpu_torch.search.driver import (
    RoundResult,
    _f32,
    _rank_on_all,
    accept_and_polish,
    pose_hypotheses,
)
from triplet_match_tpu_torch.search.sampling import hash_uniform

_INF = 3.0e38


def make_mesh_2d(dp: int, sp: int, *, device_type=None):
    """(dp, sp) mesh over the first dp x sp ranks."""
    return init_mesh((dp, sp), (DP_AXIS, SP_AXIS), device_type)


def make_mesh_3d(dcn: int, dp: int, sp: int, *, device_type=None):
    """(dcn, dp, sp) mesh; with torchrun's rank order the last two axes stay
    within a node and dcn crosses nodes."""
    return init_mesh((dcn, dp, sp), (DCN_AXIS, DP_AXIS, SP_AXIS), device_type)


def _merge_sp_topk(mesh, prio: torch.Tensor, k: int, *vals):
    """Merge per-shard candidate lists into the global top-k by priority.

    prio: [..., kl] local candidate priorities (ascending = better); vals:
    tensors [..., kl] or [..., kl, C] carried alongside.  Ties go to the
    earlier gathered slot (shard order, then local order), as ``lax.top_k``
    resolves them; when the shards hold fewer than k candidates in all, the
    result is padded with ``_INF`` priorities and zero values.  Returns
    (prio [..., k], [vals']), the same on every sp rank.
    """
    ax = prio.dim() - 1
    pr = all_gather(prio, mesh, SP_AXIS, axis=ax)
    kk = min(k, pr.shape[ax])
    merged, slots = torch.sort(pr, dim=ax, stable=True)
    merged, slots = merged[..., :kk], slots[..., :kk]
    out = []
    for v in vals:
        vg = all_gather(v, mesh, SP_AXIS, axis=ax)
        sl = slots.reshape(slots.shape + (1,) * (v.dim() - prio.dim()))
        out.append(torch.gather(vg, ax, sl.expand(slots.shape + v.shape[prio.dim():])))
    if kk < k:
        pad = k - kk
        merged = torch.cat([merged, merged.new_full(merged.shape[:ax] + (pad,), _INF)], ax)
        out = [torch.cat([v, v.new_zeros(v.shape[:ax] + (pad,) + v.shape[ax + 1:])], ax)
               for v in out]
    return merged, out


def search_round_2d_prep(mesh, model, prep, consumed, fp_mask, draws, dist_thres,
                         model_match_factor, mpack=None, **kw):
    """``driver.search_round``'s signature over ``search_round_2d``: the
    ``find_all`` round of a 2- or 3-axis mesh."""
    return search_round_2d(mesh, model, prep.cloud, prep.tangent_mask, consumed, fp_mask, draws,
                           dist_thres, model_match_factor, mpack, **kw)


def search_round_2d(mesh, model, cloud, tangent_mask, consumed, fp_mask, draws, dist_thres,
                    model_match_factor, mpack, *, discretization: DiscretizationParams,
                    sample_params: SampleParams, policy: SearchPolicy,
                    max_icp_iterations: int):
    """One search round on a (dp, sp) or (dcn, dp, sp) mesh.

    Every rank passes the full, replicated scene, masks and ``draws`` (one
    ``RoundDraws`` per chunk, chunk ``dcn_i * dp + dp_i``) and works on its sp
    shard of the scene.  Returns (RoundResult, consumed', fp'), the same on
    every rank: whenever sp > 1 the per-point outputs are all-gathered over
    sp (the JAX package's ``replicate_outputs=True``), so the host loop reads
    only replicated values.  A (1, 1) mesh repeats the single-device
    ``search_round`` with ``draws[0]``: the same samples, counts and accept
    decisions, poses within float tolerance.
    """
    names = mesh.mesh_dim_names
    has_dcn = DCN_AXIS in names
    dp_ext = mesh.size(names.index(DP_AXIS))
    b1, b2 = policy.num_first_samples, policy.num_second_samples
    qcap, ks, fin = policy.query_cap, policy.score_neighbors, policy.finalists
    hyp_axes = (DCN_AXIS, DP_AXIS) if has_dcn else DP_AXIS

    chunk = mesh.get_local_rank(DP_AXIS)
    if has_dcn:
        chunk += mesh.get_local_rank(DCN_AXIS) * dp_ext
    d = draws[chunk]
    offset, nl = shard_bounds(mesh, cloud.capacity)
    sl = slice(offset, offset + nl)
    xyz, tangent, valid = cloud.xyz[sl], cloud.tangent[sl], cloud.valid[sl]
    shard = type(cloud)(xyz, cloud.normal[sl], tangent, valid)
    tm, cons, fpl = tangent_mask[sl], consumed[sl], fp_mask[sl]
    gidx = offset + torch.arange(nl, device=xyz.device)
    thres = _f32(dist_thres) * _f32(model.resolution)
    blk = min(b1, 256)

    with torch.profiler.record_function("hypothesize"):
        # --- 1. firsts: local top-B1 by hash priority, merged over sp ---
        eligible_first = tm & ~cons & ~fpl & valid
        pr1 = torch.where(eligible_first, hash_uniform(d.first_words, gidx), _INF)
        kl = min(b1, nl)
        lp, li = torch.sort(pr1, stable=True)
        fpr, (f_gidx, f_xyz, f_tan) = _merge_sp_topk(mesh, lp[:kl], b1, gidx[li[:kl]],
                                                     xyz[li[:kl]], tangent[li[:kl]])
        firsts_valid = fpr < _INF

        # --- 2. the scoring ball (any kind) and the second pool, merged ---
        nb_idx, nb_ok = radius_sample(f_xyz, xyz, valid, model.diameter, ks,
                                      hash_uniform(d.nbr_words, gidx), block=blk)
        nb_pr = torch.where(nb_ok, hash_uniform(d.nbr_words, gidx[nb_idx]), _INF)
        ch = sk.group_channels(shard, tm, cons, nb_idx, nb_ok,
                               samples_on_all=_rank_on_all(policy))  # [B1, K, 8]
        _, (ch_m,) = _merge_sp_topk(mesh, nb_pr, ks, ch)
        groups = ch_m.transpose(1, 2).contiguous()  # [B1, 8, K]

        second_eligible = tm & ~cons & valid
        pl_idx, pl_ok = radius_sample(f_xyz, xyz, second_eligible, model.diameter,
                                      policy.second_pool, hash_uniform(d.pool_words, gidx),
                                      block=blk)
        pl_pr = torch.where(pl_ok, hash_uniform(d.pool_words, gidx[pl_idx]), _INF)
        pl_ch = torch.cat([xyz[pl_idx], tangent[pl_idx]], dim=-1)  # [B1, P, 6]
        pl_prm, (pl_chm, pl_gidx) = _merge_sp_topk(mesh, pl_pr, policy.second_pool, pl_ch,
                                                   gidx[pl_idx])

        # --- seconds: B2 distinct Gumbel draws from the merged pool ---
        sec_elig = (pl_prm < _INF) & (pl_gidx != f_gidx[:, None]) & firsts_valid[:, None]
        gs = torch.where(sec_elig, d.gumbel, -float("inf"))
        top, slots = torch.sort(gs, dim=1, descending=True, stable=True)
        top, slots = top[:, :b2], slots[:, :b2]
        sec = torch.gather(pl_chm, 1, slots[..., None].expand(b1, b2, 6))
        sec_valid = torch.gather(sec_elig, 1, slots) & torch.isfinite(top)

        # --- 3. pairs -> poses; 4. ranking through the kernels ---
        ts, hyp_ok = pose_hypotheses(model, f_xyz[:, None, :], f_tan[:, None, :],
                                     sec[..., 0:3], sec[..., 3:6], sec_valid,
                                     discretization=discretization,
                                     sample_params=sample_params, policy=policy)
        rows = sk.poses_to_rows(ts.reshape(b1, b2 * qcap, 4, 4))
        scores = sk.rank_groups(mpack, groups, rows, float(thres * thres),
                                hyp_ok.reshape(b1, b2 * qcap), policy).reshape(-1)
        # hyp_ok is the same on every sp rank (built from merged samples)
        n_hyp = hyp_ok.sum()

    with torch.profiler.record_function("finalize"):
        # --- 5. finalist join over dp, then one F-pose hop over dcn ---
        best = torch.sort(scores, descending=True, stable=True)[1][:fin]
        t_all = all_gather(ts.reshape(-1, 4, 4)[best], mesh, DP_AXIS)
        s_all = all_gather(scores[best], mesh, DP_AXIS)
        gbest = torch.sort(s_all, descending=True, stable=True)[1][:fin]
        t_best = t_all[gbest]
        if has_dcn:
            t_x = all_gather(t_best, mesh, DCN_AXIS)
            s_x = all_gather(s_all[gbest], mesh, DCN_AXIS)
            t_best = t_x[torch.sort(s_x, descending=True, stable=True)[1][:fin]]
        n_hyp_all = psum(n_hyp, mesh, hyp_axes)

        # --- 6. ICP + greedy acceptance + gated polish over the sp shards ---
        (t_fin, accept, new_corr, corr_midx, counts, fin_scores, consumed_next,
         join_overflow) = accept_and_polish(
            model, shard, tm, cons, t_best, dist_thres, model_match_factor, policy=policy,
            max_icp_iterations=max_icp_iterations, group=MeshAxis(mesh, SP_AXIS))

        # first marks of this shard's sampled firsts, OR-reduced over the chunks
        f_local = f_gidx - offset
        in_shard = (f_local >= 0) & (f_local < nl) & firsts_valid
        marks = torch.zeros(nl + 1, dtype=torch.bool, device=xyz.device)
        marks[torch.where(in_shard, f_local, nl)] = True
        fp_next = fpl | por(marks[:nl], mesh, hyp_axes)

        # replicate the per-point outputs: the host loop reads them whole
        new_corr = all_gather(new_corr, mesh, SP_AXIS, axis=1)
        corr_midx = all_gather(corr_midx, mesh, SP_AXIS, axis=1)
        consumed_next = all_gather(consumed_next, mesh, SP_AXIS)
        fp_next = all_gather(fp_next, mesh, SP_AXIS)
        result = RoundResult(t_fin, accept, new_corr, corr_midx, counts, fin_scores, n_hyp_all,
                             join_overflow)
        return result, consumed_next, fp_next
