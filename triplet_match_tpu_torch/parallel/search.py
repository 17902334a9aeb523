"""Hypothesis-parallel search round and the sharded finish_find (counterpart
of ``triplet_match_tpu.parallel.search``).

* **Hypothesis data parallelism** (the ``std::async`` chunking,
  include/impl/scene.hpp:146-166): every rank runs the sampling and scoring
  body on its own RANSAC chunk (its own ``RoundDraws``), keeps its local top-F
  finalists, and the finalists, first-sample marks and hypothesis counts are
  all-gathered for the replicated ICP and acceptance: the reference's
  fan-out / join, with the mutex-guarded ``fp_mask_`` merge replaced by the
  gathered first marks.
* **Scene-point sharding**: ``finish_find_sp`` scores a pose against a scene
  sharded over the mesh; correspondences stay shard-local and score / count
  are summed over the shards.
"""

from __future__ import annotations

import torch

from triplet_match_tpu_torch.config import DiscretizationParams, SampleParams, SearchPolicy
from triplet_match_tpu_torch.parallel.distributed import make_global_array, make_global_cloud
from triplet_match_tpu_torch.parallel.mesh import MeshAxis, all_gather, psum
from triplet_match_tpu_torch.search.driver import finalize_round, hypothesize_and_score
from triplet_match_tpu_torch.search.score import DenseCorrs, finish_find


def search_round_dp(mesh, model, prep, consumed, fp_mask, draws, dist_thres, model_match_factor,
                    mpack=None, *, discretization: DiscretizationParams,
                    sample_params: SampleParams, policy: SearchPolicy,
                    max_icp_iterations: int):
    """One search round, hypothesis-parallel over the 1-axis ``mesh``.

    ``draws``: one ``RoundDraws`` per rank, in rank order; each rank samples
    ``policy.num_first_samples`` firsts of its own, so the round's batch is
    B1 x ranks.  The finalists join by score (ties to the lower rank, then
    the lower hypothesis, as ``lax.top_k`` over the gathered list).  Returns
    (RoundResult, consumed', fp'), the same on every rank.
    """
    axis = mesh.mesh_dim_names[0]
    fin = policy.finalists
    with torch.profiler.record_function("hypothesize"):
        ts_flat, scores, first_idx, first_valid, n_hyp = hypothesize_and_score(
            model, prep, consumed, fp_mask, draws[mesh.get_local_rank(axis)], dist_thres, mpack,
            discretization=discretization, sample_params=sample_params, policy=policy)
    with torch.profiler.record_function("finalize"):
        best = torch.sort(scores, descending=True, stable=True)[1][:fin]
        t_all = all_gather(ts_flat[best], mesh, axis)
        s_all = all_gather(scores[best], mesh, axis)
        fi_all = all_gather(first_idx, mesh, axis)
        fv_all = all_gather(first_valid, mesh, axis)
        n_hyp_all = psum(n_hyp, mesh, axis)
        gbest = torch.sort(s_all, descending=True, stable=True)[1][:fin]
        return finalize_round(model, prep, consumed, fp_mask, t_all[gbest], fi_all, fv_all,
                              n_hyp_all, dist_thres, model_match_factor, policy=policy,
                              max_icp_iterations=max_icp_iterations)


def finish_find_sp(mesh, model, scene, tangent_mask, consumed, t, dist_thres) -> DenseCorrs:
    """``finish_find`` with the scene points sharded over the 1-axis ``mesh``.

    Every rank passes the full scene and masks; each scores its own shard
    (the capacity must be divisible by the mesh size), and score and count
    sum over the shards.  The per-point outputs are this rank's shard."""
    axis = mesh.mesh_dim_names[0]
    return finish_find(model, make_global_cloud(mesh, scene, axis),
                       make_global_array(mesh, tangent_mask, axis),
                       make_global_array(mesh, consumed, axis), t, dist_thres,
                       group=MeshAxis(mesh, axis))
