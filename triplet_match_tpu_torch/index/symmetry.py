"""Model self-symmetry detection and symmetry-aware match comparison
(counterpart of ``triplet_match_tpu.index.symmetry``).

Symmetric models (boxes, cylinders, gears) produce matches anywhere on the
symmetry orbit: pair features cannot tell a pose from pose @ S when S maps the
model onto itself (the reference's matcher returns an arbitrary orbit member).
``detect_self_symmetries`` registers the model against its own cloud through
the regular hypothesis machinery and returns the orbit of rigid self-maps;
``symmetry_equivalent`` compares two poses modulo that orbit.  The reference
has no symmetry handling.
"""

from __future__ import annotations

import dataclasses

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
from triplet_match_tpu_torch.index.model import CompiledModel


def _rot_angle_deg(r: np.ndarray) -> float:
    c = np.clip((np.trace(r) - 1.0) * 0.5, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


def detect_self_symmetries(model: CompiledModel,
                           discretization: DiscretizationParams = DEFAULT_DISCRETIZATION,
                           sample_params: SampleParams = DEFAULT_SAMPLE_PARAMS,
                           policy: SearchPolicy = DEFAULT_POLICY, *, seed: int = 0,
                           rounds: int = 2, min_overlap: float = 0.8,
                           angle_tol_deg: float = 8.0, trans_tol_factor: float = 2.0,
                           max_orbit: int = 16, refine_budget: int = 48,
                           generator: torch.Generator | None = None,
                           round_draws=None) -> np.ndarray:
    """Rigid self-maps of the model: [K, 4, 4] float32 with S @ model ~= model,
    the identity always first.

    Runs the search's sample -> query -> base_transform -> score machinery
    (``driver.hypothesize_and_score`` on the voxel-LUT scorer,
    ``scorer="jnp"``, single-phase) with the model cloud as its own scene,
    converges candidate poses onto their exact self-map with two chained ICP
    passes (four tight iterations each), verifies each with a full
    ``finish_find`` and dedups by rotation / translation distance.  Coverage
    is measured against the identity's own (finite sampling and tangent-kind
    boundaries keep even exact symmetries below 100 %): a pose is kept with
    count >= ``min_overlap`` * count(I).

    Each round's random inputs are one ``RoundDraws``: from ``round_draws``
    (a sequence, one per round) when given, else drawn from ``generator`` (a
    CPU generator, default seeded with ``seed``).  Runs on the model's
    device under ``strict_fp32``.
    """
    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.refine.icp import icp_refine
    from triplet_match_tpu_torch.search.driver import ScenePrep, hypothesize_and_score
    from triplet_match_tpu_torch.search.sampling import draw_round
    from triplet_match_tpu_torch.search.score import finish_find

    dev = model.cloud.device
    # the model cloud as a scene: its edge mask is the compiled edge subset
    prep = ScenePrep(cloud=model.cloud, tangent_mask=model.edge, n_edge=model.n_edge)
    n = model.cloud.capacity
    consumed = torch.zeros(n, dtype=torch.bool, device=dev)
    fp = torch.zeros(n, dtype=torch.bool, device=dev)
    # the voxel-LUT scorer: symmetry detection runs once per model, offline
    pol = dataclasses.replace(policy, scorer="jnp", two_phase_scoring=False)
    thres = pol.corr_dist_factor
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)

    def coverage(t: np.ndarray) -> int:
        tt = torch.as_tensor(t, dtype=torch.float32, device=dev)[None]
        return int(finish_find(model, model.cloud, model.edge, consumed, tt, thres).count[0])

    def refine(t: np.ndarray) -> np.ndarray:
        # ICP against the model's own cloud: candidates converge onto the exact
        # orbit element (and near-identity jitter onto I, so the dedup is
        # sharp); two chained passes, since one can stall a few degrees off on
        # models with near-symmetric faces
        tt = torch.as_tensor(t, dtype=torch.float32, device=dev)[None]
        for _ in range(2):
            tt = icp_refine(model, model.cloud, model.edge, consumed, tt, thres, 10,
                            tight_iterations=4).transform
        return tt[0].cpu().numpy().astype(np.float32)

    orbit = [np.eye(4, dtype=np.float32)]
    trans_tol = trans_tol_factor * float(model.resolution)

    def in_orbit(t):
        for s in orbit:
            d_r = _rot_angle_deg(t[:3, :3] @ s[:3, :3].T)
            d_t = float(np.linalg.norm(t[:3, 3] - s[:3, 3]))
            if d_r < angle_tol_deg and d_t < trans_tol:
                return True
        return False

    with strict_fp32():
        cov_id = max(coverage(np.eye(4, dtype=np.float32)), 1)  # identity self-coverage
        for rnd in range(rounds):
            draws = (round_draws[rnd] if round_draws is not None else
                     draw_round(gen, pol.num_first_samples, pol.second_pool, dev))
            ts_flat, scores, _, _, _ = hypothesize_and_score(
                model, prep, consumed, fp, draws, thres, None, discretization=discretization,
                sample_params=sample_params, policy=pol)
            order = np.argsort(-scores.cpu().numpy())
            cand = ts_flat.cpu().numpy()[order]
            budget = refine_budget
            for t in cand:
                if len(orbit) >= max_orbit or budget == 0:
                    break
                if in_orbit(t):
                    continue
                budget -= 1
                t_ref = refine(t)
                if in_orbit(t_ref):
                    continue
                if coverage(t_ref) / cov_id >= min_overlap:
                    orbit.append(t_ref)
    return np.stack(orbit)


def symmetry_equivalent(t1, t2, orbit: np.ndarray, *, angle_tol_deg: float = 5.0,
                        trans_tol: float = 1e-2) -> bool:
    """True when two model -> scene poses place the model identically modulo
    the symmetry orbit: t2 ~= t1 @ S for some S in the orbit."""
    t1 = np.asarray(t1)
    t2 = np.asarray(t2)
    rel = np.linalg.inv(t1) @ t2  # model-space self-map
    for s in np.asarray(orbit):
        d_r = _rot_angle_deg(rel[:3, :3] @ s[:3, :3].T)
        d_t = float(np.linalg.norm(rel[:3, 3] - s[:3, 3]))
        if d_r < angle_tol_deg and d_t < trans_tol:
            return True
    return False
