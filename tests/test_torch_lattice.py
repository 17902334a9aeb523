"""The graded lattice (the recall protocol's wire-frame scaffold,
``scripts/recall_study.py --model lattice``) served by the port's
``api.Matcher`` on the CPU, checked by the benchmark's plain reference
(``benchmark/tmbench/reference.py``, float64 PyTorch, nothing of the port
imported): its voxel table on each route against the reference's
brute-force table rule, the join's orbit step on poses turned by the
lattice's own symmetry, and its matches against the limits of the
benchmark's lattice cell."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from triplet_match_tpu_torch import api, config as tcfg
from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.index import model as tmodel
from triplet_match_tpu_torch.core.transforms import strict_fp32
from triplet_match_tpu_torch.io import synthetic as tsyn
from triplet_match_tpu_torch.ops import jfa
from triplet_match_tpu_torch.search import driver

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "benchmark"))

from tmbench import reference, synthetic  # noqa: E402
from tmbench.traffic import Scan  # noqa: E402

torch.set_num_threads(2)

# the recall protocol's settings, the lattice cell's policy fields, and the
# 1 mm / 0.5 deg, exact-table limits the benchmark holds the cell to
FIND = {"dist_thres": 3.0, "model_match_factor": 0.5, "max_icp_iterations": 10}
CELL_POLICY = json.loads((REPO / "benchmark/configs/lattice-matcher.json").read_text())["policy"]
LIMITS = json.loads((REPO / "benchmark/limits/lattice-matcher.fog131k.json").read_text())
SAMPLE = tcfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
DISC = tcfg.DiscretizationParams()


def _lattice(n_edge, cells=4):
    return tsyn.make_lattice_model(cells=cells, n_edge=n_edge, graded=True, seed=0)


# the CPU's small lattice: 16 points a beam (an 86^3 table, brute); its
# sparse beams need a smaller curvature neighbourhood for the edge test, and
# the search a smaller batch; the fog route forced, as the 131k scans take it.
# Orbit index 0: the pose is not one of the box's flips, nor a 120-degree turn
# about (1, 1, 1), which maps the lattice onto itself (the reference forgives
# only the box's flips)
SMALL_POLICY = dict(curvature_k=10, num_first_samples=64,
                    num_second_samples=16, score_neighbors=256, max_rounds=2,
                    adaptive_second_samples=False, fine_full_rescore_ratio=0.0)


def _off_rule(m, arrays):
    """Share of the table's voxels whose entry is farther than
    ``reference.TABLE_EPS`` beyond the nearest model point to the voxel's
    sample point, both taken by the reference in float64 on its own grid."""
    mref = reference.ModelRef(arrays, FIND["dist_thres"], "cpu")
    assert m.extents == tuple(int(e) for e in mref.extents)
    ijk = torch.stack(torch.meshgrid(*(torch.arange(e, dtype=torch.float64) for e in m.extents),
                                     indexing="ij"), -1).reshape(-1, 3)
    c = (ijk - mref.offset) / mref.scale
    x64 = torch.as_tensor(np.asarray(arrays[0], np.float64))
    got = torch.linalg.vector_norm(c - x64[m.lut.reshape(-1)], dim=-1)
    return float((got > mref.nearest_dist(c) + reference.TABLE_EPS).double().mean())


# the small lattice's grid is 86^3 = 636,056 voxels: a threshold under it sends
# it down the route of grids above 2M voxels
FLOOD_THRESHOLD = 100_000


@pytest.mark.parametrize("route", ["brute", "exact_lut"])
def test_lattice_table_meets_the_reference_rule(route, monkeypatch):
    """Every voxel of the small lattice's table holds a model point within
    ``reference.TABLE_EPS`` of the nearest: on the brute route (every grid
    up to ``_LUT_JFA_THRESHOLD`` voxels), and with ``exact_lut`` on the
    route of the grids above it."""
    arrays = _lattice(1200)
    policy = tcfg.SearchPolicy()
    if route == "exact_lut":
        monkeypatch.setattr(tmodel, "_LUT_JFA_THRESHOLD", FLOOD_THRESHOLD)
        policy = tcfg.SearchPolicy(exact_lut=True)
    m = tmodel.compile_model(PointCloud.from_arrays(*arrays, device="cpu"), DISC, SAMPLE, policy)
    assert (int(np.prod(m.extents)) > tmodel._LUT_JFA_THRESHOLD) == (route == "exact_lut")
    assert _off_rule(m, arrays) == 0.0


def test_flood_table_is_unchanged_without_exact_lut(monkeypatch):
    """Without ``exact_lut`` a grid above the threshold is the jump flood's
    table, as the JAX package builds it, and the reference finds voxels of
    it off the table rule."""
    monkeypatch.setattr(tmodel, "_LUT_JFA_THRESHOLD", FLOOD_THRESHOLD)
    arrays = _lattice(1200)
    cloud = PointCloud.from_arrays(*arrays, device="cpu")
    m = tmodel.compile_model(cloud, DISC, SAMPLE, tcfg.SearchPolicy())
    flood = jfa.nearest_point_volume(m.cloud.xyz, m.cloud.valid, m.to_voxel, extents=m.extents)
    assert torch.equal(m.lut, flood)
    assert _off_rule(m, arrays) > 0.01


def test_orbit_step_turns_a_turned_pose_back():
    """``resolve_symmetry``: Model.init finds the lattice's two 120-degree
    turns about (1, 1, 1), and the join's orbit step, then its tight polish,
    bring the truth and both of its turns onto the truth's own pose."""
    arrays = _lattice(1200)
    policy = tcfg.SearchPolicy(**SMALL_POLICY, **CELL_POLICY)
    model = api.Model(PointCloud.from_arrays(*arrays, device="cpu"), DISC, policy).init(SAMPLE)
    cm = model.compiled
    deg = np.degrees(np.arccos(np.clip(
        (np.trace(cm.orbit[:, :3, :3].numpy(), axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert deg[0] == 0 and int((np.abs(deg - 120) < 1).sum()) == 2
    x, n, t, t_gt = synthetic.recall_scene_arrays(16384, 1, arrays)
    scene = PointCloud.from_arrays(x, n, t, device="cpu")
    tmask = torch.linalg.vector_norm(scene.tangent, dim=-1) > 0.7
    free = torch.zeros(scene.capacity, dtype=torch.bool)
    c3 = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)  # x -> y -> z -> x
    poses = []
    for r in (np.eye(3, dtype=np.float32), c3, c3 @ c3):
        g = t_gt.copy()
        g[:3, :3] = g[:3, :3] @ r
        poses.append(np.linalg.inv(g.astype(np.float64)).astype(np.float32))  # scene -> model
    with strict_fp32():
        t = driver.resolve_orbit(cm, scene, tmask, free, torch.as_tensor(np.stack(poses)),
                                 torch.ones(3, dtype=torch.bool), FIND["dist_thres"], policy)
        t = driver.tight_polish(cm, scene, tmask, free, t, FIND["dist_thres"],
                                iterations=policy.tight_icp_iterations,
                                orientation_weight=policy.tight_orientation_weight,
                                anneal=policy.tight_anneal,
                                edges_only=bool(policy.tight_edges_only),
                                point_to_line_at_floor=bool(policy.tight_point_to_line))
    for k in range(3):
        mm, deg_k, orbit_k = synthetic.sym_pose_error(np.linalg.inv(t[k].double().numpy()), t_gt)
        assert orbit_k == 0 and mm * 1e3 <= LIMITS["pose_mm"] and deg_k <= LIMITS["pose_deg"]


def test_lattice_matcher_meets_the_fog_cells_limits():
    arrays = _lattice(1200)
    policy = tcfg.SearchPolicy(**SMALL_POLICY, **CELL_POLICY)
    model = api.Model(PointCloud.from_arrays(*arrays, device="cpu"), DISC, policy).init(SAMPLE)
    assert int(np.prod(model.compiled.extents)) <= tmodel._LUT_JFA_THRESHOLD
    matcher = api.Matcher(model, policy=policy)
    x, n, t, t_gt = synthetic.recall_scene_arrays(16384, 0, arrays)
    res = matcher.match(PointCloud.from_arrays(x, n, t, device="cpu"), sample_params=SAMPLE,
                        seed=5, **FIND)
    assert driver.LAST_SEARCH_STATS["fine_rescore_full"]
    answer = [[{"transform": np.asarray(m.transform), "scene_corrs": np.asarray(m.scene_corrs),
                "model_corrs": np.asarray(m.model_corrs), "signed_score": float(m.signed_score)}
               for m in res]]
    mref = reference.ModelRef(arrays, FIND["dist_thres"], "cpu")
    readings = reference.check_request([mref], Scan(0, x, n, t, [(0, t_gt)]), answer, "cpu")
    correct, rows = reference.judge(readings, LIMITS)
    assert correct, rows
    assert [synthetic.sym_pose_error(m["transform"], t_gt)[2] for m in answer[0]] == [0]
