"""The join's pose fit (``refine.icp._fit``) on the CPU.

On a CPU tensor every fit of ``icp_refine`` and ``tight_polish`` is the plain
fit (``_fit_plain``: ``weighted_kabsch`` or ``gauss_newton_pose_step`` with
the polish's weights) and launches nothing; ``fit_check.fit_float64``, the
plain fit widened to float64 that ``csrc/join_fit.cu`` is held to on the
card, stays near it; the kernel's wrapper refuses layouts and dtypes it does
not take before it touches a card.  The kernel itself is held to the float64 fit on the card in
``tests/test_torch_kernels_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from triplet_match_tpu_torch import config as cfg
from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.core.transforms import strict_fp32
from triplet_match_tpu_torch.index.model import compile_model
from triplet_match_tpu_torch.io.synthetic import embed_in_scene, make_box_model
from triplet_match_tpu_torch.refine import fit_check, icp
from triplet_match_tpu_torch.search import driver
from triplet_match_tpu_torch.search.score import DenseCorrs, finish_find

torch.set_num_threads(2)

SAMPLE = cfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
DIST = 3.0
# the join's fits: the relaxed ICP's Kabsch, the polish's orientation-weighted
# Kabsch (with and without the raw-edge weights), its Gauss-Newton steps
MODES = {"relaxed": dict(), "orient": dict(orientation_weight=True, keep=True),
         "edges": dict(edges_only=True, orientation_weight=True, keep=True),
         "p2l": dict(gauss_newton=True, edges_only=True, orientation_weight=True, keep=True),
         "p2p": dict(gauss_newton=True, keep=True)}


@pytest.fixture(scope="module")
def box():
    """A box in clutter and six poses near the truth (jittered)."""
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    model = compile_model(PointCloud.from_arrays(xyz, nrm, tan, device="cpu"),
                          cfg.DiscretizationParams(), SAMPLE, cfg.SearchPolicy(), pair_block=128)
    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=300, seed=7,
                                    device="cpu")
    prep = driver.prepare_scene(scene, cfg.SearchPolicy())
    rng = np.random.default_rng(5)
    ts = np.tile(np.linalg.inv(t_gt).astype(np.float32), (6, 1, 1))
    ts[:, :3, 3] += rng.normal(0, 0.004, (6, 3)).astype(np.float32)
    return model, prep, torch.from_numpy(ts)


def _case(box, layout, mode):
    """(model, scene, tangent mask, poses, corrs) of one fit: the corrs of the
    step's own scoring pass (the relaxed gate, or the polish's exact lookup),
    on the whole scene or on per-pose candidate subsets."""
    model, prep, ts = box
    scene, tm = prep.cloud, prep.tangent_mask
    if MODES[mode].get("edges_only"):
        tm = torch.linalg.vector_norm(scene.tangent, dim=-1) > 0.7
    consumed = torch.zeros(scene.capacity, dtype=torch.bool)
    t = ts[:4]
    if layout == "subset":
        scene, tm, consumed, _, _, _ = driver._candidate_subset(model, scene, tm, consumed, t,
                                                                DIST, 256, 1.0)
    relaxed = mode == "relaxed"
    corrs = finish_find(model, scene, tm, consumed, t, 2.0 * DIST if relaxed else DIST,
                        exact=not relaxed)
    return model, scene, tm, t, corrs


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layout", ["shared", "subset"])
def test_fit_on_the_cpu_is_the_plain_fit(box, layout, mode, monkeypatch):
    """``_fit`` on CPU tensors calls the plain functions, launches nothing
    and returns ``_fit_plain``'s poses; the float64 fit stays within float32
    rounding of them."""
    model, scene, tm, t, corrs = _case(box, layout, mode)
    called = []
    for name in ("weighted_kabsch", "gauss_newton_pose_step"):
        plain = getattr(icp, name)
        monkeypatch.setattr(icp, name, lambda *a, _f=plain, _n=name, **k: (called.append(_n),
                                                                            _f(*a, **k))[1])
    launches = icp.JOIN_FIT.launches
    with strict_fp32():
        got = icp._fit(model, scene, tm, t, corrs, **MODES[mode])
        want = icp._fit_plain(model, scene, tm, t, corrs, **MODES[mode])
        wide = fit_check.fit_float64(model, scene, tm, t, corrs, **MODES[mode])
    assert icp.JOIN_FIT.launches == launches
    assert called == 3 * ["gauss_newton_pose_step" if MODES[mode].get("gauss_newton")
                          else "weighted_kabsch"]
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert wide.dtype == torch.float64 and got.shape == wide.shape == (4, 4, 4)
    assert int(corrs.count.min()) >= 12
    gap_t, gap_r = fit_check.fit_gap(got, wide)
    assert float(gap_t.max()) < 1e-5 and float(gap_r.max()) < 1e-5
    with strict_fp32():  # the plain fit itself sits the slack inside the kernel's bound
        over_t, over_r, gaps, plain_gaps = fit_check.fit_excess(model, scene, tm, t, corrs, got,
                                                           **MODES[mode])
    assert torch.equal(gaps[0], plain_gaps[0]) and torch.equal(gaps[1], plain_gaps[1])
    assert abs(float(over_r.max()) + 1e-6) < 1e-15 and float(over_t.max()) < -1e-6
    assert float(fit_check.fit_gap(got, t)[1].min()) > 0.0  # the step moved the poses


@pytest.mark.parametrize("mode", ["orient", "p2l"])
def test_edges_only_falls_back_to_all_corrs_below_twelve(box, mode):
    """Under ``edges_only`` a pose with 12 edge corrs or more fits them
    alone; one with fewer fits all its corrs, as without ``edges_only``."""
    model, scene, tm, t, corrs = _case(box, "shared", "edges")
    few = tm & (torch.cumsum(tm.to(torch.int64), 0) <= 11)  # 11 edge points in the scene
    kw = dict(MODES[mode], edges_only=False)
    with strict_fp32():
        edges = icp._fit_plain(model, scene, tm, t, corrs, **dict(kw, edges_only=True))
        every = icp._fit_plain(model, scene, tm, t, corrs, **kw)
        fallback = icp._fit_plain(model, scene, few, t, corrs, **dict(kw, edges_only=True))
        plain = icp._fit_plain(model, scene, few, t, corrs, **kw)
    assert int((corrs.valid & tm).sum(-1).min()) >= 12
    assert int((corrs.valid & tm).sum(-1).min()) < int(corrs.count.min())
    assert not torch.equal(edges, every)
    assert torch.equal(fallback, plain)


def test_degenerate_fits_keep_their_rule(box):
    """No weight: the identity; fewer than 3 corrs under ``keep``: the pose."""
    model, scene, tm, t, corrs = _case(box, "shared", "orient")
    none = corrs._replace(valid=torch.zeros_like(corrs.valid))
    few = corrs._replace(count=torch.tensor([2, 40, 0, 3]))
    with strict_fp32():
        eye = icp._fit_plain(model, scene, tm, t, none)
        kept = icp._fit_plain(model, scene, tm, t, few, orientation_weight=True, keep=True)
        moved = icp._fit_plain(model, scene, tm, t, corrs, orientation_weight=True)
    assert torch.equal(eye, torch.eye(4).expand(4, 4, 4))
    assert torch.equal(kept[[0, 2]], t[[0, 2]])
    assert torch.equal(kept[[1, 3]], moved[[1, 3]])


def test_fit_gap_resolves_float32_rounding():
    """``fit_gap``, the kernel's yardstick, reads a turn of 1e-7 rad and a
    shift of 1e-7 as such, and nothing between equal poses."""
    ang = 1e-7
    turn = torch.eye(4, dtype=torch.float64)
    turn[:2, :2] = torch.tensor([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    turn[:3, 3] = torch.tensor([1e-7, 0.0, 0.0])
    t = torch.eye(4, dtype=torch.float64)
    t[:3, :3] = torch.linalg.qr(torch.tensor([[0.3, -1.2, 0.5], [0.9, 0.1, -0.4],
                                              [0.2, 0.7, 1.1]], dtype=torch.float64))[0]
    t[:3, 3] = torch.tensor([0.4, -2.0, 1.5])
    gap_t, gap_r = fit_check.fit_gap(t, t @ turn)
    assert abs(float(gap_r) - ang) < 1e-12 and abs(float(gap_t) - 1e-7) < 1e-12
    assert [float(g) for g in fit_check.fit_gap(t, t)] == [0.0, 0.0]


@pytest.mark.parametrize("case", ["scene_batch", "corrs", "float64_poses", "float64_points"])
def test_fit_layout_refuses_what_the_kernel_does_not_take(box, case):
    """The wrapper refuses, before any launch, a scene batch that is not a
    suffix of the poses' dims (as ``finish_find``'s does), corrs that are
    not the poses' over the scene's points, and poses or points that are not
    float32 (the kernel reads float32 and would hand back float32 poses)."""
    model, scene, tm, t, corrs = _case(box, "subset", "relaxed")
    if case == "scene_batch":
        with pytest.raises(ValueError, match="not a suffix"):
            icp._fit_cuda(model, scene, tm, t[:3], DenseCorrs(*(c[:3] for c in corrs)))
    elif case == "corrs":
        with pytest.raises(ValueError, match="corrs"):
            icp._fit_cuda(model, scene, tm, t, corrs._replace(valid=corrs.valid[:, :-1]))
    elif case == "float64_poses":
        with pytest.raises(ValueError, match="float32"):
            icp._fit_cuda(model, scene, tm, t.double(), corrs)
    else:
        wide = PointCloud(scene.xyz.double(), scene.normal.double(), scene.tangent.double(),
                          scene.valid)
        with pytest.raises(ValueError, match="float32"):
            icp._fit_cuda(model, wide, tm, t, corrs)


@pytest.mark.parametrize("step", ["icp_refine", "tight_polish_p2l", "tight_polish_p2p"])
def test_icp_steps_on_the_cpu_take_the_plain_fits(box, step, monkeypatch):
    model, prep, ts = box
    called = []
    for name in ("weighted_kabsch", "gauss_newton_pose_step"):
        plain = getattr(icp, name)
        monkeypatch.setattr(icp, name, lambda *a, _f=plain, _n=name, **k: (called.append(_n),
                                                                            _f(*a, **k))[1])
    consumed = torch.zeros(prep.cloud.capacity, dtype=torch.bool)
    launches = icp.JOIN_FIT.launches
    with strict_fp32():
        if step == "icp_refine":
            icp.icp_refine(model, prep.cloud, prep.tangent_mask, consumed, ts[:4], DIST, 3,
                           tight_iterations=2)
        else:
            icp.tight_polish(model, prep.cloud, prep.tangent_mask, consumed, ts[:4], DIST, 6,
                             orientation_weight=True, anneal=0.5,
                             edges_only=step.endswith("p2l"), point_to_plane=step.endswith("p2p"),
                             point_to_line_at_floor=step.endswith("p2l"))
    assert icp.JOIN_FIT.launches == launches
    if step == "tight_polish_p2p":
        assert called == 6 * ["gauss_newton_pose_step"]
    elif step == "tight_polish_p2l":  # the band reaches the floor at the fourth step
        assert called == 3 * ["weighted_kabsch"] + 3 * ["gauss_newton_pose_step"]
    else:
        assert called[-2:] == 2 * ["weighted_kabsch"] and "weighted_kabsch" in called[:-2]


def test_find_all_on_the_cpu_counts_no_fit_launch(box):
    model, prep = box[0], box[1]
    policy = dataclasses.replace(cfg.SearchPolicy(), num_first_samples=16, num_second_samples=8,
                                 query_cap=8, score_neighbors=256, finalists=2, max_rounds=1)
    launches = icp.JOIN_FIT.launches
    matches = driver.find_all(model, prep.cloud, sample_params=SAMPLE,
                              discretization=cfg.DiscretizationParams(), policy=policy,
                              dist_thres=DIST, model_match_factor=0.5, max_icp_iterations=3,
                              seed=13)
    assert matches
    assert driver.LAST_SEARCH_STATS["join_fit_kernel_launches"] == 0
    assert icp.JOIN_FIT.launches == launches
