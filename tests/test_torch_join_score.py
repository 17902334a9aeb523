"""The join's scoring pass (``search.score.finish_find``) on the CPU.

On a CPU tensor ``finish_find`` runs the plain pass (``_score_points``) and
launches nothing; the layout handling that feeds ``csrc/join_score.cu`` on
the card (``_join_inputs``: flat poses, scene batches, a per-pose gate) gives
``finish_find``'s own results when its flat inputs go through the plain pass
the way the kernel reads them (``_flat_pass`` below: pose p on scene batch
p % B).  The kernel itself is held to the plain pass on the card in
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
from triplet_match_tpu_torch.search import driver
from triplet_match_tpu_torch.search import score

torch.set_num_threads(2)

SAMPLE = cfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
DIST = 3.0


@pytest.fixture(scope="module")
def box():
    """A box in clutter; poses near the truth (jittered) and one far off."""
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    model = compile_model(PointCloud.from_arrays(xyz, nrm, tan, device="cpu"),
                          cfg.DiscretizationParams(), SAMPLE, cfg.SearchPolicy(), pair_block=128)
    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=300, seed=7,
                                    device="cpu")
    prep = driver.prepare_scene(scene, cfg.SearchPolicy())
    rng = np.random.default_rng(5)
    ts = np.tile(np.linalg.inv(t_gt).astype(np.float32), (6, 1, 1))
    ts[:5, :3, 3] += rng.normal(0, 0.004, (5, 3)).astype(np.float32)
    ts[5, :3, 3] += 0.5
    n = prep.cloud.capacity
    consumed = torch.from_numpy(rng.random(n) < 0.1)
    return model, prep, consumed, torch.from_numpy(ts)


def _layout(box, case):
    """(scene, tangent mask, consumed, poses, dist_thres) of one layout."""
    model, prep, consumed, ts = box
    cloud, tm = prep.cloud, prep.tangent_mask
    if case == "shared":
        return cloud, tm, consumed, ts[:4], DIST
    if case == "orbit":  # [A, K] poses, as the orbit step passes them
        return cloud, tm, consumed, ts.reshape(2, 3, 4, 4), DIST
    if case.startswith("subset"):  # per-finalist candidate sub-scenes [F, C]
        sub, stm, scons, _, _, _ = driver._candidate_subset(model, cloud, tm, consumed, ts[:4],
                                                            DIST, 256, 1.0)
        t = ts[:4] if case == "subset" else torch.stack([ts[:4], ts[1:5]])  # [2, F] poses
        return sub, stm, scons, t, DIST
    if case == "thres":  # a per-pose gate [A, K]
        return cloud, tm, consumed, ts.reshape(2, 3, 4, 4), torch.tensor(
            [[3.0, 1.0, 2.0], [0.5, 3.0, 6.0]])
    if case == "thres0":  # a 0-d tensor gate
        return cloud, tm, consumed, ts[:3], torch.tensor(2.0)
    raise ValueError(case)


def _flat_pass(model, inp, exact, weighted_distance, negative_scores, samples_on_all):
    """The kernel's reading of its flat inputs, in plain PyTorch: pose p of
    ``inp.poses`` scored on scene batch p % B by ``_score_points``; returns
    (score [P], count [P], ok [P, N], model_idx [P, N])."""
    poses = inp.poses.reshape(-1, 4, 4)
    b = torch.arange(poses.shape[0]) % inp.batches
    n = inp.valid.shape[-1]

    def rows(x, tail=()):
        return x.reshape((inp.batches, n) + tail)[b]

    dist = inp.dist if inp.dist_p is None else inp.dist_p[:, None]
    thres = torch.as_tensor(dist, dtype=torch.float32) * model.resolution
    cloud = PointCloud(*(rows(v, (3,)) for v in (inp.xyz, inp.normal, inp.tangent)),
                       rows(inp.valid))
    return score._score_points(model, cloud, rows(inp.tangent_mask), rows(inp.consumed), poses,
                               None, None, thres, exact=exact,
                               weighted_distance=weighted_distance,
                               negative_scores=negative_scores, samples_on_all=samples_on_all)


KNOBS = [dict(), dict(exact=True), dict(samples_on_all=False, weighted_distance=True),
         dict(exact=True, negative_scores=True, weighted_distance=True)]
CASES = ["shared", "orbit", "subset", "subset2", "thres", "thres0"]


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(k) or "plain")
@pytest.mark.parametrize("case", CASES)
def test_finish_find_on_the_cpu_is_the_plain_pass(box, case, knobs):
    model = box[0]
    scene, tm, cons, t, dist = _layout(box, case)
    thres = torch.as_tensor(dist, dtype=torch.float32) * model.resolution
    if thres.dim():
        thres = thres[..., None]
    launches = score.JOIN_SCORE.launches
    with strict_fp32():
        got = score.finish_find(model, scene, tm, cons, t, dist, **knobs)
        want = score._score_points(model, scene, tm, cons, t, None, None, thres, **knobs)
        counted = score.finish_find(model, scene, tm, cons, t, dist, count_only=True, **knobs)
    assert score.JOIN_SCORE.launches == launches  # the CPU launches nothing
    for a, b in zip((got.score, got.count, got.valid, got.model_idx), want):
        assert a.shape == b.shape and torch.equal(a, b)
    assert int(got.count.sum()) > 0
    assert counted.valid is None and counted.model_idx is None
    assert torch.equal(counted.count, got.count) and torch.equal(counted.score, got.score)


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(k) or "plain")
@pytest.mark.parametrize("case", CASES)
def test_join_layout_gives_finish_finds_results(box, case, knobs):
    """The kernel's flat inputs, through the plain pass, reshaped to the
    poses' leading dims, are ``finish_find``'s results bit for bit."""
    model = box[0]
    scene, tm, cons, t, dist = _layout(box, case)
    with strict_fp32():
        want = score.finish_find(model, scene, tm, cons, t, dist, **knobs)
        inp = score._join_inputs(scene, tm, cons, t, dist)
        sc, cnt, ok, midx = _flat_pass(model, inp, knobs.get("exact", False),
                                              knobs.get("weighted_distance", False),
                                              knobs.get("negative_scores", False),
                                              knobs.get("samples_on_all", True))
    assert inp.lead == tuple(t.shape[:-2]) and inp.poses.is_contiguous()
    assert inp.batches * scene.xyz.shape[-2] * 3 == inp.xyz.numel()
    for f in (inp.xyz, inp.normal, inp.tangent):
        assert f.is_contiguous() and f.shape == inp.valid.shape + (3,)
    for f in (inp.valid, inp.tangent_mask, inp.consumed):
        assert f.is_contiguous() and f.shape == inp.valid.shape and f.dtype == torch.bool
    for a, b in ((sc, want.score), (cnt, want.count), (ok, want.valid), (midx, want.model_idx)):
        assert torch.equal(a.reshape(b.shape), b)


def test_join_layout_refuses_a_scene_batch_the_poses_lack(box):
    model, prep, consumed, ts = box
    sub, stm, scons, _, _, _ = driver._candidate_subset(model, prep.cloud, prep.tangent_mask,
                                                        consumed, ts[:4], DIST, 256, 1.0)
    with pytest.raises(ValueError, match="not a suffix"):
        score._join_inputs(sub, stm, scons, ts[:3], DIST)


def test_find_all_on_the_cpu_counts_no_join_launch(box):
    model, prep = box[0], box[1]
    policy = dataclasses.replace(cfg.SearchPolicy(), num_first_samples=16, num_second_samples=8,
                                 query_cap=8, score_neighbors=256, finalists=2, max_rounds=1)
    launches = score.JOIN_SCORE.launches
    matches = driver.find_all(model, prep.cloud, sample_params=SAMPLE,
                              discretization=cfg.DiscretizationParams(), policy=policy,
                              dist_thres=DIST, model_match_factor=0.5, max_icp_iterations=3,
                              seed=13)
    assert matches
    assert driver.LAST_SEARCH_STATS["join_score_kernel_launches"] == 0
    assert score.JOIN_SCORE.launches == launches
