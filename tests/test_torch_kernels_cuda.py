"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports neither jax nor the JAX package, so it also runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from triplet_match_tpu_torch import config as cfg
from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.index.model import compile_model
from triplet_match_tpu_torch.io.synthetic import embed_in_scene, make_box_model, sym_delta
from triplet_match_tpu_torch.search import driver
from triplet_match_tpu_torch.search import score_kernel as sk

SAMPLE = cfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    model = compile_model(PointCloud.from_arrays(xyz, nrm, tan, device=dev),
                          cfg.DiscretizationParams(), SAMPLE, cfg.SearchPolicy(), pair_block=128)
    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=200, seed=7,
                                    device=dev)
    return dev, model, scene, t_gt


# the coarse kernels' cases: the main path's two phases, and ragged shapes —
# Hg not a multiple of the pose tile, K not a multiple of the point tile, a
# group with no eligible point, a group of one kind but one point, and a block
# without edge representatives (a model without edge points)
COARSE_CASES = [("coarse", 8, False, "main"), ("fine", 4, True, "main"),
                ("coarse", 8, False, "hg33"), ("fine", 1, True, "k37"),
                ("coarse", 8, False, "empty_group"), ("fine", 4, False, "imbalanced"),
                ("coarse", 8, True, "no_edge_reps")]


def _coarse_inputs(card, block, stride, variant):
    """A pack, groups [8, 8, K] of the card scene, uncentred rows [8, Hg, 16]
    (half near the true pose, half junk) and their centre-shifted copy."""
    dev, model, scene, t_gt = card
    if variant == "no_edge_reps":
        xyz, nrm, _ = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
        pack = sk.pack_model(SimpleNamespace(cloud=PointCloud.from_arrays(
            xyz, nrm, np.zeros_like(xyz), device=dev)), coarse_points=256, fine_points=512)
        assert pack.n_edge_reps == (0, 0)
    else:
        pack = sk.pack_model(model, coarse_points=256, fine_points=512)
    prep = driver.prepare_scene(scene, cfg.SearchPolicy())
    rng = np.random.default_rng(3)
    g, hg, k = 8, 33 if variant == "hg33" else 64, 37 if variant == "k37" else 256
    nbr_idx = torch.from_numpy(rng.integers(0, scene.capacity, (g, k))).to(dev)
    nbr_ok = torch.from_numpy(rng.random((g, k)) > 0.1).to(dev)
    if variant == "empty_group":
        nbr_ok[2] = False
    groups = sk.pack_groups(prep.cloud, prep.tangent_mask,
                            torch.zeros(scene.capacity, dtype=torch.bool, device=dev),
                            nbr_idx, nbr_ok)[:, :, ::stride].contiguous()
    if variant == "imbalanced":  # group 0: one surface point, every other point an edge one
        groups[0, 3] = 1.0
        groups[0, 3, 0] = 0.0
    ts = np.tile(np.linalg.inv(t_gt).astype(np.float32), (g, hg, 1, 1))
    ts[:, : hg // 2, :3, 3] += rng.normal(0, 0.01, (g, hg // 2, 3)).astype(np.float32)
    ts[:, hg // 2:, :3, 3] += rng.normal(0, 0.3, (g, hg - hg // 2, 3)).astype(np.float32)
    rows = sk.poses_to_rows(torch.from_numpy(ts).to(dev))
    thres = np.float32(3.0) * np.float32(float(model.resolution))
    t2 = float(thres * thres)
    t2c = sk._inflate(t2, pack.coarse_slack if block == "coarse" else pack.fine_slack)
    return pack, groups, rows, sk._centre_shifted(pack, rows), t2, t2c


@pytest.mark.cuda
@pytest.mark.parametrize("block,stride,strict_primary,variant", COARSE_CASES)
def test_coarse_kernel_matches_plain(card, block, stride, strict_primary, variant):
    pack, groups, rows, shifted, t2, t2c = _coarse_inputs(card, block, stride, variant)
    hg = rows.shape[1]
    md, n_edge, n_reps, args = sk._coarse_inputs(pack, groups, t2c, t2, block, strict_primary)

    before = sk.COARSE_RANK.launches
    got = sk.score_groups_coarse(pack, groups, rows, t2c, t2, block=block,
                                 strict_primary=strict_primary)
    torch.cuda.synchronize()
    assert sk.COARSE_RANK.launches == before + 1
    ref = sk.score_groups_coarse_plain(groups, shifted, md, *args)
    _, excused = sk.check_coarse_parity(got, ref, groups, shifted, md, t2c, pack.kind_off, t2,
                                        strict_primary)
    assert excused == 0
    # the near-true poses outscore the junk ones in every group left as drawn
    drawn = [i for i in range(groups.shape[0])
             if (variant, i) not in (("empty_group", 2), ("imbalanced", 0))]
    assert (got[drawn, : hg // 2].mean(1) > got[drawn, hg // 2:].mean(1)).all()
    if variant == "empty_group":
        assert float(got[2].abs().max()) == 0.0
    launch = sk._coarse_launch(groups, rows, md, n_edge, n_reps, pack.center_xyz, *args)
    assert torch.equal(launch, got)
    with pytest.raises(ValueError):
        sk._coarse_launch(groups.double(), rows, md, n_edge, n_reps, pack.center_xyz, *args)
    with pytest.raises(ValueError):
        sk._coarse_launch(groups.cpu(), rows, md, n_edge, n_reps, pack.center_xyz, *args)
    with pytest.raises(ValueError):
        sk._coarse_launch(groups, rows[:, ::2], md, n_edge, n_reps, pack.center_xyz, *args)
    with pytest.raises(ValueError):
        sk._coarse_launch(groups, rows, md, n_edge, md.shape[1] + 1, pack.center_xyz, *args)


@pytest.mark.cuda
def test_find_all_on_card_launches_the_kernel(card):
    dev, model, scene, t_gt = card
    policy = dataclasses.replace(cfg.SearchPolicy(), num_first_samples=16, num_second_samples=8,
                                 query_cap=8, score_neighbors=256, finalists=2, max_rounds=2)
    matches = driver.find_all(model, scene, dist_thres=3.0, model_match_factor=0.5,
                              sample_params=SAMPLE, policy=policy, max_icp_iterations=5, seed=13)
    assert matches
    dt, dr = sym_delta(matches[0].transform, t_gt)
    assert dt < 6e-3 and dr < 0.6
    assert driver.LAST_SEARCH_STATS["coarse_kernel_launches"] > 0


def _exact_inputs(dev, big, variant="main"):
    """A pack (4096 model points when ``big``), groups [16, 8, K] of a scene
    with the model planted, uncentred rows [16, Hg, 16] (half near the true
    pose, half junk), their centre-shifted copy and the gate.  Variants:
    "ragged" (K = 37 and Hg = 33: eligible counts off the point tile, Hg off
    the block's poses), "none_in_gate" (group 3's poses 50 m away: no pair
    within the gate, the other-kind sweep skipped everywhere), "all_in_gate"
    (a 2 m gate: every pair within it, every survivor list full)."""
    n_edge, n_face = (1500, 4500) if big else (120, 360)
    xyz, nrm, tan = make_box_model(n_edge=n_edge, n_face=n_face, size=(1.0, 0.8, 0.6), seed=0)
    pack = sk.pack_model(SimpleNamespace(cloud=PointCloud.from_arrays(xyz, nrm, tan, device=dev)))
    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=2000, seed=7,
                                    device=dev)
    tm = torch.linalg.vector_norm(scene.tangent, dim=-1) > 0.7
    rng = np.random.default_rng(4)
    g, hg, k = (16, 33, 37) if variant == "ragged" else (16, 96, 256)
    nbr_idx = torch.from_numpy(rng.integers(0, scene.capacity, (g, k))).to(dev)
    nbr_ok = torch.from_numpy(rng.random((g, k)) > 0.1).to(dev)
    groups = sk.pack_groups(scene, tm, torch.zeros(scene.capacity, dtype=torch.bool, device=dev),
                            nbr_idx, nbr_ok)
    ts = np.tile(np.linalg.inv(t_gt).astype(np.float32), (g, hg, 1, 1))
    ts[:, : hg // 2, :3, 3] += rng.normal(0, 0.004, (g, hg // 2, 3)).astype(np.float32)
    ts[:, hg // 2:, :3, 3] += rng.normal(0, 0.3, (g, hg - hg // 2, 3)).astype(np.float32)
    if variant == "none_in_gate":
        ts[3, :, :3, 3] += 50.0
    rows = sk.poses_to_rows(torch.from_numpy(ts).to(dev))
    t2 = 4.0 if variant == "all_in_gate" else float(np.float32(0.012) ** 2)
    return pack, groups, rows, sk._centre_shifted(pack, rows), t2


EXACT_VARIANTS = [("plain", False, "main"), ("weighted", False, "main"),
                  ("negative", False, "main"), ("plain", True, "main"),
                  ("weighted", True, "main"), ("negative", True, "main"),
                  ("plain", False, "ragged"), ("negative", False, "ragged"),
                  ("plain", False, "none_in_gate"), ("weighted", False, "none_in_gate"),
                  ("plain", False, "all_in_gate"), ("negative", False, "all_in_gate")]


def _check_gate_variant(variant, got, hg):
    """The near-true poses outcount the junk ones where the gate is the real
    one; group 3 of "none_in_gate" counts and scores nothing."""
    drawn = [i for i in range(got[1].shape[0]) if (variant, i) != ("none_in_gate", 3)]
    if variant != "all_in_gate":
        c = got[1][drawn].float()
        assert (c[:, : hg // 2].mean(1) > c[:, hg // 2:].mean(1)).all()
    if variant == "none_in_gate":
        assert int(got[1][3].abs().max()) == 0 and float(got[0][3].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("knobs,big,variant", EXACT_VARIANTS)
def test_exact_kernel_matches_plain(card, knobs, big, variant):
    """B2 against its plain version; ``big`` packs 4096 model points, whose
    blocks need more than 48 KB of shared memory."""
    pack, groups, rows, shifted, t2 = _exact_inputs(card[0], big, variant)
    me, ms = sk.exact_blocks(pack)
    assert ((me.shape[1] + ms.shape[1]) * 16 > 48 * 1024) == big
    hg = rows.shape[1]
    weighted, negative = knobs == "weighted", knobs == "negative"
    inv2t = sk._inv2t(t2)

    before = sk.EXACT_RANK.launches
    got = sk._exact_launch(groups, rows, me, ms, pack.center_xyz, t2, inv2t, weighted, negative)
    torch.cuda.synchronize()
    assert sk.EXACT_RANK.launches == before + 1
    ref = sk.score_groups_exact_plain(groups, shifted, me, ms, t2, inv2t, weighted, negative)
    sk.check_exact_parity(got, ref, groups, shifted, me, ms, t2)
    _check_gate_variant(variant, got, hg)
    wrapper = sk.score_groups_exact(pack, groups, rows, t2, weighted_distance=weighted,
                                    negative_scores=negative)
    assert torch.equal(wrapper[0], got[0]) and torch.equal(wrapper[1], got[1])  # deterministic
    with pytest.raises(ValueError):
        sk._exact_launch(groups.double(), rows, me, ms, pack.center_xyz, t2, inv2t, weighted,
                         negative)
    with pytest.raises(ValueError):
        sk._exact_launch(groups.cpu(), rows, me, ms, pack.center_xyz, t2, inv2t, weighted,
                         negative)
    with pytest.raises(ValueError):
        sk._exact_launch(groups, rows[:, ::2], me, ms, pack.center_xyz, t2, inv2t, weighted,
                         negative)


FULL_VARIANTS = [("plain", False, "main"), ("weighted+negative", False, "main"),
                 ("plain", True, "main"), ("weighted+negative", True, "main"),
                 ("plain", False, "ragged"), ("weighted+negative", False, "ragged"),
                 ("plain", False, "none_in_gate"), ("plain", False, "all_in_gate"),
                 ("weighted+negative", False, "all_in_gate")]


@pytest.mark.cuda
@pytest.mark.parametrize("knobs,big,variant", FULL_VARIANTS)
def test_full_kernel_matches_plain(card, knobs, big, variant):
    """B3 against its plain version; ``big`` packs 4096 model points, whose
    blocks and reference vectors need ~170 KB of shared memory."""
    pack, groups, rows, shifted, t2 = _exact_inputs(card[0], big, variant)
    me, ms = sk.exact_blocks(pack)
    refs = sk.ref_blocks(pack)
    assert ((me.shape[1] + ms.shape[1] + groups.shape[2]) * 32 > 48 * 1024) == big
    hg = rows.shape[1]
    weighted = negative = knobs != "plain"
    inv2t = sk._inv2t(t2)

    before = sk.FULL_RANK.launches
    got = sk._exact_launch(groups, rows, me, ms, pack.center_xyz, t2, inv2t, weighted, negative,
                           refs)
    torch.cuda.synchronize()
    assert sk.FULL_RANK.launches == before + 1
    ref = sk.score_groups_full_plain(groups, shifted, me, ms, *refs, t2, inv2t, weighted,
                                     negative)
    _, excused = sk.check_exact_parity(got, ref, groups, shifted, me, ms, t2)
    assert excused == 0
    if variant in ("main", "ragged"):
        assert (got[0][:, : hg // 2].mean(1) > got[0][:, hg // 2:].mean(1)).all()
    _check_gate_variant(variant, got, hg)
    count_only = sk._exact_launch(groups, rows, me, ms, pack.center_xyz, t2, inv2t, weighted,
                                  negative)
    assert torch.equal(count_only[1], got[1])  # B3's count is B2's
    with pytest.raises(ValueError):
        sk._exact_launch(groups, rows, me, ms, pack.center_xyz, t2, inv2t, weighted, negative,
                         (refs[0][:, :-1], refs[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("block,stride,strict_primary,variant", COARSE_CASES)
def test_coarse_linear_kernel_matches_plain(card, block, stride, strict_primary, variant):
    """B4 against its plain version, and against B1 within ``linear_band``."""
    pack, groups, rows, shifted, t2, t2c = _coarse_inputs(card, block, stride, variant)
    md, n_edge, n_reps, args = sk._coarse_inputs(pack, groups, t2c, t2, block, strict_primary)
    wrows = sk.coarse_linear_rows(shifted)

    before = sk.COARSE_LINEAR_RANK.launches
    got = sk.score_groups_coarse_linear(pack, groups, rows, t2c, t2, block=block,
                                        strict_primary=strict_primary)
    torch.cuda.synchronize()
    assert sk.COARSE_LINEAR_RANK.launches == before + 1
    ref = sk.score_groups_coarse_linear_plain(groups, wrows, md, *args)
    parity = (groups, shifted, md, t2c, pack.kind_off, t2, strict_primary)
    _, excused = sk.check_coarse_parity(got, ref, *parity)
    assert excused == 0
    b1 = sk.score_groups_coarse(pack, groups, rows, t2c, t2, block=block,
                                strict_primary=strict_primary)
    sk.check_coarse_parity(got, b1, *parity,
                           atol=sk.linear_band(groups, shifted, pack.kind_off, md))
    with pytest.raises(ValueError):
        sk._coarse_linear_launch(groups, rows[..., :12], md, n_edge, n_reps, pack.center_xyz,
                                 *args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_kind_block", "far_poses"])
@pytest.mark.parametrize("ranker", ["B1", "B4"])
def test_coarse_kernels_sweep_the_other_kind_above_off2(card, ranker, case):
    """B1 and B4 at gates above the squared kind offset (ROADMAP C18): the
    launcher sets the kernel's ``cross`` sweep, and the kernel counts the
    pairs whose nearest real representative is of the other kind as its
    plain version does (a block without edge representatives at off^2 + t2;
    poses 100 kind offsets away at the median cross-kind distance)."""
    dev = card[0]
    variant = "no_edge_reps" if case == "one_kind_block" else "main"
    pack, groups, rows, shifted, t2, _ = _coarse_inputs(card, "fine", 4, variant)
    if case == "far_poses":
        rng = np.random.default_rng(9)
        d = torch.from_numpy(rng.normal(size=rows.shape[:2] + (3,))).to(dev)
        far = (100.0 * pack.kind_off * d / d.norm(dim=-1, keepdim=True)).float()
        shifted = shifted.clone()
        shifted[..., 9:12] = far
        rows = shifted.clone()
        rows[..., 9:12] += pack.center
    own, best = sk.kind_minima(groups, shifted, pack.md_fine, pack.kind_off)
    t2 = (pack.kind_off ** 2 + t2 if case == "one_kind_block"
          else float(best[best < own].median()))
    t2c = 1.05 * t2
    assert int(((best <= t2) & (own > t2)).sum()) > 0
    md, n_edge, n_reps, args = sk._coarse_inputs(pack, groups, t2c, t2, "fine", False)
    assert sk._cross_kind(t2c, t2, pack.kind_off)
    if ranker == "B1":
        got = sk.score_groups_coarse(pack, groups, rows, t2c, t2, block="fine")
        ref = sk.score_groups_coarse_plain(groups, shifted, md, *args)
    else:
        got = sk.score_groups_coarse_linear(pack, groups, rows, t2c, t2, block="fine")
        ref = sk.score_groups_coarse_linear_plain(groups, sk.coarse_linear_rows(shifted), md,
                                                  *args)
    torch.cuda.synchronize()
    _, excused = sk.check_coarse_parity(got, ref, groups, shifted, md, t2c, pack.kind_off, t2,
                                        False)
    assert excused == 0 and float(got.max()) > 0.0


@pytest.mark.cuda
def test_matcher_on_card_launches_b3_and_b4(card):
    """The object API on the card: full-mode ranking launches B1 and B3, the
    linearised route B4 and not B1, and both find the pose."""
    from triplet_match_tpu_torch import api

    dev, model, scene, t_gt = card
    base = dataclasses.replace(cfg.SearchPolicy(), num_first_samples=16, num_second_samples=8,
                               query_cap=8, score_neighbors=256, finalists=2, max_rounds=2)
    m = api.Model(model.cloud, cfg.DiscretizationParams(), base)
    m._compiled = model
    for knobs, launched, idle in ((dict(ranking_mode="full"), ("coarse", "full"), "exact"),
                                  (dict(two_phase_coarse_linear=True), ("coarse_linear",),
                                   "coarse")):
        matches = api.Matcher(m, policy=dataclasses.replace(base, **knobs)).match(
            scene, dist_thres=3.0, model_match_factor=0.5, sample_params=SAMPLE,
            max_icp_iterations=5)
        stats = driver.LAST_SEARCH_STATS
        assert all(stats[f"{k}_kernel_launches"] > 0 for k in launched), stats
        assert stats[f"{idle}_kernel_launches"] == 0
        assert matches
        dt, dr = sym_delta(matches[0].transform, t_gt)
        assert dt < 6e-3 and dr < 0.6


@pytest.mark.cuda
def test_fog_find_all_on_card_launches_the_exact_kernel(card):
    dev, model, scene, t_gt = card
    policy = dataclasses.replace(cfg.SearchPolicy(), num_first_samples=16, num_second_samples=8,
                                 query_cap=8, score_neighbors=256, finalists=2, max_rounds=2,
                                 fine_full_rescore_ratio=0.0)
    matches = driver.find_all(model, scene, dist_thres=3.0, model_match_factor=0.5,
                              sample_params=SAMPLE, policy=policy, max_icp_iterations=5, seed=13)
    stats = driver.LAST_SEARCH_STATS
    assert stats["fine_rescore_full"] is True
    assert stats["exact_kernel_launches"] > 0 and stats["coarse_kernel_launches"] == 0
    assert stats["join_overflow_max"] == 0
    assert matches
    dt, dr = sym_delta(matches[0].transform, t_gt)
    assert dt < 6e-3 and dr < 0.6
