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


@pytest.mark.cuda
@pytest.mark.parametrize("resolution", [0.02, 0.0137])
def test_nearest_grid_kernel_matches_plain(card, resolution):
    """csrc/nearest_grid.cu against ops/knn.nearest_grid_plain on a box model's
    grid (a ragged z extent at the second resolution), some points invalid:
    the same nearest distance to every sample point, the same index but for
    ties within float32 rounding."""
    from triplet_match_tpu_torch.ops import knn

    dev, model, _, _ = card
    xyz = model.cloud.xyz
    valid = model.cloud.valid.clone()
    valid[::7] = False
    lo, hi = xyz.min(0).values.cpu().numpy(), xyz.max(0).values.cpu().numpy()
    from triplet_match_tpu_torch.index.model import _voxel_grid_setup

    extents, to_voxel = _voxel_grid_setup(lo, hi, resolution, 5)
    to_voxel = torch.from_numpy(to_voxel).to(dev)
    before = knn.NEAREST_GRID.launches
    got = knn.nearest_grid(xyz, valid, to_voxel, extents)
    torch.cuda.synchronize()
    assert knn.NEAREST_GRID.launches == before + 1
    want = knn.nearest_grid_plain(xyz, valid, to_voxel, extents)
    assert got.dtype == torch.int64 and tuple(got.shape) == tuple(extents)
    assert valid[got].all()
    inv = torch.linalg.inv(to_voxel).double()
    ijk = torch.stack(torch.meshgrid(*(torch.arange(e, device=dev, dtype=torch.float64)
                                       for e in extents), indexing="ij"), -1).reshape(-1, 3)
    c = ijk @ inv[:3, :3].T + inv[:3, 3]
    x64 = xyz.double()
    d_got = torch.linalg.vector_norm(c - x64[got.reshape(-1)], dim=-1)
    d_want = torch.linalg.vector_norm(c - x64[want.reshape(-1)], dim=-1)
    assert float((d_got - d_want).abs().max()) <= 1e-6
    assert float((got == want).double().mean()) > 0.999


# --- the join's scoring pass (csrc/join_score.cu) -----------------------------------

JOIN_KNOBS = [dict(), dict(exact=True), dict(samples_on_all=False),
              dict(exact=True, samples_on_all=False),
              dict(weighted_distance=True, negative_scores=True),
              dict(exact=True, weighted_distance=True, negative_scores=True)]
_EPS32 = float(np.finfo(np.float32).eps)


def _scene_with_padding(dev, s_xyz, s_nrm, s_tan, rng):
    """A scan with 1000 padding rows, 1 % of its rows invalid, 10 % claimed."""
    valid = rng.random(s_xyz.shape[0]) > 0.01
    cloud = PointCloud.from_arrays(s_xyz, s_nrm, s_tan, valid=valid,
                                   capacity=s_xyz.shape[0] + 1000, device=dev)
    consumed = torch.from_numpy(rng.random(cloud.capacity) < 0.1).to(dev)
    tm = torch.linalg.vector_norm(cloud.tangent, dim=-1) > 0.7
    return cloud, tm, consumed


def _near_and_far(t_gt, count, rng):
    """``count`` scene -> model poses near the truth and, last, one 0.3 m off."""
    ts = np.tile(np.linalg.inv(t_gt).astype(np.float32), (count, 1, 1))
    ts[:-1, :3, 3] += rng.normal(0, 0.003, (count - 1, 3)).astype(np.float32)
    ts[-1, :3, 3] += 0.3
    return ts


@pytest.fixture(scope="module")
def box500k(card):
    """The recall box model in a 500k-point recall scan (fog, padding,
    invalid and claimed rows) and 16 poses near the truth, the last far."""
    from triplet_match_tpu_torch.io.synthetic import recall_box_model, recall_scene_arrays

    dev = card[0]
    xyz, nrm, tan = recall_box_model()
    model = compile_model(PointCloud.from_arrays(xyz, nrm, tan, device=dev),
                          cfg.DiscretizationParams(), SAMPLE, cfg.SearchPolicy())
    s_xyz, s_nrm, s_tan, t_gt = recall_scene_arrays(500000, 3)
    rng = np.random.default_rng(11)
    cloud, tm, consumed = _scene_with_padding(dev, s_xyz, s_nrm, s_tan, rng)
    return model, cloud, tm, consumed, torch.from_numpy(_near_and_far(t_gt, 16, rng)).to(dev)


@pytest.fixture(scope="module")
def lattice131k(card):
    """The graded lattice with its exact 512^3 table in a 131k-point scan, and
    [2, 3] orbit-step poses: two poses near the truth under the identity and
    the two axis cycles (turns of 120 degrees about (1, 1, 1))."""
    from triplet_match_tpu_torch.io.synthetic import model_arrays, recall_scene_arrays

    dev = card[0]
    lat = model_arrays("lattice")
    model = compile_model(PointCloud.from_arrays(*lat, device=dev), cfg.DiscretizationParams(),
                          SAMPLE, cfg.SearchPolicy(exact_lut=True))
    assert tuple(model.lut.shape) == (512, 512, 512)
    s_xyz, s_nrm, s_tan, t_gt = recall_scene_arrays(131072, 2, lat)
    rng = np.random.default_rng(12)
    cloud, tm, consumed = _scene_with_padding(dev, s_xyz, s_nrm, s_tan, rng)
    cyc = np.eye(4, dtype=np.float32)[[1, 2, 0, 3]]
    orbit = np.stack([np.eye(4, dtype=np.float32), cyc, cyc @ cyc])
    ts = _near_and_far(t_gt, 2, rng)
    ts[1] = np.linalg.inv(t_gt).astype(np.float32)
    cand = torch.from_numpy(orbit[None] @ ts[:, None]).to(dev)  # [A, K, 4, 4]
    return model, cloud, tm, consumed, cand


def _join_case(box500k, lattice131k, layout):
    """(model, scene, tangent mask, consumed, poses, dist_thres) of a layout."""
    if layout.startswith("lattice"):
        model, cloud, tm, consumed, cand = lattice131k
        dist = (torch.tensor([[3.0, 1.5, 6.0], [2.0, 3.0, 0.5]], device=cand.device)
                if layout == "lattice_thres" else 3.0)
        return model, cloud, tm, consumed, cand, dist
    model, cloud, tm, consumed, ts = box500k
    if layout == "shared":
        return model, cloud, tm, consumed, ts[:4], 6.0
    if layout == "shared_thres":
        return model, cloud, tm, consumed, ts[:4], torch.tensor([3.0, 6.0, 1.0, 12.0],
                                                                device=ts.device)
    sub, stm, scons, _, _, n_cand = driver._candidate_subset(model, cloud, tm, consumed, ts, 3.0,
                                                             65536, 1.0)
    assert sub.xyz.shape[:2] == (16, 65536)
    return model, sub, stm, scons, ts, 6.0


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", JOIN_KNOBS, ids=lambda k: "-".join(k) or "plain")
@pytest.mark.parametrize("layout", ["shared", "shared_thres", "subset", "lattice",
                                    "lattice_thres"])
def test_join_score_kernel_matches_plain(box500k, lattice131k, layout, knobs):
    """csrc/join_score.cu against the plain pass (``_score_points``) on CUDA
    tensors: ok, model_idx and count bit for bit, the score within float32
    reassociation of its terms, and two launches alike to the bit."""
    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.search import score

    model, scene, tm, consumed, t, dist = _join_case(box500k, lattice131k, layout)
    thres = torch.as_tensor(dist, dtype=torch.float32, device=t.device) * model.resolution
    if thres.dim():
        thres = thres[..., None]
    with strict_fp32():
        want = score._score_points(model, scene, tm, consumed, t, None, None, thres, **knobs)
        pos = score._score_points(model, scene, tm, consumed, t, None, None, thres,
                                  **dict(knobs, negative_scores=False))[0]
        before = score.JOIN_SCORE.launches
        a = score.finish_find(model, scene, tm, consumed, t, dist, **knobs)
        b = score.finish_find(model, scene, tm, consumed, t, dist, **knobs)
        c = score.finish_find(model, scene, tm, consumed, t, dist, count_only=True, **knobs)
        torch.cuda.synchronize()
    assert score.JOIN_SCORE.launches == before + 3
    assert torch.equal(a.count, want[1]) and torch.equal(a.valid, want[2])
    assert torch.equal(a.model_idx, want[3])
    assert int(a.count.max()) > 100 and int(a.count.min()) < int(a.count.max())
    # every term is at most 1 in magnitude; the sum of their magnitudes is
    # pos + (pos - score) = 2 pos - score
    mag = (2.0 * pos.double() - want[0].double()).abs()
    assert float(((a.score.double() - want[0].double()).abs() - 64 * _EPS32 * mag).max()) <= 1e-6
    for x, y in ((a.score, b.score), (a.count, b.count), (a.valid, b.valid),
                 (a.model_idx, b.model_idx)):
        assert torch.equal(x, y)
    assert c.valid is None and c.model_idx is None
    assert torch.equal(c.count, a.count) and torch.equal(c.score, a.score)


@pytest.mark.cuda
def test_fog_find_all_on_card_counts_one_join_launch_per_pass(card, monkeypatch):
    """A fog-route search makes one join_score launch per finish_find call
    and publishes their number as ``join_score_kernel_launches``."""
    from triplet_match_tpu_torch.search import score

    dev, model, scene, t_gt = card
    calls = []
    launch = score._score_points_cuda

    def counted(*a, **kw):
        calls.append(1)
        return launch(*a, **kw)

    monkeypatch.setattr(score, "_score_points_cuda", counted)
    policy = dataclasses.replace(cfg.SearchPolicy(), num_first_samples=16, num_second_samples=8,
                                 query_cap=8, score_neighbors=256, finalists=2, max_rounds=2,
                                 fine_full_rescore_ratio=0.0)
    matches = driver.find_all(model, scene, dist_thres=3.0, model_match_factor=0.5,
                              sample_params=SAMPLE, policy=policy, max_icp_iterations=5, seed=13)
    stats = driver.LAST_SEARCH_STATS
    assert stats["fine_rescore_full"] is True and matches
    assert stats["join_score_kernel_launches"] == len(calls) > 0


# --- the join's pose fit (csrc/join_fit.cu) ---------------------------------------

# the join's fits: the relaxed ICP's Kabsch; the polish's orientation-weighted
# Kabsch, with the raw-edge weights on both sides of the 12-corr fallback; its
# Gauss-Newton point-to-line steps (the fog route's floor) and point-to-plane
FIT_MODES = {"relaxed": dict(), "orient": dict(orientation_weight=True, keep=True),
             "edges": dict(edges_only=True, orientation_weight=True, keep=True),
             "edges_few": dict(edges_only=True, orientation_weight=True, keep=True),
             "p2l": dict(gauss_newton=True, edges_only=True, orientation_weight=True, keep=True),
             "p2p": dict(gauss_newton=True, keep=True)}


def _fit_case(box500k, lattice131k, layout, mode):
    """(model, scene, tangent mask, poses, corrs) of one fit at a layout of
    the join: fog500k's per-finalist subsets [4, 65536] and whole scan [4,
    500k], the lattice's subsets [4, 65536] (exact table), symmetry
    detection's model-as-scene [1, 19950].  The corrs are the step's own
    scoring pass's (relaxed gate; the polish's exact lookup at the gate);
    under edges_only the mask is the raw-edge one, or, for ``edges_few``, 11
    of its points per scene batch."""
    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.search.score import finish_find

    if layout.startswith("fog500k"):
        model, scene, tm, consumed, ts = box500k
        t = ts[:4]
    elif layout == "lattice":
        model, scene, tm, consumed, cand = lattice131k
        t = cand.reshape(-1, 4, 4)[[0, 3, 4, 5]].contiguous()  # near, the truth's orbit
    else:
        model = lattice131k[0]
        scene, tm = model.cloud, model.edge
        consumed = torch.zeros(scene.capacity, dtype=torch.bool, device=tm.device)
        t = torch.eye(4, device=tm.device)[None].clone()
        t[0, :3, 3] = torch.tensor([0.002, -0.001, 0.0015])
    if FIT_MODES[mode].get("edges_only"):
        tm = torch.linalg.vector_norm(scene.tangent, dim=-1) > 0.7
    if layout in ("fog500k", "lattice"):
        scene, tm, consumed, _, _, _ = driver._candidate_subset(model, scene, tm, consumed, t,
                                                                3.0, 65536, 1.0)
        assert scene.xyz.shape[:2] == (t.shape[0], 65536)
    relaxed = mode == "relaxed"
    with strict_fp32():
        corrs = finish_find(model, scene, tm, consumed, t, 6.0 if relaxed else 3.0,
                            exact=not relaxed)
    if mode == "edges_few":
        tm = tm & (torch.cumsum(tm.to(torch.int64), -1) <= 11)
    return model, scene, tm, t, corrs


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(FIT_MODES))
@pytest.mark.parametrize("layout", ["fog500k", "fog500k_whole", "lattice", "symmetry"])
def test_join_fit_kernel_within_the_float64_fit(box500k, lattice131k, layout, mode):
    """csrc/join_fit.cu against the plain fit evaluated in float64 on the
    same inputs: each pose no farther from it than the float32 plain fit is,
    plus 1e-6 rad and 1e-6 x the scene's extent; two launches alike to the
    bit."""
    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.refine import fit_check, icp

    model, scene, tm, t, corrs = _fit_case(box500k, lattice131k, layout, mode)
    kw = FIT_MODES[mode]
    edges = (corrs.valid & tm).sum(-1)
    if mode == "edges":
        assert int(edges.min()) >= 12
    if mode == "edges_few":
        assert int(edges.max()) < 12
    assert int(corrs.count.min()) >= 3 and int(corrs.count.max()) > 100
    with strict_fp32():
        before = icp.JOIN_FIT.launches
        a = icp._fit(model, scene, tm, t, corrs, **kw)
        b = icp._fit(model, scene, tm, t, corrs, **kw)
        torch.cuda.synchronize()
        assert icp.JOIN_FIT.launches == before + 2
        over_t, over_r, _, _ = fit_check.fit_excess(model, scene, tm, t, corrs, a, **kw)
    assert a.dtype == torch.float32 and a.shape == t.shape and torch.equal(a, b)
    assert torch.equal(a[:, 3], torch.tensor([0.0, 0.0, 0.0, 1.0], device=a.device).expand(
        a.shape[0], 4))
    assert float(over_t.max()) <= 0.0 and float(over_r.max()) <= 0.0, (over_t, over_r)
    assert float(fit_check.fit_gap(a, t)[1].min()) > 0.0  # the step moved every pose


@pytest.mark.cuda
def test_join_fit_kernel_degenerate_cases(box500k, lattice131k):
    """No weight: the identity (as ``weighted_kabsch``); under ``keep``, a
    pose whose step scored fewer than 3 corrs keeps its pose bit for bit."""
    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.refine import icp

    model, scene, tm, t, corrs = _fit_case(box500k, lattice131k, "fog500k", "orient")
    none = corrs._replace(valid=torch.zeros_like(corrs.valid))
    few = corrs._replace(count=torch.tensor([2, 40, 0, 3], device=t.device))
    with strict_fp32():
        eye = icp._fit_cuda(model, scene, tm, t, none)
        eye_gn = icp._fit_cuda(model, scene, tm, t, none._replace(count=few.count),
                               gauss_newton=True, keep=True)
        kept = icp._fit_cuda(model, scene, tm, t, few, orientation_weight=True, keep=True)
        moved = icp._fit_cuda(model, scene, tm, t, corrs, orientation_weight=True)
    assert torch.equal(eye, torch.eye(4, device=t.device).expand(4, 4, 4))
    assert torch.equal(kept[[0, 2]], t[[0, 2]]) and torch.equal(eye_gn[[0, 2]], t[[0, 2]])
    assert torch.equal(kept[[1, 3]], moved[[1, 3]])


@pytest.mark.cuda
def test_fog_find_all_on_card_counts_one_fit_launch_per_fit(card, monkeypatch):
    """A fog-route search makes one join_fit launch per fit of its ICP and
    polish and publishes their number as ``join_fit_kernel_launches``."""
    from triplet_match_tpu_torch.refine import icp

    dev, model, scene, t_gt = card
    calls = []
    launch = icp._fit_cuda

    def counted(*a, **kw):
        calls.append(1)
        return launch(*a, **kw)

    monkeypatch.setattr(icp, "_fit_cuda", counted)
    policy = dataclasses.replace(cfg.SearchPolicy(), num_first_samples=16, num_second_samples=8,
                                 query_cap=8, score_neighbors=256, finalists=2, max_rounds=2,
                                 fine_full_rescore_ratio=0.0)
    matches = driver.find_all(model, scene, dist_thres=3.0, model_match_factor=0.5,
                              sample_params=SAMPLE, policy=policy, max_icp_iterations=5, seed=13)
    stats = driver.LAST_SEARCH_STATS
    assert stats["fine_rescore_full"] is True and matches
    assert stats["join_fit_kernel_launches"] == len(calls) > 0


# the scene-sharded fits: each of the modes above, and ``edges_split``: the
# raw-edge weights with 8 edge corrs a pose on each of two shards, so that
# only the whole scene's count (16) passes the 12-corr test
SHARD_MODES = dict(FIT_MODES, edges_split=FIT_MODES["edges"])
SHARD_CASES = ([("fog500k", m) for m in SHARD_MODES]
               + [("fog500k_whole", m) for m in ("relaxed", "edges_split", "p2l", "p2p")])
SHARDS = 2


def _shard(x, rank, n):
    """Shard ``rank`` of SHARDS of a field over ``n`` points, along its points
    (the last dim, or the one before it for [..., n, 3] vectors)."""
    lo, hi = rank * n // SHARDS, (rank + 1) * n // SHARDS
    vec = x.dim() > 1 and x.shape[-1] == 3 and x.shape[-2] == n
    return (x[..., lo:hi, :] if vec else x[..., lo:hi]).contiguous()


def _sharded_fit_rank(path):
    """One gloo rank of ``test_join_fit_kernel_sharded``: every case's fit of
    its shard of the scene (the cases as ``sharded_fits`` saved them at
    ``path``), under a scene-sharded group of SHARDS ranks on card 0.
    Returns every rank's (poses as an array, JOIN_FIT launches) by case."""
    import torch.distributed as dist

    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.parallel.mesh import SP_AXIS, MeshAxis, make_mesh
    from triplet_match_tpu_torch.refine import icp
    from triplet_match_tpu_torch.search.score import DenseCorrs

    dev = torch.device("cuda", 0)
    rank = dist.get_rank()
    group = MeshAxis(make_mesh(SHARDS, SP_AXIS), SP_AXIS)
    saved = torch.load(path)
    model = SimpleNamespace(cloud=PointCloud(*(v.to(dev) for v in saved["model"])))
    out = {}
    for key, (xyz, nrm, tan, valid, tm, t, midx, ok, score, count) in saved["cases"].items():
        n = xyz.shape[-2]
        sc = PointCloud(*(_shard(v, rank, n).to(dev) for v in (xyz, nrm, tan, valid)))
        c = DenseCorrs(_shard(midx, rank, n).to(dev), _shard(ok, rank, n).to(dev),
                       score.to(dev), count.to(dev))
        before = icp.JOIN_FIT.launches
        with strict_fp32():
            got = icp._fit(model, sc, _shard(tm, rank, n).to(dev), t.to(dev), c, group=group,
                           **SHARD_MODES[key.split("/")[1]])
        out[key] = (got.cpu().numpy(), icp.JOIN_FIT.launches - before)
    every = [None] * SHARDS
    dist.all_gather_object(every, out)
    return every


@pytest.fixture(scope="module")
def sharded_fits(box500k, lattice131k, tmp_path_factory):
    """Every case of SHARD_CASES (fog500k's subsets [4, 65536] and whole scan
    [4, 500k]) with its points in one fixed shuffled order, so that both
    shards hold points of the box (the scan lists them first, the subsets
    gather them first); the inputs whole on the card, and every rank's
    sharded fit of them.  The ranks read the cases from a file (some 200 MB:
    too much for a spawned process's arguments, which share tensors through
    shared memory)."""
    from triplet_match_tpu_torch.parallel import distributed as pdist
    from triplet_match_tpu_torch.search.score import DenseCorrs

    gen = torch.Generator().manual_seed(21)
    perms, cases, moved, cpu = {}, {}, {}, {}

    def shuffled(x, n):  # one copy of each field, in the layout's order
        if n not in perms:
            perms[n] = torch.randperm(n, generator=gen).to(x.device)
        if id(x) not in moved:
            vec = x.dim() > 1 and x.shape[-1] == 3 and x.shape[-2] == n
            moved[id(x)] = (x, x[..., perms[n], :] if vec else x[..., perms[n]])
        return moved[id(x)][1]

    for layout, mode in SHARD_CASES:
        model, scene, tm, t, corrs = _fit_case(box500k, lattice131k, layout,
                                               "edges" if mode == "edges_split" else mode)
        n = scene.xyz.shape[-2]
        scene = PointCloud(*(shuffled(v, n) for v in (scene.xyz, scene.normal, scene.tangent,
                                                       scene.valid)))
        tm = shuffled(tm, n)
        corrs = DenseCorrs(shuffled(corrs.model_idx, n), shuffled(corrs.valid, n),
                           corrs.score, corrs.count)
        if mode == "edges_split":  # 8 edge corrs of every pose on each shard
            on = tm & corrs.valid.all(0) if tm.dim() == 1 else tm & corrs.valid
            second = torch.arange(n, device=tm.device) >= n // SHARDS
            first = torch.zeros_like(on)
            for part in (~second, second):
                sel = on & part
                first |= sel & (torch.cumsum(sel.to(torch.int64), -1) <= 8)
            tm = first
        cases[(layout, mode)] = (model, scene, tm, t, corrs)

    def host(x):  # one host copy of each card tensor
        if id(x) not in cpu:
            cpu[id(x)] = (x, x.cpu())
        return cpu[id(x)][1]

    model = cases[SHARD_CASES[0]][0]
    path = tmp_path_factory.mktemp("sharded_fits") / "cases.pt"
    torch.save({"model": tuple(host(v) for v in (model.cloud.xyz, model.cloud.normal,
                                                 model.cloud.tangent, model.cloud.valid)),
                "cases": {f"{k[0]}/{k[1]}": (host(sc.xyz), host(sc.normal), host(sc.tangent),
                                             host(sc.valid), host(tm), host(t),
                                             *(host(v) for v in c))
                          for k, (_, sc, tm, t, c) in cases.items()}}, path)
    every = pdist.run_local(_sharded_fit_rank, SHARDS, "gloo", str(path))
    return cases, every


@pytest.mark.cuda
@pytest.mark.parametrize("layout,mode", SHARD_CASES)
def test_join_fit_kernel_sharded(sharded_fits, layout, mode):
    """Under a scene-sharded group (two gloo ranks on the card, each with
    half of every pose's points) the fit is the kernel's, one call a fit on
    each rank: the same bits on both ranks, and, against the plain fit of
    the whole scene evaluated in float64, within the unsharded kernel's
    bound.  ``edges_split`` holds the 12-corr fallback to the whole scene's
    edge count."""
    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.refine import fit_check

    cases, every = sharded_fits
    model, scene, tm, t, corrs = cases[(layout, mode)]
    (a, na), (b, nb) = (r[f"{layout}/{mode}"] for r in every)
    assert na == nb == 1 and np.array_equal(a, b)
    n = scene.xyz.shape[-2]
    for r in range(SHARDS):  # every shard holds corrs of every pose
        assert int(_shard(corrs.valid, r, n).sum(-1).min()) > 100
    if mode == "edges_split":
        edges = corrs.valid & tm
        assert all(int(_shard(edges, r, n).sum(-1).max()) < 12 for r in range(SHARDS))
        assert int(edges.sum(-1).min()) >= 12
    got = torch.from_numpy(a).to(t.device)
    with strict_fp32():
        over_t, over_r, _, _ = fit_check.fit_excess(model, scene, tm, t, corrs, got,
                                                    **SHARD_MODES[mode])
    assert float(over_t.max()) <= 0.0 and float(over_r.max()) <= 0.0, (over_t, over_r)
    assert float(fit_check.fit_gap(got, t)[1].min()) > 0.0
