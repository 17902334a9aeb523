"""Two-phase ranking (TPU kernel B1): PyTorch port vs JAX package.

On the CPU the port runs ``score_groups_coarse_plain``; the JAX side runs
``score_groups_coarse`` in Pallas interpret mode at "highest" precision.
Parity contract: both integer counts equal, except points whose float64 4-D
distance lies within 1e-5 of a gate (relative); the fractional tiebreak
within K float32 ulps (``score_kernel.check_coarse_parity``).  The CUDA
kernel against the plain version is in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from triplet_match_tpu.config import DiscretizationParams, SampleParams, SearchPolicy
from triplet_match_tpu.core.cloud import PointCloud as JCloud
from triplet_match_tpu.index.model import compile_model
from triplet_match_tpu.index.serialize import _CLOUD_FIELDS, _MODEL_FIELDS
from triplet_match_tpu.io.synthetic import embed_in_scene, make_box_model
from triplet_match_tpu.search import score_pallas as jsp
from triplet_match_tpu.search.driver import prepare_scene

from triplet_match_tpu_torch.index.model import compiled_model_from_numpy
from triplet_match_tpu_torch.search import score_kernel as tsk

torch.set_num_threads(2)

POLICY = SearchPolicy()


@pytest.fixture(scope="module")
def setup():
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    jm = compile_model(JCloud.from_arrays(xyz, nrm, tan), DiscretizationParams(),
                       SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95), POLICY,
                       pair_block=128)
    d = {f"cloud_{k}": np.asarray(getattr(jm.cloud, k)) for k in _CLOUD_FIELDS}
    d.update({k: np.asarray(getattr(jm, k)) for k in _MODEL_FIELDS})
    d["margin"] = jm.margin
    tm = compiled_model_from_numpy(d, device="cpu")
    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=200, seed=7)
    prep = prepare_scene(scene, POLICY)
    jpack = jsp.pack_model(jm, coarse_points=256, fine_points=512)
    tpack = tsk.pack_model(tm, coarse_points=256, fine_points=512)

    g, hg, k = 8, 64, 256
    rng = np.random.default_rng(3)
    n = prep.cloud.xyz.shape[0]
    nbr_idx = rng.integers(0, n, (g, k)).astype(np.int32)
    nbr_valid = rng.random((g, k)) > 0.1
    t_inv = np.linalg.inv(np.asarray(t_gt)).astype(np.float32)
    ts = np.tile(t_inv, (g, hg, 1, 1))
    ts[:, : hg // 2, :3, 3] += rng.normal(0, 0.01, (g, hg // 2, 3)).astype(np.float32)
    ts[:, hg // 2:, :3, 3] += rng.normal(0, 0.3, (g, hg - hg // 2, 3)).astype(np.float32)
    groups = np.array(jsp.pack_groups(prep.cloud, prep.tangent_mask, jnp.zeros(n, bool),
                                        jnp.asarray(nbr_idx), jnp.asarray(nbr_valid)))
    rows = np.array(jsp.poses_to_rows(jnp.asarray(ts)))
    thres = 3.0 * float(jm.resolution)
    return dict(jpack=jpack, tpack=tpack, groups=groups, rows=rows, t2=thres * thres, ts=ts,
                prep=prep, nbr_idx=nbr_idx, nbr_valid=nbr_valid, tm=tm)


def test_pack_model_arrays_equal(setup):
    jp, tp = setup["jpack"], setup["tpack"]
    for name in ("channels_d", "channels_w", "md_edge", "md_surf", "md_coarse", "md_fine", "center"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    assert tp.n_pad == jp.n_pad
    for name in ("kind_off", "coarse_slack", "fine_slack"):
        assert getattr(tp, name) == float(getattr(jp, name)), name
    assert tp.md_coarse.shape[1] == 256 and tp.md_fine.shape[1] > tp.md_coarse.shape[1]


def test_pack_groups_and_rows_equal(setup):
    prep = setup["prep"]
    from triplet_match_tpu_torch.core.cloud import PointCloud

    cloud = PointCloud(*(torch.from_numpy(np.array(getattr(prep.cloud, f)))
                         for f in ("xyz", "normal", "tangent", "valid")))
    groups = tsk.pack_groups(cloud, torch.from_numpy(np.array(prep.tangent_mask)),
                             torch.zeros(cloud.capacity, dtype=torch.bool),
                             torch.from_numpy(setup["nbr_idx"]).long(),
                             torch.from_numpy(setup["nbr_valid"]))
    np.testing.assert_array_equal(groups.numpy(), setup["groups"])
    np.testing.assert_array_equal(tsk.poses_to_rows(torch.from_numpy(setup["ts"])).numpy(),
                                  setup["rows"])


@pytest.mark.parametrize("block,stride", [("coarse", 8), ("fine", 4)])
@pytest.mark.parametrize("strict_primary", [False, True])
def test_coarse_plain_matches_jax(setup, block, stride, strict_primary):
    jp, tp = setup["jpack"], setup["tpack"]
    groups = np.ascontiguousarray(setup["groups"][:, :, ::stride])
    rows, t2 = setup["rows"], setup["t2"]
    slack = tp.coarse_slack if block == "coarse" else tp.fine_slack
    t2c = tsk._inflate(t2, slack)
    ref = jsp.score_groups_coarse(jp, jnp.asarray(groups), jnp.asarray(rows), t2c, t2,
                                  pose_tile=32, interpret=True, mxu_precision="highest",
                                  block=block, strict_primary=strict_primary, group_block=16)
    got = tsk.score_groups_coarse(tp, torch.from_numpy(groups), torch.from_numpy(rows), t2c, t2,
                                  block=block, strict_primary=strict_primary)
    shifted = torch.from_numpy(rows).clone()
    shifted[..., 9:12] -= tp.center
    md = tp.md_coarse if block == "coarse" else tp.md_fine
    tsk.check_coarse_parity(got, torch.from_numpy(np.asarray(ref)), torch.from_numpy(groups),
                            shifted, md, t2c, tp.kind_off, t2, strict_primary)
    # the ranking is informative: near-true poses outscore junk in every group
    hg = rows.shape[1]
    assert (got[:, : hg // 2].mean(1) > got[:, hg // 2:].mean(1)).all()
    assert tsk.COARSE_RANK.launches == 0  # the CPU path never counts a launch


def test_two_phase_keep_set_identical_under_ties(setup):
    """Many exactly-tied scores: the keep (and the final scores) must match JAX's
    index-order tie resolution."""
    jp, tp = setup["jpack"], setup["tpack"]
    distinct = setup["ts"][:, ::8]  # 8 distinct poses per group, each repeated 8 times
    ts = np.repeat(distinct, 8, axis=1)
    rows = np.array(jsp.poses_to_rows(jnp.asarray(ts)))
    ok = np.ones(rows.shape[:2], bool)
    ok[:, 5::7] = False
    kw = dict(pose_tile=POLICY.two_phase_pose_tile, coarse_stride=POLICY.two_phase_stride,
              keep_frac=POLICY.two_phase_keep_frac, fine_stride=POLICY.two_phase_fine_stride,
              fine_coarse=True, fine_strict=True)
    sj, cj = jsp.score_groups_two_phase(jp, jnp.asarray(setup["groups"]), jnp.asarray(rows),
                                        setup["t2"], jnp.asarray(ok), interpret=True,
                                        coarse_model=True, group_block=16, **kw)
    st, ct = tsk.score_groups_two_phase(tp, torch.from_numpy(setup["groups"]),
                                        torch.from_numpy(rows), setup["t2"],
                                        torch.from_numpy(ok), coarse_model=True, **kw)
    sj, cj = np.asarray(sj), np.asarray(cj)
    np.testing.assert_array_equal(st.numpy() >= 0, sj >= 0)  # identical keep sets
    np.testing.assert_array_equal(ct.numpy(), cj)
    k = setup["groups"].shape[2] // POLICY.two_phase_fine_stride
    np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=k * np.spacing(np.float32(k + 1)))
    # the ties are real: dropped copies of kept poses exist in every group
    assert ((st.numpy() < 0) & ok).any(axis=1).all()
    assert ((st.numpy() >= 0).sum(axis=1) <= POLICY.two_phase_pose_tile).all()


def test_rank_groups_raises_off_the_slice(setup):
    """The routes that needed a kernel still to port now rank: the
    orientation-weighted full mode (B3) on the single-phase route (K < 256)
    as the JAX package's does, and on the two-phase route, with the
    linearised coarse kernel (B4), as ``score_groups_two_phase`` does with the
    policy's knobs (held to JAX in tests/test_torch_full_rank.py and
    tests/test_torch_coarse_linear.py).  An unknown ranking mode raises."""
    import dataclasses

    from triplet_match_tpu_torch import config as tcfg

    jp, tp = setup["jpack"], setup["tpack"]
    rows = setup["rows"][:4, :32]
    ok = np.ones(rows.shape[:2], bool)
    ok[:, 3::5] = False
    groups = np.ascontiguousarray(setup["groups"][:4, :, :128])
    jpol = dataclasses.replace(POLICY, pallas_interpret=True, ranking_mode="full")
    ref = np.asarray(jsp.rank_groups(jp, jnp.asarray(groups), jnp.asarray(rows), setup["t2"],
                                     jnp.asarray(ok), jpol))
    full = dataclasses.replace(tcfg.SearchPolicy(), ranking_mode="full")
    tr, tok = torch.from_numpy(rows), torch.from_numpy(ok)
    got = tsk.rank_groups(tp, torch.from_numpy(groups), tr, setup["t2"], tok, full).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert (got[~ok] == -1.0).all() and (got[ok] > 0).any()
    groups = torch.from_numpy(np.ascontiguousarray(setup["groups"][:4]))
    for pol in (full, dataclasses.replace(tcfg.SearchPolicy(), two_phase_coarse_linear=True)):
        two, _ = tsk.score_groups_two_phase(
            tp, groups, tr, setup["t2"], tok, mode=pol.ranking_mode,
            pose_tile=pol.two_phase_pose_tile, coarse_stride=pol.two_phase_stride,
            keep_frac=pol.two_phase_keep_frac, fine_stride=pol.two_phase_fine_stride,
            coarse_linear=pol.two_phase_coarse_linear, fine_coarse=pol.two_phase_fine_coarse,
            fine_strict=pol.two_phase_fine_strict)
        ranked = tsk.rank_groups(tp, groups, tr, setup["t2"], tok, pol)
        torch.testing.assert_close(ranked, two, rtol=0, atol=0)
        assert (ranked[tok] >= 0).any()
    with pytest.raises(ValueError, match="mode"):
        tsk.score_groups_exact(tp, groups, tr, setup["t2"], mode="orientation")
