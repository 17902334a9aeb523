"""Orientation-weighted ranking (TPU kernel B3): PyTorch port vs JAX package.

On the CPU the port runs ``score_groups_full_plain``; the JAX side runs
``score_groups_pallas(mode="full")`` in Pallas interpret mode at "highest"
precision.  Parity contract (``score_kernel.check_exact_parity``): counts
equal, scores within 1e-5 relative (at least 1e-5 absolute) — the per-point
terms agree bit for bit, and the float32 sum over the K points runs in
another order than the port's double sum.  Against the jnp oracle
``score_groups_exact_jnp(orientation=True)`` the tolerance is the JAX test's
rtol of 2e-4: the oracle ties on d2 = |tp|^2 + E, not on E.  The CUDA kernel
against the plain version is in tests/test_torch_kernels_cuda.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from triplet_match_tpu.core.cloud import PointCloud as JCloud
from triplet_match_tpu.core.cloud import resolution as jresolution
from triplet_match_tpu.io.synthetic import embed_in_scene, make_box_model
from triplet_match_tpu.search import score_pallas as jsp

from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.search import score_kernel as tsk

torch.set_num_threads(2)

KNOBS = {"plain": (False, False), "weighted+negative": (True, True)}


def _models(xyz, nrm, tan):
    """JAX and port stand-ins for a compiled model: the packs and the oracle
    read only its cloud and resolution."""
    jcloud = JCloud.from_arrays(xyz, nrm, tan)
    return (SimpleNamespace(cloud=jcloud, resolution=jresolution(jcloud)),
            SimpleNamespace(cloud=PointCloud.from_arrays(xyz, nrm, tan, device="cpu")))


@pytest.fixture(scope="module")
def setup():
    """The fixture of tests/test_score_pallas.py: box model 120 + 360 points,
    G=2, Hg=8, K=128, near-true and junk poses; the scene's tangent-bearing
    points stand in for its detected edges."""
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    jm, tm = _models(xyz, nrm, tan)
    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=200, seed=7)
    tangent_mask = (jnp.linalg.norm(scene.tangent, axis=-1) > 0.7) & scene.valid
    g, hg, k = 2, 8, 128
    rng = np.random.default_rng(3)
    n = scene.xyz.shape[0]
    nbr_idx = rng.integers(0, n, (g, k)).astype(np.int32)
    nbr_valid = rng.random((g, k)) > 0.1
    ts = np.tile(np.linalg.inv(np.asarray(t_gt)).astype(np.float32), (g, hg, 1, 1))
    ts[:, : hg // 2, :3, 3] += rng.normal(0, 0.002, (g, hg // 2, 3)).astype(np.float32)
    ts[:, hg // 2:, :3, 3] += rng.normal(0, 1.0, (g, hg - hg // 2, 3)).astype(np.float32)
    consumed = jnp.zeros(n, bool)
    groups = np.array(jsp.pack_groups(scene, tangent_mask, consumed, jnp.asarray(nbr_idx),
                                      jnp.asarray(nbr_valid)))
    thres = 3.0 * float(jm.resolution)
    return dict(jm=jm, tm=tm, scene=scene, tangent_mask=tangent_mask, ts=ts, nbr_idx=nbr_idx,
                nbr_valid=nbr_valid, consumed=consumed, groups=groups,
                rows=np.array(jsp.poses_to_rows(jnp.asarray(ts))), t2=thres * thres, xyz=xyz,
                nrm=nrm, tan=tan)


def _full_vs_jax(jpack, tpack, groups, rows, t2, weighted=False, negative=False):
    js, jc = jsp.score_groups_pallas(jpack, jnp.asarray(groups), jnp.asarray(rows), t2,
                                     mode="full", pose_tile=2, interpret=True,
                                     mxu_precision="highest", weighted_distance=weighted,
                                     negative_scores=negative)
    got = tsk.score_groups_exact(tpack, torch.from_numpy(groups), torch.from_numpy(rows), t2,
                                 mode="full", weighted_distance=weighted, negative_scores=negative)
    shifted = torch.from_numpy(rows).clone()
    shifted[..., 9:12] -= tpack.center
    me, ms = tsk.exact_blocks(tpack)
    _, excused = tsk.check_exact_parity(
        got, (torch.from_numpy(np.array(js)), torch.from_numpy(np.array(jc))),
        torch.from_numpy(groups), shifted, me, ms, float(np.float32(t2)))
    assert excused == 0  # counts equal, scores within 1e-5 relative
    # the plain version called directly gives the wrapper's result
    direct = tsk.score_groups_full_plain(torch.from_numpy(groups), shifted, me, ms,
                                         *tsk.ref_blocks(tpack), tsk._f32(t2),
                                         tsk._inv2t(tsk._f32(t2)), weighted, negative)
    torch.testing.assert_close(direct, got, rtol=0, atol=0)
    return got


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_full_plain_matches_jax_interpret(setup, knobs):
    weighted, negative = KNOBS[knobs]
    jpack, tpack = jsp.pack_model(setup["jm"]), tsk.pack_model(setup["tm"])
    got = _full_vs_jax(jpack, tpack, setup["groups"], setup["rows"], setup["t2"], weighted,
                       negative)
    hg = setup["rows"].shape[1]
    # orientation-weighted: near-true poses outscore junk, and a score never
    # exceeds the count it weights
    assert (got[0][:, : hg // 2].mean(1) > got[0][:, hg // 2:].mean(1)).all()
    if not negative:
        assert (got[0] <= got[1].float() + 1e-6).all() and (got[0] > 0).any()
    assert tsk.FULL_RANK.launches == 0  # the CPU path never counts a launch


def test_full_plain_matches_jnp_oracle(setup):
    jpack, tpack = jsp.pack_model(setup["jm"]), tsk.pack_model(setup["tm"])
    s_ref, c_ref = jsp.score_groups_exact_jnp(
        setup["jm"], setup["scene"], setup["tangent_mask"], setup["consumed"],
        jnp.asarray(setup["nbr_idx"]), jnp.asarray(setup["nbr_valid"]), jnp.asarray(setup["ts"]),
        3.0, orientation=True)
    got = tsk.score_groups_exact(tpack, torch.from_numpy(setup["groups"]),
                                 torch.from_numpy(setup["rows"]), setup["t2"], mode="full")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(c_ref))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(s_ref), rtol=2e-4, atol=2e-4)
    assert jpack.n_pad == tpack.n_pad


def test_full_tie_set_mean_with_duplicated_points(setup):
    """Duplicated model points whose reference vectors differ: the tie set
    holds both copies, and w_at_min is the mean of their orientation products
    (here a tangent and its 90-degree turn), not either one."""
    xyz, nrm, tan = setup["xyz"], setup["nrm"], setup["tan"]
    edge = np.linalg.norm(tan, axis=1) > 0.7
    dup = np.flatnonzero(edge)[::2]
    turned = np.cross(nrm[dup], tan[dup]).astype(np.float32)
    xyz2 = np.concatenate([xyz, xyz[dup]])
    nrm2 = np.concatenate([nrm, nrm[dup]])
    tan2 = np.concatenate([tan, turned / np.linalg.norm(turned, axis=1, keepdims=True)])
    jm, tm = _models(xyz2, nrm2, tan2)
    jpack, tpack = jsp.pack_model(jm), tsk.pack_model(tm)
    # the duplicates sit at the same centred coordinates as their originals
    me = tsk.exact_blocks(tpack)[0].numpy()
    assert np.unique(me[:3].T, axis=0).shape[0] < me.shape[1]
    got = _full_vs_jax(jpack, tpack, setup["groups"], setup["rows"], setup["t2"])
    single = tsk.score_groups_exact(tsk.pack_model(setup["tm"]),
                                    torch.from_numpy(setup["groups"]),
                                    torch.from_numpy(setup["rows"]), setup["t2"], mode="full")
    assert not torch.equal(got[0], single[0])  # the averaged ties moved the scores


def test_two_phase_full_mode_matches_jax(setup):
    """The two-phase route in full mode: B1 phase 1, B3 phase 2 — also with
    ``fine_coarse=True``, which full mode must ignore (the fine block ranks
    counts only, score_pallas.py:1187)."""
    jpack = jsp.pack_model(setup["jm"], coarse_points=256, fine_points=512)
    tpack = tsk.pack_model(setup["tm"], coarse_points=256, fine_points=512)
    rows = setup["rows"]
    groups = np.ascontiguousarray(np.concatenate([setup["groups"]] * 2, axis=2))  # K = 256
    ok = np.ones(rows.shape[:2], bool)
    ok[:, 5] = False
    kw = dict(pose_tile=2, coarse_stride=4, keep_frac=2, fine_stride=2, coarse_model=True)
    sj, cj = jsp.score_groups_two_phase(jpack, jnp.asarray(groups), jnp.asarray(rows),
                                        setup["t2"], jnp.asarray(ok), mode="full",
                                        fine_coarse=True, interpret=True, **kw)
    sj, cj = np.asarray(sj), np.asarray(cj)
    results = []
    for fine_coarse in (False, True):
        st, ct = tsk.score_groups_two_phase(tpack, torch.from_numpy(groups),
                                            torch.from_numpy(rows), setup["t2"],
                                            torch.from_numpy(ok), mode="full",
                                            fine_coarse=fine_coarse, **kw)
        np.testing.assert_array_equal(st.numpy() >= 0, sj >= 0)  # identical keep sets
        np.testing.assert_array_equal(ct.numpy(), cj)
        np.testing.assert_allclose(st.numpy(), sj, rtol=1e-5, atol=1e-5)
        results.append(st)
    # full mode ranks the survivors through B3 either way, never the fine block
    torch.testing.assert_close(results[0], results[1], rtol=0, atol=0)
