"""Exact ranking (TPU kernel B2): PyTorch port vs JAX package.

On the CPU the port runs ``score_groups_exact_plain``; the JAX side runs
``score_groups_pallas(mode="count")`` in Pallas interpret mode at "highest"
precision.  Parity contract (``score_kernel.check_exact_parity``): counts
equal, except points whose float64 distance lies within 1e-5 * gate of the
gate or of the other kind's distance; weighted/signed scores within 1e-5
relative.  The CUDA kernel against the plain version is in
tests/test_torch_kernels_cuda.py.
"""

import dataclasses

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

from triplet_match_tpu_torch import config as tcfg
from triplet_match_tpu_torch.index.model import compiled_model_from_numpy
from triplet_match_tpu_torch.search import score_kernel as tsk

torch.set_num_threads(2)

KNOBS = {"plain": (False, False), "weighted": (True, False), "negative": (False, True),
         "both": (True, True)}


@pytest.fixture(scope="module")
def setup():
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    jm = compile_model(JCloud.from_arrays(xyz, nrm, tan), DiscretizationParams(),
                       SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95),
                       SearchPolicy(), pair_block=128)
    d = {f"cloud_{k}": np.asarray(getattr(jm.cloud, k)) for k in _CLOUD_FIELDS}
    d.update({k: np.asarray(getattr(jm, k)) for k in _MODEL_FIELDS})
    d["margin"] = jm.margin
    tm = compiled_model_from_numpy(d, device="cpu")
    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=200, seed=7)
    prep = prepare_scene(scene, SearchPolicy())
    jpack = jsp.pack_model(jm, coarse_points=256, fine_points=512)
    tpack = tsk.pack_model(tm, coarse_points=256, fine_points=512)

    g, hg, k = 8, 32, 256
    rng = np.random.default_rng(5)
    n = prep.cloud.xyz.shape[0]
    nbr_idx = rng.integers(0, n, (g, k)).astype(np.int32)
    nbr_valid = rng.random((g, k)) > 0.1
    t_inv = np.linalg.inv(np.asarray(t_gt)).astype(np.float32)
    ts = np.tile(t_inv, (g, hg, 1, 1))
    ts[:, : hg // 2, :3, 3] += rng.normal(0, 0.004, (g, hg // 2, 3)).astype(np.float32)
    ts[:, hg // 2:, :3, 3] += rng.normal(0, 0.3, (g, hg - hg // 2, 3)).astype(np.float32)
    groups = np.array(jsp.pack_groups(prep.cloud, prep.tangent_mask, jnp.zeros(n, bool),
                                        jnp.asarray(nbr_idx), jnp.asarray(nbr_valid)))
    rows = np.array(jsp.poses_to_rows(jnp.asarray(ts)))
    thres = 3.0 * float(jm.resolution)
    return dict(jpack=jpack, tpack=tpack, groups=groups, rows=rows, t2=thres * thres, ts=ts)


@pytest.mark.parametrize("k", [64, 256])
@pytest.mark.parametrize("knobs", list(KNOBS))
def test_exact_plain_matches_jax(setup, k, knobs):
    weighted, negative = KNOBS[knobs]
    jp, tp = setup["jpack"], setup["tpack"]
    groups = np.ascontiguousarray(setup["groups"][:, :, :k])
    rows, t2 = setup["rows"], setup["t2"]
    js, jc = jsp.score_groups_pallas(jp, jnp.asarray(groups), jnp.asarray(rows), t2,
                                     mode="count", pose_tile=8, interpret=True,
                                     mxu_precision="highest", weighted_distance=weighted,
                                     negative_scores=negative)
    got = tsk.score_groups_exact(tp, torch.from_numpy(groups), torch.from_numpy(rows), t2,
                                 weighted_distance=weighted, negative_scores=negative)
    assert got[1].dtype == torch.int32
    shifted = torch.from_numpy(rows).clone()
    shifted[..., 9:12] -= tp.center
    me, ms = tsk.exact_blocks(tp)
    _, excused = tsk.check_exact_parity(
        got, (torch.from_numpy(np.array(js)), torch.from_numpy(np.array(jc))),
        torch.from_numpy(groups), shifted, me, ms, float(np.float32(t2)))
    assert excused == 0  # the plain version reproduces the interpret kernel's rounding
    cnt = got[1].numpy()
    hg = rows.shape[1]
    # the ranking is informative: near-true poses outcount junk in every group
    assert (cnt[:, : hg // 2].mean(1) > cnt[:, hg // 2:].mean(1)).all()
    if not (weighted or negative):
        np.testing.assert_array_equal(got[0].numpy(), cnt.astype(np.float32))
    assert tsk.EXACT_RANK.launches == 0  # the CPU path never counts a launch


def test_exact_blocks_sweep_only_model_points(setup):
    tp = setup["tpack"]
    me, ms = tsk.exact_blocks(tp)
    assert me.shape[1] == tp.n_edge_cols > 0 and ms.shape[1] == tp.n_surf_cols > 0
    assert tp.md_edge.shape[1] % 128 == 0 and tp.md_edge.shape[1] > me.shape[1]
    assert float(tp.md_edge[0, me.shape[1]]) == tsk._FAR  # the rest is padding
    assert (me[0].abs() < tsk._FAR).all() and (ms[0].abs() < tsk._FAR).all()


def test_exact_two_phase_keep_set_identical_under_ties(setup):
    """The fog route's two-phase configuration (B2 in both phases, keep 1/8,
    full-K phase 2): the keep set and the survivor counts must equal JAX's
    under many exact ties."""
    jp, tp = setup["jpack"], setup["tpack"]
    distinct = setup["ts"][:, ::4]  # 8 distinct poses per group, each repeated 4 times
    ts = np.repeat(distinct, 4, axis=1)
    rows = np.array(jsp.poses_to_rows(jnp.asarray(ts)))
    ok = np.ones(rows.shape[:2], bool)
    ok[:, 5::7] = False
    kw = dict(pose_tile=8, coarse_stride=8, keep_frac=8, fine_stride=1, fine_coarse=False,
              coarse_model=False)
    sj, cj = jsp.score_groups_two_phase(jp, jnp.asarray(setup["groups"]), jnp.asarray(rows),
                                        setup["t2"], jnp.asarray(ok), interpret=True, **kw)
    st, ct = tsk.score_groups_two_phase(tp, torch.from_numpy(setup["groups"]),
                                        torch.from_numpy(rows), setup["t2"],
                                        torch.from_numpy(ok), **kw)
    sj, cj = np.asarray(sj), np.asarray(cj)
    np.testing.assert_array_equal(st.numpy() >= 0, sj >= 0)  # identical keep sets
    np.testing.assert_array_equal(ct.numpy(), cj)
    np.testing.assert_array_equal(st.numpy(), sj)
    assert ((st.numpy() < 0) & ok).any(axis=1).all()  # ties dropped copies of kept poses
    assert ((st.numpy() >= 0).sum(axis=1) == 8).all()


@pytest.mark.parametrize("knobs", ["plain", "both"])
def test_rank_groups_single_phase_matches_jax(setup, knobs):
    """K < 256, or a weighted/negative knob: every pose ranks once through B2."""
    weighted, negative = KNOBS[knobs]
    jp, tp = setup["jpack"], setup["tpack"]
    k = 128 if knobs == "plain" else 256
    groups = np.ascontiguousarray(setup["groups"][:, :, :k])
    rows = setup["rows"]
    ok = np.ones(rows.shape[:2], bool)
    ok[:, 3::5] = False
    jpol = dataclasses.replace(SearchPolicy(), pallas_interpret=True, weighted_distance=weighted,
                               negative_scores=negative)
    tpol = dataclasses.replace(tcfg.SearchPolicy(), weighted_distance=weighted,
                               negative_scores=negative)
    ref = np.asarray(jsp.rank_groups(jp, jnp.asarray(groups), jnp.asarray(rows), setup["t2"],
                                     jnp.asarray(ok), jpol))
    got = tsk.rank_groups(tp, torch.from_numpy(groups), torch.from_numpy(rows), setup["t2"],
                          torch.from_numpy(ok), tpol).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    invalid = -1e12 if negative else -1.0
    assert (got[~ok] == np.float32(invalid)).all()
