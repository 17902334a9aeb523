"""The fog-density route end to end: PyTorch port vs JAX package.

A search round under the fog policy with JAX's own random draws (as
tests/test_torch_round.py does for the standard route), and ``find_all`` with
the fog switch forced by a small ``fine_full_rescore_ratio``, held to
outcomes because the two packages draw different samples.  The JAX side
ranks through its Pallas kernels in interpret mode.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triplet_match_tpu.config import DiscretizationParams, SampleParams, SearchPolicy
from triplet_match_tpu.core.cloud import PointCloud as JCloud
from triplet_match_tpu.core.transforms import pose_delta as jpose_delta
from triplet_match_tpu.index.model import compile_model
from triplet_match_tpu.index.serialize import _CLOUD_FIELDS, _MODEL_FIELDS
from triplet_match_tpu.io.synthetic import embed_in_scene, make_box_model
from triplet_match_tpu.search import driver as jd
from triplet_match_tpu.search import score_pallas as jsp

from triplet_match_tpu_torch import config as tcfg
from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.core.transforms import pose_delta
from triplet_match_tpu_torch.index.model import compiled_model_from_numpy
from triplet_match_tpu_torch.search import driver as td
from triplet_match_tpu_torch.search import score_kernel as tsk
from triplet_match_tpu_torch.search.sampling import RoundDraws

torch.set_num_threads(2)

SAMPLE = SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
TSAMPLE = tcfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
KNOBS = dict(num_first_samples=16, num_second_samples=8, query_cap=8, score_neighbors=256,
             finalists=2, max_rounds=2, two_phase_scoring=True)
# what the fog switch sets (driver.py:1151-1204), with a subset capacity
# below this small scene's size so that the subset join runs
FOG = dict(two_phase_coarse_model=False, two_phase_fine_coarse=False, two_phase_fine_stride=1,
           two_phase_keep_frac=8, finalists=16, finalist_prescreen=2, rank_edges_only=True,
           tight_edges_only=True, tight_point_to_line=True, join_subset_capacity=640,
           scene_raw_tangents=True)
FIND = dict(dist_thres=3.0, model_match_factor=0.5, max_icp_iterations=5, seed=13)


@pytest.fixture(scope="module")
def fixture():
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    jm = compile_model(JCloud.from_arrays(xyz, nrm, tan), DiscretizationParams(), SAMPLE,
                       SearchPolicy(), pair_block=128)
    d = {f"cloud_{k}": np.asarray(getattr(jm.cloud, k)) for k in _CLOUD_FIELDS}
    d.update({k: np.asarray(getattr(jm, k)) for k in _MODEL_FIELDS})
    d["margin"] = jm.margin
    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=200, seed=7)
    tscene = PointCloud.from_arrays(*(np.array(getattr(scene, f))
                                      for f in ("xyz", "normal", "tangent", "valid")), device="cpu")
    return jm, compiled_model_from_numpy(d, device="cpu"), scene, tscene, t_gt


def test_fog_policy_is_the_switch(fixture):
    _, tm, _, tscene, _ = fixture
    base = dataclasses.replace(tcfg.SearchPolicy(), **KNOBS)
    tprep = td.prepare_scene(tscene, base)
    pol, prep = td.fog_policy(dataclasses.replace(base, join_subset_capacity=640), tprep, tm)
    assert pol == dataclasses.replace(base, **FOG)
    raw = (torch.linalg.vector_norm(tscene.tangent, dim=-1) > 0.7) & tscene.valid
    assert torch.equal(prep.tangent_mask, raw) and int(prep.n_edge) == 120
    auto, _ = td.fog_policy(base, tprep, tm)
    assert auto.join_subset_capacity == td._auto_join_capacity(tscene.capacity) == tscene.capacity
    assert td._auto_join_capacity(500000) == 65536 and td._auto_join_capacity(2000000) == 131072


def test_fog_search_round_matches_jax(fixture):
    jm, tm, scene, tscene, t_gt = fixture
    jpol = dataclasses.replace(SearchPolicy(), scorer="pallas", pallas_interpret=True,
                               **{**KNOBS, **FOG})
    tpol = dataclasses.replace(tcfg.SearchPolicy(), **{**KNOBS, **FOG})
    jprep = jd.prepare_scene(scene, SearchPolicy())
    raw = (jnp.linalg.norm(jprep.cloud.tangent, axis=-1) > 0.7) & jprep.cloud.valid
    jprep = jd.ScenePrep(cloud=jprep.cloud, tangent_mask=raw, n_edge=jnp.sum(raw))
    _, tprep = td.fog_policy(tpol, td.prepare_scene(tscene, tpol), tm)
    n = scene.xyz.shape[0]

    key = jax.random.fold_in(jax.random.PRNGKey(13), 0)
    k1, k2, k3, k4 = jax.random.split(key, 4)

    def words(k, salt):
        return tuple(int(v) for v in
                     np.asarray(jax.random.key_data(jax.random.fold_in(k, salt))).reshape(-1))

    gumbel = np.array(jax.random.gumbel(k2, (tpol.num_first_samples, tpol.second_pool)))
    draws = RoundDraws(words(k1, 1), words(k3, 0), words(k4, 0), torch.from_numpy(gumbel))

    round_fn = jax.jit(functools.partial(jd.search_round, discretization=DiscretizationParams(),
                                         sample_params=SAMPLE, policy=jpol, max_icp_iterations=5))
    jpack = jsp.pack_model_cached(jm, coarse_points=256, fine_points=512)
    jres, jcons, jfp = round_fn(jm, jprep, np.zeros(n, bool), np.zeros(n, bool), key,
                                jnp.float32(3.0), jnp.float32(0.5), jpack)
    tpack = tsk.pack_model_cached(tm, coarse_points=256, fine_points=512)
    zeros = torch.zeros(n, dtype=torch.bool)
    tres, tcons, tfp = td.search_round(tm, tprep, zeros, zeros.clone(), draws, 3.0, 0.5, tpack,
                                       discretization=tcfg.DiscretizationParams(),
                                       sample_params=TSAMPLE, policy=tpol, max_icp_iterations=5)

    np.testing.assert_array_equal(tres.accept.numpy(), np.asarray(jres.accept))
    np.testing.assert_array_equal(tres.count.numpy(), np.asarray(jres.count))
    np.testing.assert_array_equal(tres.new_corr.numpy(), np.asarray(jres.new_corr))
    np.testing.assert_array_equal(tcons.numpy(), np.asarray(jcons))
    np.testing.assert_array_equal(tfp.numpy(), np.asarray(jfp))
    assert int(tres.hypotheses_scored) == int(jres.hypotheses_scored)
    assert int(tres.join_overflow) == int(jres.join_overflow)
    new = np.asarray(jres.new_corr)
    np.testing.assert_array_equal(tres.model_idx.numpy()[new], np.asarray(jres.model_idx)[new])
    assert tres.accept.any() and new.any()
    dt, dr = pose_delta(_orthonormal(np.asarray(jres.transform)), _orthonormal(tres.transform))
    assert float(dt.max()) < 1e-4
    assert float(np.degrees(float(dr.max()))) < 0.01
    assert tsk.EXACT_RANK.launches == 0 and tsk.COARSE_RANK.launches == 0


def test_find_all_fog_switch_matches_jax(fixture):
    jm, tm, scene, tscene, t_gt = fixture
    jpol = dataclasses.replace(SearchPolicy(), scorer="pallas", pallas_interpret=True,
                               fine_full_rescore_ratio=0.0, **KNOBS)
    tpol = dataclasses.replace(tcfg.SearchPolicy(), fine_full_rescore_ratio=0.0, **KNOBS)
    jmatches = jd.find_all(jm, scene, sample_params=SAMPLE, discretization=DiscretizationParams(),
                           policy=jpol, **FIND)
    jstats = dict(jd.LAST_SEARCH_STATS)
    tmatches = td.find_all(tm, tscene, sample_params=TSAMPLE,
                           discretization=tcfg.DiscretizationParams(), policy=tpol, **FIND)
    stats = td.LAST_SEARCH_STATS
    assert jmatches and len(tmatches) == len(jmatches)
    gt = torch.from_numpy(np.asarray(t_gt, np.float64))
    for a, b in zip(tmatches, jmatches):
        dt, dr = pose_delta(torch.from_numpy(a.transform).double(), gt)
        assert float(dt) < 6e-3 and float(np.degrees(float(dr))) < 0.6
        jt, jr = jpose_delta(jnp.asarray(b.transform), jnp.asarray(t_gt))
        assert float(jt) < 6e-3 and float(np.degrees(float(jr))) < 0.6
        dt, dr = pose_delta(torch.from_numpy(a.transform).double(),
                            torch.from_numpy(np.asarray(b.transform, np.float64)))
        assert float(dt) < 6e-3 and float(np.degrees(float(dr))) < 0.6
    assert jstats["fine_rescore_full"] is True and stats["fine_rescore_full"] is True
    for key in ("finalist_prescreen", "rank_edges_only", "tight_edges_only",
                "tight_point_to_line", "join_subset_capacity", "finalist_funnel",
                "scene_raw_tangents", "scene_n_edge_raw", "join_overflow_max"):
        assert stats[key] == jstats[key], key
    assert set(jstats) - {"round_fn_cache_hit", "pallas_interpret_forced"} <= set(stats)
    assert stats["exact_kernel_launches"] == 0 and stats["coarse_kernel_launches"] == 0


def _orthonormal(t) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(t, np.float64)).clone()
    u, _, vt = torch.linalg.svd(t[..., :3, :3])
    t[..., :3, :3] = u @ vt
    return t
