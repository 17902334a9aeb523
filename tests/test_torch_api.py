"""The port's object API (``Model`` / ``Scene`` / ``Matcher``) and model files
against the JAX package's ``api``.

A model saved by either package loads in the other with equal fields; the
accessors, ``query`` and ``voxel_query`` of a model loaded from the JAX
package's file equal the JAX ``Model``'s; the serving buckets equal
``_bucket_capacity``; a ``Matcher`` finds the planted pose on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from triplet_match_tpu import api as japi
from triplet_match_tpu.config import DiscretizationParams, SampleParams, SearchPolicy
from triplet_match_tpu.core.cloud import PointCloud as JCloud
from triplet_match_tpu.features.pairfeat import pair_feature
from triplet_match_tpu.index.serialize import load_model as jload_model
from triplet_match_tpu.io.synthetic import embed_in_scene, make_box_model

from triplet_match_tpu_torch import api, config as tcfg
from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.io.synthetic import sym_delta

torch.set_num_threads(2)

DISC = DiscretizationParams(distance_step_count=16)
TDISC = tcfg.DiscretizationParams(distance_step_count=16)
SAMPLE = SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
TSAMPLE = tcfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
# a small search: the policy of tests/test_torch_find_all.py
TPOLICY = dataclasses.replace(tcfg.SearchPolicy(), num_first_samples=16, num_second_samples=8,
                              query_cap=8, score_neighbors=256, finalists=2, max_rounds=2,
                              adaptive_second_samples=False)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    jmodel = japi.Model(JCloud.from_arrays(xyz, nrm, tan), DISC, SearchPolicy()).init(SAMPLE)
    path = str(tmp_path_factory.mktemp("m") / "jax_model.npz")
    jmodel.save(path)
    return (xyz, nrm, tan), jmodel, path


def test_model_saved_by_jax_loads_with_equal_accessors_and_queries(models):
    _, jmodel, path = models
    tmodel = api.Model.load(path, policy=tcfg.SearchPolicy(), device="cpu")
    assert tmodel._params == TDISC  # the stored discretization wins over the default
    for name in ("diameter", "resolution", "point_count", "pair_count", "extents", "margin"):
        assert getattr(tmodel, name)() == getattr(jmodel, name)(), name
    np.testing.assert_array_equal(tmodel.voxel_transform(), jmodel.voxel_transform())
    for a, b in zip(tmodel.feature_bounds(), jmodel.feature_bounds()):
        np.testing.assert_array_equal(a, b)
    comp = jmodel.compiled
    for n in range(0, 40, 7):
        i, j = (int(v) for v in np.asarray(comp.pairs[n]))
        f = np.asarray(pair_feature(comp.cloud.xyz[i], comp.cloud.xyz[j],
                                    comp.cloud.tangent[i], comp.cloud.tangent[j]))
        np.testing.assert_array_equal(tmodel.query(f), jmodel.query(f))
        assert (i, j) in {tuple(p) for p in tmodel.query(f)}
    xyz = np.asarray(comp.cloud.xyz)
    for pos in (xyz[0], xyz[101], xyz[5] + 0.01, np.array([50.0, 50, 50], np.float32)):
        assert tmodel.voxel_query(pos) == jmodel.voxel_query(pos)
    assert tmodel.voxel_query(xyz[0]) is not None


def test_model_saved_by_port_loads_in_jax(models, tmp_path):
    (xyz, nrm, tan), _, path = models
    tmodel = api.Model(PointCloud.from_arrays(xyz, nrm, tan, device="cpu"), TDISC).init(TSAMPLE)
    assert tmodel.pair_count() > 0 and tmodel.point_count() > 0
    ours = str(tmp_path / "port_model.npz")
    tmodel.save(ours)
    saved, ref = np.load(ours), np.load(path)
    assert saved.files == ref.files
    for k in saved.files:
        assert saved[k].dtype == ref[k].dtype, k
    jm = jload_model(ours)
    comp = tmodel.compiled
    for k in ("xyz", "normal", "tangent", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jm.cloud, k)),
                                      getattr(comp.cloud, k).numpy())
    for k in ("resolution", "diameter", "to_voxel", "lut", "edge", "bounds_min", "bounds_max",
              "keys", "pairs", "pair_count", "n_edge", "n_all"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, k)),
                                      getattr(comp, k).numpy().astype(saved[k].dtype), err_msg=k)
    jmodel = japi.Model.load(ours, policy=SearchPolicy())
    assert jmodel._params == DISC and jmodel.pair_count() == tmodel.pair_count()
    back = api.Model.load(ours, device="cpu")
    assert torch.equal(back.compiled.keys, comp.keys) and back._params == TDISC


def test_bucket_capacity_equals_jax():
    for min_cap in (1, 1000, 4096):
        m = api.Matcher.__new__(api.Matcher)
        m._min_capacity = min_cap
        for n in (1, 2, 999, 1000, 1025, 4096, 4097, 65536, 131071, 500000):
            assert m.bucket_capacity(n) == japi._bucket_capacity(n, min_cap, None)
            assert m.bucket_capacity(m.bucket_capacity(n)) == m.bucket_capacity(n)


def test_matcher_finds_the_planted_pose(models):
    (xyz, nrm, tan), _, _ = models
    tmodel = api.Model(PointCloud.from_arrays(xyz, nrm, tan, device="cpu"), TDISC,
                       TPOLICY).init(TSAMPLE)
    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=200, seed=7)
    sv = np.asarray(scene.valid)
    cloud = PointCloud.from_arrays(*(np.asarray(getattr(scene, f))[sv]
                                     for f in ("xyz", "normal", "tangent")), device="cpu")
    matcher = api.Matcher(tmodel, policy=TPOLICY, min_capacity=512)
    polls = []
    matches = matcher.match(cloud, dist_thres=3.0, model_match_factor=0.5,
                            sample_params=TSAMPLE, max_icp_iterations=5, progress=polls.append)
    assert matches
    dt, dr = sym_delta(matches[0].transform, t_gt)
    assert dt < 6e-3 and dr < 0.6
    st = matcher.statistics
    assert st.matches_accepted == len(matches) and st.rounds >= 1 and st.hypotheses_scored > 0
    assert polls and polls[0] == 0.0 and all(0.0 <= p <= 1.0 for p in polls)
    scene_api = api.Scene(cloud, TPOLICY)
    assert scene_api.instantiate(tmodel, matches[0]).shape == (xyz.shape[0], 3)


def test_unported_serving_surfaces_raise(models):
    _, _, path = models
    tmodel = api.Model.load(path, device="cpu")
    cloud = tmodel.cloud()
    with pytest.raises(TypeError, match="DeviceMesh"):
        api.MultiMatcher([tmodel], mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        api.Matcher(tmodel, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        api.Scene(cloud).find_all_parallel(tmodel, mesh=object())
    with pytest.raises(RuntimeError, match="uninitialized"):
        api.Model(tmodel.cloud()).query(np.zeros(4, np.float32))
