"""Multi-model search with raycast verification: PyTorch port vs JAX package.

The fixture is tests/test_baseline_configs.py's config 5 (two box models,
each planted once in uniform clutter, four origins), with the small search
knobs of tests/test_torch_find_all.py and the JAX side pinned to its Pallas
kernels in interpret mode.  The two packages draw different random samples,
so the search is held to outcomes: the same number of matches per model,
each within 8 mm / 1 deg of ground truth and of its JAX counterpart.  The
port's side runs through ``api.MultiMatcher``, which shares one prep across
its models.  Fed the JAX matches' own transforms and correspondences, the
port's raycast gives the JAX cast scores exactly.  No scene point is
claimed twice.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from triplet_match_tpu.config import DiscretizationParams, SampleParams, SearchPolicy
from triplet_match_tpu.core.cloud import PointCloud as JCloud
from triplet_match_tpu.core.transforms import pose_delta as jpose_delta
from triplet_match_tpu.index.model import compile_model as jcompile
from triplet_match_tpu.io.synthetic import make_box_model, rotation_matrix
from triplet_match_tpu.search import driver as jd
from triplet_match_tpu.verify import raycast as jrc

from triplet_match_tpu_torch import api, config as tcfg
from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.core.transforms import pose_delta
from triplet_match_tpu_torch.index.model import compile_model
from triplet_match_tpu_torch.index.serialize import save_model
from triplet_match_tpu_torch.search import driver as td
from triplet_match_tpu_torch.verify import raycast as trc

torch.set_num_threads(2)

SAMPLE = SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
TSAMPLE = tcfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
KNOBS = dict(num_first_samples=16, num_second_samples=8, query_cap=8, score_neighbors=256,
             finalists=2, max_rounds=2, two_phase_scoring=True)
TPOLICY = dataclasses.replace(tcfg.SearchPolicy(), **KNOBS)
FIND = dict(dist_thres=3.0, model_match_factor=0.5, max_icp_iterations=8, seed=3)
ORIGINS = np.array([[8, 0, 2], [-8, 0, 2], [0, 8, 2], [0, -8, 2]], np.float32)
MIN_CAST = 0.3


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The port's side: the models compiled from the numpy arrays, served
    through model files by a ``MultiMatcher`` (``driver.find_all_multi``
    underneath), with every ``prepare_scene`` call counted."""
    boxes = [make_box_model(n_edge=240, n_face=720, size=(1.0, 0.8, 0.6), seed=0),
             make_box_model(n_edge=240, n_face=720, size=(0.5, 0.5, 1.4), seed=1)]
    rng = np.random.default_rng(4)
    poses = [(rotation_matrix([0, 0, 1], 0.5), np.array([2.5, 0, 0], np.float32)),
             (rotation_matrix([1, 1, 0], 1.8), np.array([-2.5, 0, 0], np.float32))]
    parts, t_gts = [], []
    for (xyz, nrm, tan), (r, t) in zip(boxes, poses):
        parts.append((xyz @ r.T + t + rng.normal(0, 0.001, xyz.shape).astype(np.float32),
                      nrm @ r.T, tan @ r.T))
        tg = np.eye(4, dtype=np.float32)
        tg[:3, :3], tg[:3, 3] = r, t
        t_gts.append(tg)
    clutter = rng.uniform(-5, 5, (1000, 3)).astype(np.float32)
    kn = rng.normal(size=(1000, 3)).astype(np.float32)
    kn /= np.linalg.norm(kn, axis=1, keepdims=True)
    scene = tuple(np.concatenate([p[i] for p in parts] + [c])
                  for i, c in enumerate((clutter, kn, np.zeros_like(clutter))))
    tmodels, amodels = [], []
    for i, b in enumerate(boxes):
        tmodels.append(compile_model(PointCloud.from_arrays(*b, device="cpu"),
                                     tcfg.DiscretizationParams(), TSAMPLE, tcfg.SearchPolicy(),
                                     pair_block=128))
        path = str(tmp_path_factory.mktemp("m") / f"model{i}.npz")
        save_model(path, tmodels[-1], tcfg.DiscretizationParams())
        amodels.append(api.Model.load(path, policy=TPOLICY, device="cpu"))
    tscene = PointCloud.from_arrays(*scene, device="cpu")
    preps = []
    real = td.prepare_scene
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(td, "prepare_scene", lambda *a, **k: preps.append(1) or real(*a, **k))
        mm = api.MultiMatcher(amodels, policy=TPOLICY, min_capacity=512,
                              raycast_origins=ORIGINS, min_cast_score=MIN_CAST)
        tres = mm.match(tscene, sample_params=TSAMPLE, **FIND)
    tstats = [dict(s) for s in td.LAST_MULTI_SEARCH_STATS]
    return dict(boxes=boxes, scene=scene, t_gts=t_gts, tmodels=tmodels, amodels=amodels,
                tscene=tscene, tres=tres, tstats=tstats, preps=len(preps), mm=mm)


@pytest.fixture(scope="module")
def jax_side(fixture):
    jmodels = [jcompile(JCloud.from_arrays(*b), DiscretizationParams(), SAMPLE, SearchPolicy(),
                        pair_block=128) for b in fixture["boxes"]]
    jpol = dataclasses.replace(SearchPolicy(), scorer="pallas", pallas_interpret=True, **KNOBS)
    jres = jd.find_all_multi(jmodels, JCloud.from_arrays(*fixture["scene"]),
                             raycast_origins=ORIGINS, min_cast_score=MIN_CAST, policy=jpol,
                             sample_params=SAMPLE, discretization=DiscretizationParams(), **FIND)
    return jmodels, jres


def _close(a, b, mm=8.0, deg=1.0):
    dt, dr = pose_delta(torch.from_numpy(np.asarray(a, np.float64)),
                        torch.from_numpy(np.asarray(b, np.float64)))
    return float(dt) < mm * 1e-3 and float(np.degrees(float(dr))) < deg


def test_find_all_multi_matches_jax(fixture, jax_side):
    _, jres = jax_side
    tres, t_gts = fixture["tres"], fixture["t_gts"]
    assert len(tres) == len(jres) == 2
    for tm, jm, tg in zip(tres, jres, t_gts):
        assert jm and len(tm) == len(jm)
        for a, b in zip(tm, jm):
            jt, jr = jpose_delta(jnp.asarray(b.transform), jnp.asarray(tg))
            assert float(jt) < 8e-3 and float(np.degrees(float(jr))) < 1.0
            assert _close(a.transform, tg) and _close(a.transform, b.transform)
            assert MIN_CAST <= a.cast_score <= 1.0 and MIN_CAST <= b.cast_score <= 1.0
    for st in fixture["tstats"]:
        assert {"search_s", "raycast_s", "cast_survivors", "exact_kernel_launches",
                "coarse_kernel_launches", "full_kernel_launches",
                "coarse_linear_kernel_launches", "rounds"} <= set(st)
        assert st["coarse_kernel_launches"] == 0  # CPU tensors: the plain versions ran
        surv = st["cast_survivors"]  # per match, one count per origin
        assert surv and len(surv) % len(ORIGINS) == 0
        assert all(0 < s <= fixture["tscene"].capacity for s in surv)


def test_raycast_reproduces_jax_cast_scores(fixture, jax_side):
    """The JAX matches' transforms and correspondences through the port's
    raycast give the JAX cast scores exactly."""
    jmodels, jres = jax_side
    scene = fixture["tscene"]
    for jm_model, tmodel, matches in zip(jmodels, fixture["tmodels"], jres):
        res = float(jm_model.resolution)
        for m in matches:
            vis = trc.cast_visibility_multi(ORIGINS, tmodel.cloud.xyz, tmodel.cloud.valid,
                                            torch.from_numpy(np.array(m.transform)),
                                            scene.xyz, scene.valid, res, 2.0 * res)
            jvis = jrc.cast_visibility_multi(ORIGINS, jm_model.cloud.xyz, jm_model.cloud.valid,
                                             jnp.asarray(m.transform),
                                             jnp.asarray(fixture["scene"][0]),
                                             jnp.ones(scene.capacity, bool), res, 2.0 * res)
            np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
            assert float(trc.cast_score_matched(vis, m.model_corrs)) == m.cast_score


def test_no_scene_point_is_claimed_twice(fixture):
    claimed = np.concatenate([m.scene_corrs for ms in fixture["tres"] for m in ms])
    assert claimed.size and np.unique(claimed).size == claimed.size
    # model B searched a prep without model A's claimed points
    a = np.concatenate([m.scene_corrs for m in fixture["tres"][0]])
    b = np.concatenate([m.scene_corrs for m in fixture["tres"][1]])
    assert not np.intersect1d(a, b).size


def test_multimatcher_shares_one_prep_and_checks_params(fixture, monkeypatch):
    amodels = fixture["amodels"]
    assert fixture["preps"] == 1 and len(fixture["tres"]) == 2
    st = fixture["mm"].statistics
    assert st.matches_accepted == sum(len(r) for r in fixture["tres"]) and st.rounds >= 2
    assert st.rounds == sum(s["rounds"] for s in fixture["tstats"])
    other = api.Model(PointCloud.from_arrays(*fixture["boxes"][1], device="cpu"),
                      tcfg.DiscretizationParams(distance_step_count=16), TPOLICY)
    with pytest.raises(ValueError, match="DiscretizationParams"):
        api.MultiMatcher([amodels[0], other])
    with pytest.raises(ValueError):
        api.MultiMatcher([])
    preps = []
    real = td.prepare_scene
    monkeypatch.setattr(td, "prepare_scene", lambda *a, **k: preps.append(1) or real(*a, **k))
    caps = api.MultiMatcher(amodels, policy=TPOLICY, min_capacity=2048).warmup(
        [1000], dense=False, sample_params=TSAMPLE, **FIND)
    assert caps == [2048] and len(preps) == 1
    assert len(td.LAST_MULTI_SEARCH_STATS) == 2


def _baseline_script():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "run_baseline_configs.py"
    spec = importlib.util.spec_from_file_location("_run_baseline_configs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Captured(Exception):
    pass


@pytest.mark.parametrize("config", ["1", "2", "5", "6"])
def test_baseline_scene_builders_equal_the_script(config, monkeypatch):
    """``io.synthetic.baseline_*_arrays`` (what ``protocol_torch.py baseline``
    and ``chip_smoke.py`` search) build the clouds, ground truths and
    origins of ``scripts/run_baseline_configs.py`` bit for bit: the script
    runs with its detectors and searches replaced by recorders (config 5 at a
    tenth of its clutter, config 6 at its ``--small`` size; configs 3 and 4
    are config 5's builder with one model)."""
    from types import SimpleNamespace

    import triplet_match_tpu.index.model as jim
    import triplet_match_tpu.primitives.detect as jdet
    from triplet_match_tpu_torch.io import synthetic as ts

    script = _baseline_script()
    seen = {"clouds": [], "t_gt": []}

    def record(cloud, *a, **k):
        seen["clouds"].append(tuple(np.asarray(getattr(cloud, f))
                                    for f in ("xyz", "normal", "tangent")))
        raise _Captured

    def compile_model(cloud, *a, **k):
        seen["clouds"].append(tuple(np.asarray(getattr(cloud, f))
                                    for f in ("xyz", "normal", "tangent")))
        return SimpleNamespace(keys=jnp.zeros(1))

    def prepare(cloud, *a, **k):
        seen["scene"] = tuple(np.asarray(getattr(cloud, f)) for f in ("xyz", "normal", "tangent"))
        return SimpleNamespace(tangent_mask=jnp.zeros(1))

    def sym_delta(transform, t_gt):
        seen["t_gt"].append(np.asarray(t_gt))
        return 0.0, 0.0

    hit = SimpleNamespace(transform=np.eye(4, dtype=np.float32), cast_score=None)
    monkeypatch.setattr(jdet, "detect_plane", record)
    monkeypatch.setattr(jdet, "detect_cylinder", record)
    monkeypatch.setattr(jim, "compile_model", compile_model)
    monkeypatch.setattr(jd, "prepare_scene", prepare)
    monkeypatch.setattr(jd, "find_all", lambda *a, **k: [hit, hit])
    monkeypatch.setattr(script, "_sym_delta", sym_delta)

    def multi(models, scene, raycast_origins=None, **k):
        seen["origins"] = raycast_origins
        seen["scene"] = tuple(np.asarray(getattr(scene, f)) for f in ("xyz", "normal", "tangent"))
        return [[hit] for _ in models]

    monkeypatch.setattr(jd, "find_all_multi", multi)
    if config in ("1", "2"):
        with pytest.raises(_Captured):
            (script.config1_plane if config == "1" else script.config2_cylinder)(False)
        xyz, nrm, _ = ts.baseline_plane_arrays() if config == "1" else ts.baseline_cylinder_arrays()
        got, = seen["clouds"]
        np.testing.assert_array_equal(got[0], xyz)
        np.testing.assert_array_equal(got[1], nrm)
        return
    if config == "5":
        script._match_config("5", 100_000 - 4800, True, raycast=True, multi=True,
                             two_models=True)
        models, scene, t_gts = ts.baseline_match_arrays(10_000 - 480, two_models=True)
        np.testing.assert_array_equal(seen["origins"], ts.BASELINE_ORIGINS)
    else:
        script.config6_two_instances(True)
        model, scene, t_gts = ts.baseline_two_instances_arrays(16384)
        models = [model]
    for got, ref in zip(seen["clouds"], models):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(seen["scene"], scene):
        np.testing.assert_array_equal(a, b)
    assert len(seen["t_gt"]) >= len(t_gts)
    for a, b in zip(seen["t_gt"], t_gts):
        np.testing.assert_array_equal(a, b)
