"""The whole search: PyTorch port vs JAX package on the box fixture.

The two packages draw different random samples (torch generator vs JAX
threefry), so the search is held to outcomes: the same number of matches,
each within 6 mm / 0.6 deg of ground truth and of its counterpart.
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
from triplet_match_tpu.io.synthetic import embed_in_scene, make_box_model
from triplet_match_tpu.search import driver as jd

from triplet_match_tpu_torch import config as tcfg
from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.core.transforms import pose_delta, strict_fp32
from triplet_match_tpu_torch.index.model import compile_model
from triplet_match_tpu_torch.search import driver as td

torch.set_num_threads(2)

SAMPLE = SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
TSAMPLE = tcfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
# the policy of tests/test_score_pallas.py::test_find_all_two_phase_pallas
KNOBS = dict(num_first_samples=16, num_second_samples=8, query_cap=8, score_neighbors=256,
             finalists=2, max_rounds=2, two_phase_scoring=True)
TPOLICY = dataclasses.replace(tcfg.SearchPolicy(), scorer="pallas", pallas_interpret=True, **KNOBS)
FIND = dict(dist_thres=3.0, model_match_factor=0.5, max_icp_iterations=5, seed=13)


@pytest.fixture(scope="module")
def fixture():
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=200, seed=7)
    tmodel = compile_model(PointCloud.from_arrays(xyz, nrm, tan, device="cpu"),
                           tcfg.DiscretizationParams(),
                           TSAMPLE, tcfg.SearchPolicy(), pair_block=128)
    tscene = PointCloud.from_arrays(*(np.array(getattr(scene, f))
                                      for f in ("xyz", "normal", "tangent", "valid")), device="cpu")
    return (xyz, nrm, tan), scene, t_gt, tmodel, tscene


def test_find_all_matches_jax(fixture):
    (xyz, nrm, tan), scene, t_gt, tmodel, tscene = fixture
    jmodel = jcompile(JCloud.from_arrays(xyz, nrm, tan), DiscretizationParams(), SAMPLE,
                      SearchPolicy(), pair_block=128)
    jpol = dataclasses.replace(SearchPolicy(), scorer="pallas", pallas_interpret=True, **KNOBS)
    jm = jd.find_all(jmodel, scene, sample_params=SAMPLE, discretization=DiscretizationParams(),
                     policy=jpol, **FIND)
    tm = td.find_all(tmodel, tscene, sample_params=TSAMPLE,
                     discretization=tcfg.DiscretizationParams(), policy=TPOLICY, **FIND)
    assert jm and len(tm) == len(jm)
    gt = torch.from_numpy(np.asarray(t_gt, np.float64))
    for a, b in zip(tm, jm):
        dt, dr = pose_delta(torch.from_numpy(a.transform).double(), gt)
        assert float(dt) < 6e-3 and float(np.degrees(float(dr))) < 0.6
        jt, jr = jpose_delta(jnp.asarray(b.transform), jnp.asarray(t_gt))
        assert float(jt) < 6e-3 and float(np.degrees(float(jr))) < 0.6
        dt, dr = pose_delta(torch.from_numpy(a.transform).double(),
                            torch.from_numpy(np.asarray(b.transform, np.float64)))
        assert float(dt) < 6e-3 and float(np.degrees(float(dr))) < 0.6
        assert a.scene_corrs.size and a.scene_corrs.shape == a.model_corrs.shape
    stats = td.LAST_SEARCH_STATS
    ref_keys = set(jd.LAST_SEARCH_STATS) - {"round_fn_cache_hit"}
    assert ref_keys <= set(stats)
    assert stats["fine_rescore_full"] is False and stats["rounds"] >= 1
    assert stats["coarse_kernel_launches"] == 0  # CPU tensors: the plain version ran
    assert td.instantiate(tmodel, tm[0]).shape == (int(tmodel.n_all), 3)


def test_find_all_raises_off_the_slice(fixture):
    """The orientation-weighted full ranking (B3) and the linearised coarse
    kernel (B4) now run, on the standard route and behind the fog switch
    (``fine_full_rescore_ratio=0`` forces it), and find the pose as the JAX
    package does (tests/test_score_pallas.py::test_two_phase_full_mode_survivors);
    a ``mesh=`` that is no ``torch.distributed`` DeviceMesh raises (the mesh
    routes themselves are tests/test_torch_parallel.py's)."""
    _, _, t_gt, tmodel, tscene = fixture
    with pytest.raises(TypeError, match="DeviceMesh"):
        td.find_all(tmodel, tscene, policy=TPOLICY, mesh=object(), **FIND)
    with pytest.raises(TypeError, match="DeviceMesh"):
        td.prepare_scene(tscene, TPOLICY, mesh=object())
    gt = torch.from_numpy(np.asarray(t_gt, np.float64))
    small = dataclasses.replace(TPOLICY, adaptive_second_samples=False)
    routes = [(dataclasses.replace(small, ranking_mode="full"), False),
              (dataclasses.replace(small, ranking_mode="full", fine_full_rescore_ratio=0.0), True),
              (dataclasses.replace(small, two_phase_coarse_linear=True), False)]
    for pol, fog in routes:
        tm = td.find_all(tmodel, tscene, policy=pol, sample_params=TSAMPLE, **FIND)
        assert tm, pol
        dt, dr = pose_delta(torch.from_numpy(tm[0].transform).double(), gt)
        assert float(dt) < 6e-3 and float(np.degrees(float(dr))) < 0.6
        assert td.LAST_SEARCH_STATS["fine_rescore_full"] is fog


def test_entry_points_default_to_the_card():
    """Clouds, fixtures and models land on the CUDA card unless the caller
    asks for the CPU; without a card they raise as torch does."""
    from triplet_match_tpu_torch.index.model import compiled_model_from_numpy
    from triplet_match_tpu_torch.io import synthetic as tsyn

    xyz, nrm, tan = make_box_model(n_edge=24, n_face=36, seed=0)
    makers = [lambda: PointCloud.from_arrays(xyz, nrm, tan),
              lambda: tsyn.embed_in_scene(xyz, nrm, tan, n_clutter=10)[0],
              lambda: tsyn.recall_scene(3000, seed=0)[0],
              lambda: compiled_model_from_numpy(
                  {f"cloud_{k}": v for k, v in zip(("xyz", "normal", "tangent", "valid"),
                                                   (xyz, nrm, tan, np.ones(len(xyz), bool)))}
                  | {k: np.zeros(1) for k in ("resolution", "diameter", "to_voxel", "lut", "edge",
                                              "bounds_min", "bounds_max", "keys", "pairs",
                                              "pair_count", "n_edge", "n_all")}
                  | {"margin": 5}).cloud]
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                make()
    assert PointCloud.from_arrays(xyz, device="cpu").device.type == "cpu"


def test_strict_fp32_context_restores_tf32_flags():
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with strict_fp32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.backends.cudnn.allow_tf32 is True
        with pytest.raises(RuntimeError):
            with strict_fp32():
                raise RuntimeError("the flags come back on error too")
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def test_strict_fp32_after_mixed_precision_apis():
    """A global precision set by the new API and a legacy flag set after it
    leave a state whose global getter raises; strict_fp32 still runs and
    restores the flags."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with strict_fp32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.backends.cudnn.allow_tf32 is True
        torch.backends.cuda.matmul.allow_tf32 = False
        with strict_fp32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
