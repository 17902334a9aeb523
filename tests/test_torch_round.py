"""One search round and the scene preparation: PyTorch port vs JAX package.

The round's random inputs are JAX's own — the same ``split``/``fold_in``
order as ``triplet_match_tpu.search.driver.hypothesize_and_score`` — handed to
the port as a ``RoundDraws``.  The JAX side ranks through the Pallas kernels
in interpret mode (``scorer="pallas"``).
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
    return jm, compiled_model_from_numpy(d, device="cpu"), scene, tscene


@pytest.mark.parametrize("grid_threshold", [32768, 100])
def test_prepare_scene_identical(fixture, grid_threshold):
    """Whole-cloud and grid-bucketed edge classification give JAX's mask."""
    _, _, scene, tscene = fixture
    jp = jd.prepare_scene(scene, SearchPolicy(), grid_threshold=grid_threshold)
    tp = td.prepare_scene(tscene, tcfg.SearchPolicy(), grid_threshold=grid_threshold)
    np.testing.assert_array_equal(tp.tangent_mask.numpy(), np.asarray(jp.tangent_mask))
    assert int(tp.n_edge) == int(jp.n_edge) > 0
    np.testing.assert_array_equal(tp.cloud.xyz.numpy(), np.asarray(jp.cloud.xyz))


def test_search_round_matches_jax(fixture):
    jm, tm, scene, tscene = fixture
    jprep = jd.prepare_scene(scene, SearchPolicy())
    tprep = td.prepare_scene(tscene, tcfg.SearchPolicy())
    jpol = dataclasses.replace(SearchPolicy(), scorer="pallas", pallas_interpret=True, **KNOBS)
    tpol = dataclasses.replace(tcfg.SearchPolicy(), **KNOBS)
    n = scene.xyz.shape[0]

    key = jax.random.fold_in(jax.random.PRNGKey(13), 0)
    k1, k2, k3, k4 = jax.random.split(key, 4)

    def words(k, salt):
        return tuple(int(v) for v in
                     np.asarray(jax.random.key_data(jax.random.fold_in(k, salt))).reshape(-1))

    gumbel = np.asarray(jax.random.gumbel(k2, (tpol.num_first_samples, tpol.second_pool)))
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
    new = np.asarray(jres.new_corr)
    np.testing.assert_array_equal(tres.model_idx.numpy()[new], np.asarray(jres.model_idx)[new])
    assert tres.accept.any() and new.any()
    # pose_delta in float64 of the rotations projected onto SO(3): arccos of
    # the trace cannot resolve the ~1e-7 non-orthogonality of a float32
    # rotation (~0.03 deg), far above the 0.01 deg bound
    dt, dr = pose_delta(_orthonormal(np.asarray(jres.transform)), _orthonormal(tres.transform))
    assert float(dt.max()) < 1e-4
    assert float(np.degrees(float(dr.max()))) < 0.01


def _orthonormal(t) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(t, np.float64)).clone()
    u, _, vt = torch.linalg.svd(t[..., :3, :3])
    t[..., :3, :3] = u @ vt
    return t
