"""The voxel-LUT route (``scorer="jnp"``) and self-symmetry detection: the
PyTorch port against the JAX package on the same inputs and the same random
words (JAX's ``split`` / ``fold_in`` order handed to the port as
``RoundDraws``)."""

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
from triplet_match_tpu.index.symmetry import detect_self_symmetries as jdetect
from triplet_match_tpu.index.symmetry import symmetry_equivalent as jequivalent
from triplet_match_tpu.io.synthetic import embed_in_scene, make_box_model, rotation_matrix
from triplet_match_tpu.search import driver as jd

from triplet_match_tpu_torch import config as tcfg
from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.core.transforms import pose_delta
from triplet_match_tpu_torch.index.model import compiled_model_from_numpy
from triplet_match_tpu_torch.index.symmetry import detect_self_symmetries, symmetry_equivalent
from triplet_match_tpu_torch.io.synthetic import sym_delta
from triplet_match_tpu_torch.search import driver as td
from triplet_match_tpu_torch.search.sampling import RoundDraws

torch.set_num_threads(2)

SAMPLE = SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
TSAMPLE = tcfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
DISC = DiscretizationParams()
TDISC = tcfg.DiscretizationParams()
# tests/test_symmetry.py's policy
SYM = dict(num_first_samples=48, num_second_samples=16, query_cap=16, score_neighbors=256,
           finalists=4)


def _port_model(jm):
    d = {f"cloud_{k}": np.asarray(getattr(jm.cloud, k)) for k in _CLOUD_FIELDS}
    d.update({k: np.asarray(getattr(jm, k)) for k in _MODEL_FIELDS})
    d["margin"] = jm.margin
    return compiled_model_from_numpy(d, device="cpu")


def jax_draws(key, b1: int, pool: int) -> RoundDraws:
    """The port's RoundDraws of JAX's ``hypothesize_and_score`` under ``key``."""
    k1, k2, k3, k4 = jax.random.split(key, 4)

    def words(k, salt):
        return tuple(int(v) for v in
                     np.asarray(jax.random.key_data(jax.random.fold_in(k, salt))).reshape(-1))

    gumbel = np.array(jax.random.gumbel(k2, (b1, pool)))
    return RoundDraws(words(k1, 1), words(k3, 0), words(k4, 0), torch.from_numpy(gumbel))


@pytest.fixture(scope="module")
def box():
    xyz, nrm, tan = make_box_model(n_edge=240, n_face=720, size=(1.0, 0.8, 0.6), seed=0)
    jm = compile_model(JCloud.from_arrays(xyz, nrm, tan), DISC, SAMPLE,
                       SearchPolicy(**SYM), pair_block=128)
    return jm, _port_model(jm), (xyz, nrm, tan)


def test_lut_round_matches_jax(box):
    """One ``search_round`` on the voxel-LUT route (no model pack): samples,
    scores' finalists, accept decisions and claimed points equal, poses within
    the single-round tolerance of tests/test_torch_round.py."""
    jm, tm, (xyz, nrm, tan) = box
    scene, _, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=200, seed=7)
    tscene = PointCloud.from_arrays(*(np.array(getattr(scene, f))
                                      for f in ("xyz", "normal", "tangent", "valid")), device="cpu")
    knobs = dict(num_first_samples=16, num_second_samples=8, query_cap=8, score_neighbors=128,
                 finalists=2, max_rounds=2, two_phase_scoring=False)
    jpol = dataclasses.replace(SearchPolicy(), scorer="jnp", **knobs)
    tpol = dataclasses.replace(tcfg.SearchPolicy(), scorer="jnp", **knobs)
    jprep = jd.prepare_scene(scene, jpol)
    tprep = td.prepare_scene(tscene, tpol)
    n = scene.xyz.shape[0]
    key = jax.random.fold_in(jax.random.PRNGKey(13), 0)
    round_fn = jax.jit(functools.partial(jd.search_round, discretization=DISC,
                                         sample_params=SAMPLE, policy=jpol,
                                         max_icp_iterations=5))
    jres, jcons, jfp = round_fn(jm, jprep, np.zeros(n, bool), np.zeros(n, bool), key,
                                jnp.float32(3.0), jnp.float32(0.5), None)
    zeros = torch.zeros(n, dtype=torch.bool)
    tres, tcons, tfp = td.search_round(
        tm, tprep, zeros, zeros.clone(), jax_draws(key, 16, tpol.second_pool), 3.0, 0.5, None,
        discretization=TDISC, sample_params=TSAMPLE, policy=tpol, max_icp_iterations=5)

    np.testing.assert_array_equal(tfp.numpy(), np.asarray(jfp))  # the same firsts
    np.testing.assert_array_equal(tres.accept.numpy(), np.asarray(jres.accept))
    np.testing.assert_array_equal(tres.count.numpy(), np.asarray(jres.count))
    np.testing.assert_array_equal(tres.new_corr.numpy(), np.asarray(jres.new_corr))
    np.testing.assert_array_equal(tcons.numpy(), np.asarray(jcons))
    assert int(tres.hypotheses_scored) == int(jres.hypotheses_scored)
    assert tres.accept.any()
    dt, dr = pose_delta(_orthonormal(np.asarray(jres.transform)), _orthonormal(tres.transform))
    assert float(dt.max()) < 1e-4
    assert float(np.degrees(float(dr.max()))) < 0.01


def test_lut_find_all_launches_no_kernel(box):
    """``find_all`` with ``scorer="jnp"``: no model pack, no kernel launch, no
    fog switch (its gate needs the kernels), and the planted pose found."""
    _, tm, (xyz, nrm, tan) = box
    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=300, seed=3)
    tscene = PointCloud.from_arrays(*(np.array(getattr(scene, f))
                                      for f in ("xyz", "normal", "tangent", "valid")), device="cpu")
    pol = dataclasses.replace(tcfg.SearchPolicy(), scorer="jnp", num_first_samples=16,
                              num_second_samples=8, query_cap=8, score_neighbors=128,
                              finalists=2, max_rounds=2, fine_full_rescore_ratio=0.0,
                              adaptive_second_samples=False)
    matches = td.find_all(tm, tscene, policy=pol, sample_params=TSAMPLE, discretization=TDISC,
                          model_match_factor=0.5, max_icp_iterations=5, seed=1)
    st = td.LAST_SEARCH_STATS
    assert matches and st["fine_rescore_full"] is False
    assert all(st[k] == 0 for k in ("coarse_kernel_launches", "exact_kernel_launches",
                                    "full_kernel_launches", "coarse_linear_kernel_launches"))
    assert st["round_ms_avg"] > 0 and st["profile"].startswith("ball_quantile: ")
    dt, dr = sym_delta(matches[0].transform, t_gt)
    assert dt < 6e-3 and dr < 0.6


@pytest.fixture(scope="module")
def orbits(box):
    jm, tm, _ = box
    jpol = SearchPolicy(**SYM)
    ref = jdetect(jm, DISC, SAMPLE, jpol, seed=0, rounds=3)
    base = jax.random.PRNGKey(0)
    draws = [jax_draws(jax.random.fold_in(base, r), SYM["num_first_samples"], jpol.second_pool)
             for r in range(3)]
    got = detect_self_symmetries(tm, TDISC, TSAMPLE, tcfg.SearchPolicy(**SYM), rounds=3,
                                 round_draws=draws)
    return ref, got


def test_detect_self_symmetries_matches_jax(orbits):
    """tests/test_symmetry.py's box: the same orbit, element by element within
    1e-3, the identity first, each other element a pi rotation about an axis."""
    ref, got = orbits
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert 2 <= got.shape[0] <= 4
    np.testing.assert_allclose(got, ref, atol=1e-3)
    np.testing.assert_allclose(got[0], np.eye(4), atol=1e-6)
    want = [rotation_matrix(ax, np.pi) for ax in ([1, 0, 0], [0, 1, 0], [0, 0, 1])]
    for s in got[1:]:
        assert any(np.abs(s[:3, :3] - w).max() < 0.1 for w in want), s
        assert np.linalg.norm(s[:3, 3]) < 0.05


def test_symmetry_equivalent_agrees(orbits):
    """The test's three poses: identity, identity @ S, and a 90 degree turn."""
    ref, got = orbits
    t1 = np.eye(4, dtype=np.float32)
    t2 = (t1 @ got[1]).astype(np.float32)
    t3 = np.eye(4, dtype=np.float32)
    t3[:3, :3] = rotation_matrix([0, 0, 1], np.pi / 2)
    for t in (t1, t2, t3):
        assert symmetry_equivalent(t1, t, got) == jequivalent(t1, t, ref)
    assert symmetry_equivalent(t1, t2, got) and not symmetry_equivalent(t1, t3, got)


def _orthonormal(t) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(t, np.float64)).clone()
    u, _, vt = torch.linalg.svd(t[..., :3, :3])
    t[..., :3, :3] = u @ vt
    return t
