"""The fog route's join: PyTorch port vs JAX package.

The Gauss-Newton pose step, the edge-anchored point-to-line tight polish, the
candidate-subset gather and scatter, and ``accept_and_polish`` with the
finalist prescreen and the subset join, on a box instance in touching fog.
Both packages get the same model arrays, scene and poses.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triplet_match_tpu.config import DiscretizationParams, SampleParams, SearchPolicy
from triplet_match_tpu.core import transforms as jtr
from triplet_match_tpu.core.cloud import PointCloud as JCloud
from triplet_match_tpu.index.model import compile_model
from triplet_match_tpu.index.serialize import _CLOUD_FIELDS, _MODEL_FIELDS
from triplet_match_tpu.io.synthetic import fog_patches, make_box_model, rotation_matrix
from triplet_match_tpu.refine import icp as jicp
from triplet_match_tpu.search import driver as jd

from triplet_match_tpu_torch import config as tcfg
from triplet_match_tpu_torch.core import transforms as ttr
from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.index.model import compiled_model_from_numpy
from triplet_match_tpu_torch.refine import icp as ticp
from triplet_match_tpu_torch.search import driver as td

torch.set_num_threads(2)

SAMPLE = SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
# the fog route's join knobs, at a capacity below the scene size
JOIN = dict(finalist_prescreen=2, join_subset_capacity=3072, rank_edges_only=True,
            tight_edges_only=True, tight_point_to_line=True)


def _orthonormal(t) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(t, np.float64)).clone()
    u, _, vt = torch.linalg.svd(t[..., :3, :3])
    t[..., :3, :3] = u @ vt
    return t


def _close(a, b, mm: float = 1e-4, deg: float = 0.01):
    dt, dr = ttr.pose_delta(_orthonormal(a), _orthonormal(b))
    assert float(dt.max()) < mm and float(np.degrees(float(dr.max()))) < deg, (dt, dr)


@pytest.fixture(scope="module")
def fog():
    """Box instance (120 edge + 360 face points) in 4000 points of touching fog."""
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    rng = np.random.default_rng(3002)
    r_inst = rotation_matrix(rng.normal(size=3), rng.uniform(0, np.pi))
    t_off = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
    c_xyz, c_nrm = fog_patches(rng, 4000, seed_base=7400, extent=2.5)
    s_xyz = np.concatenate([xyz @ r_inst.T + t_off
                            + rng.normal(0, 0.001, xyz.shape).astype(np.float32), c_xyz])
    s_nrm = np.concatenate([nrm @ r_inst.T, c_nrm])
    s_tan = np.concatenate([tan @ r_inst.T, np.zeros_like(c_xyz)])
    t_gt = np.eye(4, dtype=np.float32)
    t_gt[:3, :3], t_gt[:3, 3] = r_inst, t_off
    jm = compile_model(JCloud.from_arrays(xyz, nrm, tan), DiscretizationParams(), SAMPLE,
                       SearchPolicy(), pair_block=128)
    d = {f"cloud_{k}": np.asarray(getattr(jm.cloud, k)) for k in _CLOUD_FIELDS}
    d.update({k: np.asarray(getattr(jm, k)) for k in _MODEL_FIELDS})
    d["margin"] = jm.margin
    jprep = jd.prepare_scene(JCloud.from_arrays(s_xyz, s_nrm, s_tan), SearchPolicy())
    tprep = td.prepare_scene(PointCloud.from_arrays(s_xyz, s_nrm, s_tan, device="cpu"),
                             tcfg.SearchPolicy())
    np.testing.assert_array_equal(tprep.tangent_mask.numpy(), np.asarray(jprep.tangent_mask))
    # finalists: near-true poses and junk
    t_true = np.linalg.inv(t_gt).astype(np.float32)
    ts = np.tile(t_true, (4, 1, 1))
    ts[0, :3, :3] = rotation_matrix([0.3, 1.0, 0.2], np.radians(0.6)) @ t_true[:3, :3]
    ts[0, :3, 3] += [0.004, -0.003, 0.002]
    ts[1, :3, 3] += rng.normal(0, 0.3, 3).astype(np.float32)
    ts[2, :3, 3] += [-0.002, 0.003, 0.001]
    ts[3, :3, :3] = rotation_matrix([1.0, 0.0, 0.5], 1.0) @ t_true[:3, :3]
    return dict(jm=jm, tm=compiled_model_from_numpy(d, device="cpu"), jprep=jprep,
                tprep=tprep, ts=ts, t_true=t_true)


def test_gauss_newton_pose_step_matches_jax():
    rng = np.random.default_rng(11)
    f, n = 3, 200
    src = rng.normal(0, 0.3, (f, n, 3)).astype(np.float32)
    dst = (src + rng.normal(0, 0.002, (f, n, 3))).astype(np.float32)
    m_dir = rng.normal(size=(f, n, 3)).astype(np.float32)
    m_dir /= np.linalg.norm(m_dir, axis=-1, keepdims=True)
    kind = rng.random((f, n)) > 0.6
    w = (rng.random((f, n)) * (rng.random((f, n)) > 0.2)).astype(np.float32)
    ref = np.stack([np.asarray(jtr.gauss_newton_pose_step(
        jnp.asarray(src[i]), jnp.asarray(dst[i]), jnp.asarray(m_dir[i]), jnp.asarray(kind[i]),
        jnp.asarray(w[i]))) for i in range(f)])
    got = ttr.gauss_newton_pose_step(*(torch.from_numpy(a) for a in (src, dst, m_dir, kind, w)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    assert np.abs(ref[:, :3, 3]).max() > 1e-4  # a real update, not the identity


def test_tight_polish_edges_point_to_line_matches_jax(fog):
    jm, tm, jprep, tprep = fog["jm"], fog["tm"], fog["jprep"], fog["tprep"]
    n = tprep.cloud.capacity
    ts = fog["ts"][[0, 2]]
    kw = dict(iterations=6, orientation_weight=True, anneal=0.5, edges_only=True,
              point_to_line_at_floor=True)
    one = functools.partial(jicp.tight_polish, jm, jprep.cloud, jprep.tangent_mask,
                            jnp.zeros(n, bool), dist_thres=3.0, **kw)
    ref = np.asarray(jax.vmap(lambda t: one(t0=t))(jnp.asarray(ts)))
    got = ticp.tight_polish(tm, tprep.cloud, tprep.tangent_mask, torch.zeros(n, dtype=torch.bool),
                            torch.from_numpy(ts), 3.0, **kw)
    _close(got, ref)
    _close(got, np.tile(fog["t_true"], (2, 1, 1)), mm=1e-3, deg=0.2)  # and it converged
    # the point-to-line steps ran: a point-to-point polish lands elsewhere
    p2p = ticp.tight_polish(tm, tprep.cloud, tprep.tangent_mask,
                            torch.zeros(n, dtype=torch.bool), torch.from_numpy(ts), 3.0,
                            **dict(kw, point_to_line_at_floor=False))
    assert float(ttr.pose_delta(_orthonormal(p2p), _orthonormal(got))[0].max()) > 1e-6


@pytest.mark.parametrize("cap", [3072, 1024])
def test_candidate_subset_and_scatter_identical(fog, cap):
    jm, tm, jprep, tprep = fog["jm"], fog["tm"], fog["jprep"], fog["tprep"]
    n = tprep.cloud.capacity
    consumed = np.zeros(n, bool)
    consumed[::7] = True
    jsub = jd._candidate_subset(jm, jprep.cloud, jprep.tangent_mask, jnp.asarray(consumed),
                                jnp.asarray(fog["ts"]), 3.0, cap, 4.0)
    tsub = td._candidate_subset(tm, tprep.cloud, tprep.tangent_mask, torch.from_numpy(consumed),
                                torch.from_numpy(fog["ts"]), 3.0, cap, 4.0)
    j_idx, j_ivalid, j_cand = (np.asarray(a) for a in jsub[3:])
    np.testing.assert_array_equal(tsub[3].numpy(), j_idx)
    np.testing.assert_array_equal(tsub[4].numpy(), j_ivalid)
    np.testing.assert_array_equal(tsub[5].numpy(), j_cand)
    np.testing.assert_array_equal(tsub[2].numpy(), np.asarray(jsub[2]))
    np.testing.assert_array_equal(tsub[0].xyz.numpy(), np.asarray(jsub[0].xyz))
    overflow = j_cand.max() - cap
    assert (overflow > 0) == (cap == 1024)  # the small capacity overflows, the other is exact
    rng = np.random.default_rng(2)
    sub_valid = rng.random(j_idx.shape) > 0.5
    sub_midx = rng.integers(0, 480, j_idx.shape)
    jv, jmi = jd._scatter_corrs(jnp.asarray(j_idx), jnp.asarray(j_ivalid),
                                jnp.asarray(sub_valid), jnp.asarray(sub_midx.astype(np.int32)), n)
    tv, tmi = td._scatter_corrs(tsub[3], tsub[4], torch.from_numpy(sub_valid),
                                torch.from_numpy(sub_midx), n)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tmi.numpy(), np.asarray(jmi))


def test_accept_and_polish_prescreen_subset_matches_jax(fog):
    jm, tm, jprep, tprep = fog["jm"], fog["tm"], fog["jprep"], fog["tprep"]
    n = tprep.cloud.capacity
    jpol = dataclasses.replace(SearchPolicy(), **JOIN)
    tpol = dataclasses.replace(tcfg.SearchPolicy(), **JOIN)
    jout = jd.accept_and_polish(jm, jprep.cloud, jprep.tangent_mask, jnp.zeros(n, bool),
                                jnp.asarray(fog["ts"]), 3.0, 0.5, policy=jpol,
                                max_icp_iterations=5)
    tout = td.accept_and_polish(tm, tprep.cloud, tprep.tangent_mask,
                                torch.zeros(n, dtype=torch.bool), torch.from_numpy(fog["ts"]),
                                3.0, 0.5, policy=tpol, max_icp_iterations=5)
    t_fin, accept, new_corr, midx, counts, _, consumed, overflow = tout
    assert accept.shape == (2,)  # the prescreen kept two of four
    np.testing.assert_array_equal(accept.numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jout[4]))
    np.testing.assert_array_equal(new_corr.numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(consumed.numpy(), np.asarray(jout[6]))
    new = np.asarray(jout[2])
    np.testing.assert_array_equal(midx.numpy()[new], np.asarray(jout[3])[new])
    assert int(overflow) == int(jout[7]) == 0
    assert accept.any()
    _close(t_fin, np.asarray(jout[0]))


def test_icp_refine_point_to_plane_matches_jax(fog):
    """The relaxed loop, then Gauss-Newton tight steps on every iteration."""
    jm, tm, jprep, tprep = fog["jm"], fog["tm"], fog["jprep"], fog["tprep"]
    n = tprep.cloud.capacity
    ts = fog["ts"][[0, 2]]
    one = functools.partial(jicp.icp_refine, jm, jprep.cloud, jprep.tangent_mask,
                            jnp.zeros(n, bool), dist_thres=3.0, max_iterations=5,
                            tight_iterations=2, point_to_plane=True)
    ref = jax.vmap(lambda t: one(t0=t))(jnp.asarray(ts))
    got = ticp.icp_refine(tm, tprep.cloud, tprep.tangent_mask, torch.zeros(n, dtype=torch.bool),
                          torch.from_numpy(ts), 3.0, 5, tight_iterations=2, point_to_plane=True)
    _close(got.transform, np.asarray(ref.transform))
    np.testing.assert_array_equal(got.corrs.count.numpy(), np.asarray(ref.corrs.count))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))


def test_subset_join_matches_whole_scene_join(fog):
    """A capacity that holds every candidate gives the whole-scene join's
    decisions: the candidate subset is an exact eligibility superset."""
    tm, tprep = fog["tm"], fog["tprep"]
    n = tprep.cloud.capacity
    args = (tm, tprep.cloud, tprep.tangent_mask, torch.zeros(n, dtype=torch.bool),
            torch.from_numpy(fog["ts"]), 3.0, 0.5)
    outs = [td.accept_and_polish(*args, policy=dataclasses.replace(
        tcfg.SearchPolicy(), **dict(JOIN, join_subset_capacity=cap)), max_icp_iterations=5)
        for cap in (3072, None)]
    subset, whole = outs
    assert int(subset[7]) == 0
    for i in (1, 2, 4, 6):  # accept, new corrs, counts, consumed
        np.testing.assert_array_equal(subset[i].numpy(), whole[i].numpy())
    new = whole[2].numpy()
    np.testing.assert_array_equal(subset[3].numpy()[new], whole[3].numpy()[new])
    assert bool(whole[1].any())
    _close(subset[0], whole[0])
