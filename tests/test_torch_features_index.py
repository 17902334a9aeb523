"""Pair features, key packing and model compilation: PyTorch port vs JAX package.

Both packages see the same numpy inputs (the box fixture of
tests/test_score_pallas.py); integer outputs must match exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from triplet_match_tpu.config import DiscretizationParams, SampleParams, SearchPolicy
from triplet_match_tpu.core.cloud import PointCloud as JCloud
from triplet_match_tpu.features import discretize as jdz
from triplet_match_tpu.features import pairfeat as jpf
from triplet_match_tpu.index import model as jmodel
from triplet_match_tpu.index.serialize import _CLOUD_FIELDS, _MODEL_FIELDS, save_model
from triplet_match_tpu.io.synthetic import make_box_model

from triplet_match_tpu_torch import config as tcfg
from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.features import discretize as tdz
from triplet_match_tpu_torch.features import pairfeat as tpf
from triplet_match_tpu_torch.index import model as tmodel

torch.set_num_threads(2)

DISC = DiscretizationParams()
SAMPLE = SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
TDISC = tcfg.DiscretizationParams()
TSAMPLE = tcfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)


def model_arrays(m):
    d = {f"cloud_{k}": np.asarray(getattr(m.cloud, k)) for k in _CLOUD_FIELDS}
    d.update({k: np.asarray(getattr(m, k)) for k in _MODEL_FIELDS})
    d["margin"] = m.margin
    return d


def port_arrays(m):
    d = {f"cloud_{k}": getattr(m.cloud, k).cpu().numpy() for k in _CLOUD_FIELDS}
    d.update({k: getattr(m, k).cpu().numpy() for k in _MODEL_FIELDS})
    d["margin"] = m.margin
    return d


@pytest.fixture(scope="module")
def models():
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    jm = jmodel.compile_model(JCloud.from_arrays(xyz, nrm, tan), DISC, SAMPLE, SearchPolicy(),
                              pair_block=128)
    tm = tmodel.compile_model(PointCloud.from_arrays(xyz, nrm, tan, device="cpu"), TDISC, TSAMPLE,
                              tcfg.SearchPolicy(), pair_block=128)
    return jm, tm


def test_pair_feature_and_keys_exact(models):
    jm, _ = models
    rng = np.random.default_rng(11)
    n = 4096
    p0, p1 = (rng.normal(0, 0.4, (n, 3)).astype(np.float32) for _ in range(2))
    t0, t1 = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(2))
    t0 /= np.linalg.norm(t0, axis=1, keepdims=True)
    t1[: n // 2] = 0.0  # surface-point tangents
    bmin, bmax = np.array(jm.bounds_min), np.array(jm.bounds_max)

    fj = jpf.pair_feature(*(jnp.asarray(a) for a in (p0, p1, t0, t1)))
    kj = np.asarray(jdz.pack_key(jdz.discretize_feature(fj, jnp.asarray(bmin), jnp.asarray(bmax), DISC)))
    gj = np.asarray(jpf.pair_gates(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(t0), 0.3, 1.2))
    vj = np.asarray(jpf.feature_valid(fj, jnp.asarray(bmin), jnp.asarray(bmax)))

    tt = [torch.from_numpy(a) for a in (p0, p1, t0, t1)]
    ft = tpf.pair_feature(*tt)
    kt = tdz.pack_key(tdz.discretize_feature(ft, torch.from_numpy(bmin), torch.from_numpy(bmax), TDISC))
    gt = tpf.pair_gates(tt[0], tt[1], tt[2], 0.3, 1.2)
    vt = tpf.feature_valid(ft, torch.from_numpy(bmin), torch.from_numpy(bmax))

    np.testing.assert_array_equal(kt.numpy(), kj.astype(np.int64))
    np.testing.assert_array_equal(gt.numpy(), gj)
    np.testing.assert_array_equal(vt.numpy(), vj)
    # the f3 == f0 quirk (impl/feature.hpp:31)
    assert torch.equal(ft[:, 3], ft[:, 0])
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6, atol=1e-6)


def test_compile_model_parity(models):
    jm, tm = models
    for name in ("keys", "pairs", "pair_count", "edge", "n_edge", "n_all"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)).astype(getattr(tm, name).numpy().dtype),
                                      err_msg=name)
    assert int(tm.pair_count) > 0 and int(tm.n_edge) > 0
    for name in ("bounds_min", "bounds_max", "resolution", "diameter", "to_voxel"):
        np.testing.assert_allclose(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
                                   rtol=1e-6, atol=0, err_msg=name)
    assert tm.lut.shape == jm.lut.shape

    # LUT: exact, except voxels whose two candidates are equidistant (1e-6 rel.)
    lut_j, lut_t = np.asarray(jm.lut), tm.lut.numpy()
    diff = np.argwhere(lut_j != lut_t)
    if diff.size:
        inv = np.linalg.inv(np.asarray(jm.to_voxel, np.float64))
        c = diff.astype(np.float64) @ inv[:3, :3].T + inv[:3, 3]
        xyz = np.asarray(jm.cloud.xyz, np.float64)
        dj = np.linalg.norm(c - xyz[lut_j[tuple(diff.T)]], axis=1)
        dt = np.linalg.norm(c - xyz[lut_t[tuple(diff.T)]], axis=1)
        assert (np.abs(dj - dt) <= 1e-6 * np.maximum(dj, dt)).all()


def test_query_pairs_and_voxel_queries_exact(models):
    jm, tm = models
    rng = np.random.default_rng(5)
    xyz, tan = np.asarray(jm.cloud.xyz), np.asarray(jm.cloud.tangent)
    e = np.where(np.asarray(jm.edge))[0]
    i, j = rng.choice(e, 600), rng.choice(e, 600)
    p0 = xyz[i] + rng.normal(0, 0.002, (600, 3)).astype(np.float32)
    feats = np.array(jpf.pair_feature(jnp.asarray(p0), jnp.asarray(xyz[j]),
                                        jnp.asarray(tan[i]), jnp.asarray(tan[j])))
    pj, vj = jmodel.query_pairs(jm, jnp.asarray(feats), DISC, 16, limit=200)
    pt, vt = tmodel.query_pairs(tm, torch.from_numpy(feats), TDISC, 16, limit=200)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert vt.any()

    pos = rng.uniform(-0.6, 0.6, (2000, 3)).astype(np.float32)
    for jf, tf in ((jmodel.voxel_query, tmodel.voxel_query),
                   (jmodel.voxel_query_exact, tmodel.voxel_query_exact)):
        ij, bj = jf(jm, jnp.asarray(pos))
        it, bt = tf(tm, torch.from_numpy(pos))
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
        np.testing.assert_array_equal(it.numpy()[bt.numpy()], np.asarray(ij)[np.asarray(bj)])


def test_compiled_model_from_numpy_roundtrip(models, tmp_path):
    jm, _ = models
    path = str(tmp_path / "model.npz")
    save_model(path, jm, DISC)
    with np.load(path) as z:
        tm = tmodel.compiled_model_from_numpy(dict(z), device="cpu")
    ref, got = model_arrays(jm), port_arrays(tm)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]).astype(np.asarray(got[k]).dtype),
                                      err_msg=k)
    assert tm.extents == tuple(jm.lut.shape)
