"""The rest of the JAX package's utilities on the port: MurmurHash3, angle
bins, Morton codes and the octree, the timers and profiler, the debug dumps,
and the voxel-LUT hypothesis scorer.  The same numpy inputs go through both
packages (JAX on the CPU)."""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from triplet_match_tpu.config import DiscretizationParams, SampleParams, SearchPolicy
from triplet_match_tpu.core.cloud import PointCloud as JCloud
from triplet_match_tpu.features import discretize as jdisc
from triplet_match_tpu.index.model import compile_model
from triplet_match_tpu.index.serialize import _CLOUD_FIELDS, _MODEL_FIELDS
from triplet_match_tpu.io.synthetic import embed_in_scene, make_box_model
from triplet_match_tpu.ops import octree as joct
from triplet_match_tpu.search import score as jscore
from triplet_match_tpu.utils import debug as jdebug
from triplet_match_tpu.utils import timer as jtimer

from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.features import discretize as tdisc
from triplet_match_tpu_torch.index.model import compiled_model_from_numpy
from triplet_match_tpu_torch.ops import octree as toct
from triplet_match_tpu_torch.search import score as tscore
from triplet_match_tpu_torch.utils import debug as tdebug
from triplet_match_tpu_torch.utils import timer as ttimer

torch.set_num_threads(2)


@pytest.mark.parametrize("dim", [1, 2, 3, 4, 5])
def test_murmur_bit_exact(dim):
    """MurmurHash3_x86_32 (seed 42) over random uint32 words, edge words too."""
    rng = np.random.default_rng(dim)
    keys = rng.integers(0, 1 << 32, (257, dim), dtype=np.uint64).astype(np.uint32)
    keys[0] = 0
    keys[1] = 0xFFFFFFFF
    ref = np.asarray(jdisc.murmur(jnp.asarray(keys)))
    got = tdisc.murmur(torch.from_numpy(keys.astype(np.int64))).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < (1 << 32)
    np.testing.assert_array_equal(got.astype(np.uint32), ref)


def _murmur_py(words) -> int:
    """MurmurHash3_x86_32, seed 42, in plain Python integers
    (include/impl/discretize.hpp:12-45)."""
    m = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & m

    h = 42
    for w in words:
        k = rotl((int(w) * 0xCC9E2D51) & m, 15) * 0x1B873593 & m
        h = (rotl(h ^ k, 13) * 5 + 0xE6546B64) & m
    h ^= 4 * len(words)
    h = ((h ^ (h >> 16)) * 0x85EBCA6B) & m
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & m
    return h ^ (h >> 16)


def test_murmur_equals_plain_python():
    keys = [[0], [1], [0xFFFFFFFF], [3, 7, 11, 3], [0x12345678, 0x9ABCDEF0]]
    for k in keys:
        assert int(tdisc.murmur(torch.tensor(k, dtype=torch.int64))) == _murmur_py(k), k


@pytest.mark.parametrize("step_deg", [1.0, 5.0, 10.0, 12.5, 30.0, 90.0])
def test_max_angle_bins_equal(step_deg):
    params = DiscretizationParams(angle_step=np.radians(step_deg))
    assert tdisc.max_angle_bins(params) == jdisc.max_angle_bins(params)


@pytest.fixture(scope="module")
def cloud500():
    xyz = np.random.default_rng(0).uniform(0, 1, (500, 3)).astype(np.float32)
    return xyz, JCloud.from_arrays(xyz), PointCloud.from_arrays(xyz, device="cpu")


@pytest.mark.parametrize("depth", [1, 5, 8, 10])
def test_morton_codes_equal(cloud500, depth):
    xyz, _, _ = cloud500
    xyz = np.concatenate([xyz, [[0, 0, 0], [1, 1, 1], [-0.5, 2.0, 0.5]]]).astype(np.float32)
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    ref = np.asarray(joct.morton_codes(jnp.asarray(xyz), jnp.asarray(lo), jnp.asarray(hi), depth))
    got = toct.morton_codes(torch.from_numpy(xyz), torch.from_numpy(lo), torch.from_numpy(hi),
                            depth).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), ref)


OCTREE_CASES = [  # the cases of tests/test_octree_utils.py
    ("uniform", 5, "max_point_count", 16),
    ("uniform", 4, "max_point_count", 8),
    ("slab", 6, "min_voxel_size", 0.1),
    ("cube", 6, "min_voxel_size", 0.1),
    ("uniform", 6, "max_voxel_size", 0.2),
]


def _octree_cloud(kind):
    rng = np.random.default_rng(0 if kind == "uniform" else 3)
    n = 500 if kind == "uniform" else 300
    xyz = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    if kind == "slab":
        xyz[:, 2] *= 0.01
    valid = np.ones(n, bool)
    valid[::37] = False  # invalid rows stay out of the tree
    return xyz, valid


@pytest.mark.parametrize("kind,depth,criterion,value", OCTREE_CASES)
def test_octree_equal(kind, depth, criterion, value):
    """Node arrays, point order and every traversal equal the JAX octree's."""
    xyz, valid = _octree_cloud(kind)
    ref = joct.from_pointcloud(JCloud.from_arrays(xyz, valid=valid), max_depth=depth,
                               criterion=criterion, value=value)
    got = toct.from_pointcloud(PointCloud.from_arrays(xyz, valid=valid, device="cpu"),
                               max_depth=depth, criterion=criterion, value=value)
    for f in ("code", "depth", "parent", "is_leaf", "point_start", "point_count", "bbox_lo",
              "bbox_hi", "order"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.max_depth == ref.max_depth and got.node_count == ref.node_count > 0
    for view in ("depth_traversal", "breadth_traversal", "leaf_traversal", "branch_traversal"):
        assert list(getattr(got, view)()) == list(getattr(ref, view)()), view
    for lv in range(depth + 1):
        assert list(got.level_traversal(lv)) == list(ref.level_traversal(lv))
    for leaf in got.leaf_traversal():
        np.testing.assert_array_equal(got.leaf_points(leaf), ref.leaf_points(leaf))


def test_timer_and_average_behave_alike():
    for mod in (jtimer, ttimer):
        t = mod.Timer()
        assert t.milliseconds == 0.0 and t.stop() == 0.0
        t.start()
        time.sleep(0.002)
        ms = t.stop()
        assert ms >= 2.0 and t.milliseconds == ms  # stopped: no more time accrues
        t.start()
        assert t.milliseconds >= ms
        t.reset()
        assert t.milliseconds == 0.0
    xs = [1.0, 2.0, 3.0, 10.0, -4.5]
    avgs = [mod.StreamingAverage() for mod in (jtimer, ttimer)]
    for x in xs:
        assert avgs[0].update(x) == avgs[1].update(x)
    assert avgs[1].count == 5 and avgs[1].value == avgs[0].value


def test_profiler_sections():
    prof = ttimer.Profiler()
    for _ in range(3):
        with prof.section("round") as sync:
            out = sync((torch.ones(3), [torch.zeros(2)]))
    assert out[0].sum() == 3.0  # sync is the identity
    with prof.section("other"):
        pass
    assert prof.phases["round"].count == 3 and prof.phases["other"].count == 1
    rep = prof.report()
    assert rep.startswith("round: ") and "(n=3)" in rep and " | other: " in rep
    assert ttimer._cuda_devices((torch.ones(1), {"a": [torch.ones(1)]}), set()) == set()


@pytest.mark.parametrize("shape", [(3, 4), (1, 1), (7, 2)])
def test_pgm_bytes_equal(tmp_path, shape):
    m = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    jdebug.to_grayscale_image(str(tmp_path / "j.pgm"), m)
    tdebug.to_grayscale_image(str(tmp_path / "t.pgm"), torch.from_numpy(m))
    assert (tmp_path / "t.pgm").read_bytes() == (tmp_path / "j.pgm").read_bytes()


@pytest.fixture(scope="module")
def models():
    xyz, nrm, tan = make_box_model(n_edge=96, n_face=192, size=(1, 1, 1), seed=0)
    jm = compile_model(JCloud.from_arrays(xyz, nrm, tan), DiscretizationParams(),
                       SampleParams(min_diameter_factor=0.2), SearchPolicy(), pair_block=128)
    return jm, _port_model(jm), (xyz, nrm, tan)


def _port_model(jm):
    d = {f"cloud_{k}": np.asarray(getattr(jm.cloud, k)) for k in _CLOUD_FIELDS}
    d.update({k: np.asarray(getattr(jm, k)) for k in _MODEL_FIELDS})
    d["margin"] = jm.margin
    return compiled_model_from_numpy(d, device="cpu")


def test_feature_histograms_equal(models, tmp_path):
    jm, tm, _ = models
    h0, h1 = jdebug.feature_histograms(jm, str(tmp_path / "j.dat"))
    g0, g1 = tdebug.feature_histograms(tm, str(tmp_path / "t.dat"))
    np.testing.assert_array_equal(g0, h0)
    np.testing.assert_array_equal(g1, h1)
    assert g0.sum() == int(tm.pair_count) > 0
    assert (tmp_path / "t.dat").read_text() == (tmp_path / "j.dat").read_text()


@pytest.mark.parametrize("chunk", [64, 2048])
def test_score_hypotheses_equal(models, chunk):
    """The voxel-LUT scorer over random neighbourhoods and poses near and far
    from the identity: counts equal, scores within 1e-6 relative."""
    jm, tm, (xyz, nrm, tan) = models
    scene, _, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=100, seed=5)
    tscene = PointCloud.from_arrays(*(np.array(getattr(scene, f))
                                      for f in ("xyz", "normal", "tangent", "valid")), device="cpu")
    rng = np.random.default_rng(chunk)
    n, h, k = tscene.capacity, 300, 48
    tm_mask = rng.random(n) < 0.3
    consumed = rng.random(n) < 0.1
    nbr = rng.integers(0, n, (h, k))
    nvalid = rng.random((h, k)) < 0.9
    ts = np.tile(np.eye(4, dtype=np.float32), (h, 1, 1))
    ts[:, :3, 3] = rng.normal(scale=0.05, size=(h, 3)).astype(np.float32)
    ts[h // 2:, :3, 3] += rng.normal(scale=1.0, size=(h - h // 2, 3)).astype(np.float32)
    ref = jscore.get_bench_scorer(chunk=chunk)(jm, scene, jnp.asarray(tm_mask),
                                               jnp.asarray(consumed), jnp.asarray(ts),
                                               jnp.asarray(nbr, jnp.int32), jnp.asarray(nvalid),
                                               3.0)
    got = tscore.get_bench_scorer(chunk=chunk)(tm, tscene, torch.from_numpy(tm_mask),
                                               torch.from_numpy(consumed), torch.from_numpy(ts),
                                               torch.from_numpy(nbr), torch.from_numpy(nvalid),
                                               3.0)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    assert int(got.count.max()) > 5
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score), rtol=1e-6, atol=1e-6)
