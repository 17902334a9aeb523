"""What keeps the port's memory bounded at large scenes: PyTorch port vs JAX
package, and chunked vs unchunked.

``ops/knn.radius_sample`` scans the scene in column chunks with an exact
top-k merge: it must equal the JAX ``radius_sample`` bit for bit at every
chunk width, with heavily tied priorities.  ``search/driver._finalist_map``
runs the join's scene-sized passes in chunks of finalists: a pure
regrouping, so a search with a budget of one row gives the default search's
matches and correspondences.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from triplet_match_tpu.io.synthetic import embed_in_scene, make_box_model
from triplet_match_tpu.ops import knn as jknn

from triplet_match_tpu_torch import config as tcfg
from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.index.model import compile_model
from triplet_match_tpu_torch.ops import knn as tknn
from triplet_match_tpu_torch.refine.icp import IcpResult
from triplet_match_tpu_torch.search import driver as td
from triplet_match_tpu_torch.search.score import DenseCorrs

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def points():
    """240 points in a unit cube, 10 % invalid, priorities on 4 levels."""
    rng = np.random.default_rng(11)
    xyz = rng.uniform(-1.0, 1.0, (240, 3)).astype(np.float32)
    valid = rng.random(240) > 0.1
    prio = (rng.integers(0, 4, 240) / 4.0).astype(np.float32)
    return xyz, valid, prio, xyz[rng.choice(240, 24)]


@pytest.mark.parametrize("k", [8, 160])  # below and above the ball's population
@pytest.mark.parametrize("cols", [1, 80, None, 240])  # 1 column, 3 chunks, the default, 1 chunk
def test_chunked_radius_sample_equals_jax(points, k, cols, monkeypatch):
    xyz, valid, prio, q = points
    if cols is not None:  # a budget of exactly ``cols`` columns for the 8-query blocks
        monkeypatch.setattr(tknn, "_RADIUS_CHUNK_BYTES", 13 * 8 * cols)
        assert tknn.radius_chunk_cols(240, 8) == cols
    ij, mj = jknn.radius_sample(None, jnp.asarray(q), jnp.asarray(xyz), jnp.asarray(valid), 0.8,
                                k, block=8, prio=jnp.asarray(prio))
    it, mt = tknn.radius_sample(torch.from_numpy(q), torch.from_numpy(xyz),
                                torch.from_numpy(valid), 0.8, k, torch.from_numpy(prio), block=8)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    full = mt.all(1).numpy()
    assert full.any() if k == 8 else not full.any()


def test_radius_chunk_cols_keeps_the_budget():
    budget = tknn._RADIUS_CHUNK_BYTES
    for n in (1000, 131072, 500000, 8388608):
        cols = tknn.radius_chunk_cols(n, 256)
        chunks = -(-n // cols)
        assert 13 * 256 * cols <= budget or chunks == 1
        assert chunks == -(-n // (budget // (13 * 256)))  # as few chunks as the budget allows
    assert tknn.radius_chunk_cols(131072, 256) == 131072  # the 131k scene: one chunk


def test_finalist_map_chunks_with_remainder(monkeypatch):
    """F = 5 finalists in chunks of 2 (2 + 2 + 1), per-finalist inputs and a
    nested tuple result: equal to one batched call."""
    rows = 10
    monkeypatch.setattr(td, "_FINALIST_ROW_BUDGET", 2 * rows)
    gen = torch.Generator().manual_seed(0)
    ts = torch.randn((5, 4, 4), generator=gen)
    cloud = PointCloud(*(torch.randn((5, rows, 3), generator=gen) for _ in range(3)),
                       torch.rand((5, rows), generator=gen) > 0.3)
    mask = torch.rand((5, rows), generator=gen) > 0.5
    calls = []

    def fn(t, c, m):
        calls.append(t.shape[0])
        pos = c.xyz @ t[:, :3, :3].transpose(-1, -2) + t[:, None, :3, 3]
        hit = c.valid & m
        return IcpResult(t * 2.0, DenseCorrs(torch.argsort(pos[..., 0], dim=-1), hit,
                                             (pos * hit[..., None]).sum((1, 2)), hit.sum(-1)),
                         hit.any(-1))

    got = td._finalist_map(fn, ts, rows, cloud, mask)
    assert calls == [2, 2, 1]
    calls.clear()
    monkeypatch.setattr(td, "_FINALIST_ROW_BUDGET", 5 * rows)
    ref = td._finalist_map(fn, ts, rows, cloud, mask)
    assert calls == [5]
    assert isinstance(got, IcpResult) and isinstance(got.corrs, DenseCorrs)
    for a, b in zip((got.transform, *got.corrs, got.iterations),
                    (ref.transform, *ref.corrs, ref.iterations)):
        assert torch.equal(a, b)


def test_find_all_with_a_one_row_budget_matches_default(monkeypatch):
    """The fog route (forced) on a small scene, with the candidate-subset
    join: every scene-sized pass one finalist at a time gives the default
    search's matches and correspondences."""
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    scene, _, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=200, seed=7)
    tscene = PointCloud.from_arrays(*(np.array(getattr(scene, f))
                                      for f in ("xyz", "normal", "tangent", "valid")),
                                    device="cpu")
    sample = tcfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
    policy = dataclasses.replace(tcfg.SearchPolicy(), num_first_samples=16, num_second_samples=8,
                                 query_cap=8, score_neighbors=256, finalists=2, max_rounds=2,
                                 fine_full_rescore_ratio=0.0, join_subset_capacity=640)
    model = compile_model(PointCloud.from_arrays(xyz, nrm, tan, device="cpu"),
                          tcfg.DiscretizationParams(), sample, policy, pair_block=128)
    kw = dict(dist_thres=3.0, model_match_factor=0.5, max_icp_iterations=5, seed=13,
              sample_params=sample, policy=policy)
    ref = td.find_all(model, tscene, **kw)
    assert td.LAST_SEARCH_STATS["fine_rescore_full"] is True
    monkeypatch.setattr(td, "_FINALIST_ROW_BUDGET", 1)
    got = td.find_all(model, tscene, **kw)
    assert ref and len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.scene_corrs, b.scene_corrs)
        np.testing.assert_array_equal(a.model_corrs, b.model_corrs)
        np.testing.assert_allclose(a.transform, b.transform, rtol=0, atol=1e-5)
