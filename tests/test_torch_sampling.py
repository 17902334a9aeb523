"""RANSAC sampling: PyTorch port vs JAX package, given the same random draws.

The JAX streams are threefry; the port takes the two key words of each
``hash_uniform`` call and the Gumbel noise as inputs, and the tests feed it
JAX's own (``jax.random.key_data(fold_in(key, salt))``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triplet_match_tpu.io.synthetic import embed_in_scene, make_box_model
from triplet_match_tpu.ops import knn as jknn
from triplet_match_tpu.search import sampling as js

from triplet_match_tpu_torch.ops import knn as tknn
from triplet_match_tpu_torch.search import sampling as ts

torch.set_num_threads(2)


def words(key, salt):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(jax.random.fold_in(key, salt))).reshape(-1))


@pytest.fixture(scope="module")
def scene():
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    cloud, _, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=200, seed=7)
    return np.asarray(cloud.xyz), np.asarray(cloud.tangent)


@pytest.mark.parametrize("seed,salt", [(0, 0), (13, 1), (2**31 - 1, 7)])
def test_hash_uniform_bit_exact(seed, salt):
    key = jax.random.PRNGKey(seed)
    idx = np.concatenate([np.arange(5000), np.array([2**31 - 1, 2**20 + 3, 123456789])]).astype(np.int32)
    ref = np.asarray(js.hash_uniform(key, jnp.asarray(idx), salt=salt))
    got = ts.hash_uniform(words(key, salt), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_sample_firsts_and_seconds_identical(scene):
    xyz, tan = scene
    n = xyz.shape[0]
    rng = np.random.default_rng(4)
    edge = np.linalg.norm(tan, axis=1) > 0.7
    eligible = edge & (rng.random(n) > 0.2)
    key = jax.random.PRNGKey(21)
    k1, k2, k4 = jax.random.split(key, 3)
    b1, b2, pool = 16, 8, 64

    fj = js.sample_firsts(k1, jnp.asarray(eligible), b1)
    ft = ts.sample_firsts(words(k1, 1), torch.from_numpy(eligible), b1)
    np.testing.assert_array_equal(ft.idx.numpy(), np.asarray(fj.idx))
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))

    # a scene with fewer eligible points than B1 pads with invalid slots
    few = np.zeros(n, bool)
    few[np.where(eligible)[0][:5]] = True
    fj5 = js.sample_firsts(k1, jnp.asarray(few), b1)
    ft5 = ts.sample_firsts(words(k1, 1), torch.from_numpy(few), b1)
    np.testing.assert_array_equal(ft5.idx.numpy(), np.asarray(fj5.idx))
    np.testing.assert_array_equal(ft5.valid.numpy(), np.asarray(fj5.valid))

    gidx = np.arange(n, dtype=np.int32)
    pj, mj = jknn.radius_sample(k4, jnp.asarray(xyz[np.asarray(fj.idx)]), jnp.asarray(xyz),
                                jnp.asarray(eligible), 1.0, pool, block=16,
                                prio=js.hash_uniform(k4, jnp.asarray(gidx)))
    pt, mt = tknn.radius_sample(torch.from_numpy(xyz[ft.idx.numpy()]), torch.from_numpy(xyz),
                                torch.from_numpy(eligible), 1.0, pool,
                                ts.hash_uniform(words(k4, 0), torch.from_numpy(gidx)), block=16)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert mt.any() and not mt.all()

    gumbel = np.asarray(jax.random.gumbel(k2, (b1, pool)))
    sj = js.sample_seconds(k2, fj, pj, mj, jnp.asarray(eligible), b2)
    st = ts.sample_seconds(torch.from_numpy(gumbel), ft, pt, mt, torch.from_numpy(eligible), b2)
    np.testing.assert_array_equal(st.idx.numpy(), np.asarray(sj.idx))
    np.testing.assert_array_equal(st.valid.numpy(), np.asarray(sj.valid))
    assert st.valid.any()


@pytest.mark.parametrize("k", [32, 512])
def test_radius_sample_identical(scene, k):
    """Dense balls (k < ball) sample by priority; sparse ones return the whole ball."""
    xyz, _ = scene
    n = xyz.shape[0]
    rng = np.random.default_rng(k)
    valid = rng.random(n) > 0.05
    q = xyz[rng.choice(n, 40)]
    key = jax.random.PRNGKey(k)
    gidx = np.arange(n, dtype=np.int32)
    ij, mj = jknn.radius_sample(key, jnp.asarray(q), jnp.asarray(xyz), jnp.asarray(valid), 0.7, k,
                                block=8, prio=js.hash_uniform(key, jnp.asarray(gidx)))
    it, mt = tknn.radius_sample(torch.from_numpy(q), torch.from_numpy(xyz), torch.from_numpy(valid),
                                0.7, k, ts.hash_uniform(words(key, 0), torch.from_numpy(gidx)), block=8)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_draw_round_is_seeded():
    a = ts.draw_round(torch.Generator().manual_seed(3), 16, 64, "cpu")
    b = ts.draw_round(torch.Generator().manual_seed(3), 16, 64, "cpu")
    assert a.first_words == b.first_words and a.pool_words == b.pool_words
    assert torch.equal(a.gumbel, b.gumbel) and a.gumbel.shape == (16, 64)
    assert torch.isfinite(a.gumbel).all()
    assert all(0 <= w < 2**32 for w in a.first_words + a.nbr_words + a.pool_words)
