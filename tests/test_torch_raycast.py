"""Visibility raycast: PyTorch port vs JAX package (``verify/raycast.py``).

Both packages get the same numpy inputs on the CPU.  The JAX package's unit
fixtures give the same masks; the pruned cast equals the brute one; on a
seeded 2400-point box model in 20k points of fog patches, seen from three
origins, the per-origin masks equal the JAX ones, and a differing ray
(none so far) must have an occluder within EPS of a gate in float64 (at most
MAX_EDGE_RAYS of them); the cast scores equal the JAX ones for identical
masks and correspondences.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from triplet_match_tpu.io.synthetic import fog_patches as jfog_patches
from triplet_match_tpu.io.synthetic import make_box_model, rotation_matrix
from triplet_match_tpu.verify import raycast as jrc

from triplet_match_tpu_torch.verify import raycast as trc

torch.set_num_threads(2)

# a ray may differ between the packages only where an occluder sits within
# EPS of a gate in float64: lambda against 0 and against t - tolerance, the
# squared perpendicular distance against r^2
EPS_LAM, EPS_D2 = 1e-5, 1e-7
MAX_EDGE_RAYS = 2


def _wall(x, half, n):
    yy, zz = np.meshgrid(np.linspace(-half, half, n), np.linspace(-half, half, n))
    return np.stack([np.full(yy.size, x), yy.ravel(), zz.ravel()], 1).astype(np.float32)


def _shifted(dx):
    t = np.eye(4, dtype=np.float32)
    t[0, 3] = dx
    return t


# tests/test_raycast.py's fixtures: (model, transform, scene, scene valid,
# radius, tolerance, origins, expected visibility)
FIXTURES = {
    "wall": (np.array([[2.0, 0, 0], [4.0, 0, 0]], np.float32), np.eye(4, dtype=np.float32),
             _wall(3.0, 1.0, 21), None, 0.08, 0.01, [[0.0, 0, 0]], [True, False]),
    "self_occlusion": (np.array([[2.0, 0, 0], [5.0, 0, 0]], np.float32),
                       np.eye(4, dtype=np.float32), np.zeros((4, 3), np.float32),
                       np.zeros(4, bool), 0.1, 0.01, [[0.0, 0, 0]], [True, False]),
    "depth_tolerance": (np.array([[2.0, 0, 0]], np.float32), np.eye(4, dtype=np.float32),
                        np.array([[2.0, 0, 0]], np.float32), None, 0.1, 0.05, [[0.0, 0, 0]],
                        [True]),
    "transform": (np.array([[-4.0, 0, 0]], np.float32), _shifted(8.0), _wall(3.0, 0.5, 15),
                  None, 0.08, 0.01, [[0.0, 0, 0]], [False]),
    "multi_origin": (np.array([[4.0, 0, 0]], np.float32), np.eye(4, dtype=np.float32),
                     _wall(3.0, 0.4, 15), None, 0.08, 0.01, [[0.0, 0, 0], [0.0, 5.0, 0]],
                     [True]),
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_unit_fixtures_match_jax(name):
    model, t, scene, svalid, r, tol, origins, expected = FIXTURES[name]
    svalid = np.ones(scene.shape[0], bool) if svalid is None else svalid
    mvalid = np.ones(model.shape[0], bool)
    ref = np.asarray(jrc.cast_visibility_multi(
        np.asarray(origins, np.float32), jnp.asarray(model), jnp.asarray(mvalid),
        jnp.asarray(t), jnp.asarray(scene), jnp.asarray(svalid), r, tol))
    for prune in (True, False):
        got = trc.cast_visibility_multi(origins, torch.from_numpy(model),
                                        torch.from_numpy(mvalid), torch.from_numpy(t),
                                        torch.from_numpy(scene), torch.from_numpy(svalid), r, tol,
                                        prune=prune)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(got.numpy(), expected)
    with pytest.raises(ValueError):
        trc.cast_visibility_multi(np.zeros((0, 3), np.float32), torch.from_numpy(model),
                                  torch.from_numpy(mvalid), torch.from_numpy(t),
                                  torch.from_numpy(scene), torch.from_numpy(svalid), r, tol)


def test_pruned_cast_identical_to_brute_and_jax():
    """tests/test_raycast.py's cull geometry: the cone-and-range cull is a
    necessary condition, so the pruned mask is the brute one; both equal
    the JAX mask, and the cull keeps under a quarter of the scene."""
    rng = np.random.default_rng(4)
    model = (rng.normal(0, 0.3, (200, 3)) + np.array([5.0, 0, 0])).astype(np.float32)
    scene = rng.uniform(-8, 8, (20000, 3)).astype(np.float32)
    mvalid = rng.random(200) > 0.05
    svalid = rng.random(20000) > 0.05
    origin = np.array([0.0, 0.2, -0.1], np.float32)
    t = np.eye(4, dtype=np.float32)
    args = (torch.from_numpy(model), torch.from_numpy(mvalid), torch.from_numpy(t),
            torch.from_numpy(scene), torch.from_numpy(svalid), 0.05, 0.02)
    stats = {}
    pruned = trc.cast_visibility(origin, *args, prune=True, stats=stats)
    brute = trc.cast_visibility(origin, *args, prune=False)
    np.testing.assert_array_equal(pruned.numpy(), brute.numpy())
    ref = np.asarray(jrc.cast_visibility(origin, jnp.asarray(model), jnp.asarray(mvalid),
                                         jnp.asarray(t), jnp.asarray(scene), jnp.asarray(svalid),
                                         point_radius=0.05, depth_tolerance=0.02))
    np.testing.assert_array_equal(pruned.numpy(), ref)
    assert 0 < stats["survivors"][0] < 0.25 * svalid.sum()
    assert (~brute.numpy()).sum() > 0  # some rays are blocked


def _edge_rays(origin, model, t, occ, occ_valid, r, tol):
    """Rays whose blocked / visible verdict an EPS perturbation of the gates
    can flip, in float64."""
    m = model.astype(np.float64) @ t[:3, :3].T.astype(np.float64) + t[:3, 3]
    delta = m - origin
    tl = np.linalg.norm(delta, axis=-1)
    dirs = delta / tl[:, None]
    occ = np.concatenate([m, occ.astype(np.float64)])
    ok = np.concatenate([np.ones(m.shape[0], bool), occ_valid])[None]
    rel = occ - origin
    lam = dirs @ rel.T
    d2 = (np.cross(dirs[:, None, :], rel[None]) ** 2).sum(-1)
    far = tl[:, None] - tol
    loose = ok & (lam > -EPS_LAM) & (d2 <= r * r + EPS_D2) & (lam < far + EPS_LAM)
    tight = ok & (lam > EPS_LAM) & (d2 <= r * r - EPS_D2) & (lam < far - EPS_LAM)
    return loose.any(1) & ~tight.any(1)


def test_seeded_box_in_fog_matches_jax():
    xyz, _, _ = make_box_model(n_edge=600, n_face=1800, size=(1.0, 0.8, 0.6), seed=0)
    rng = np.random.default_rng(17)
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = rotation_matrix(rng.normal(size=3), rng.uniform(0, np.pi))
    t[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    scene, _ = jfog_patches(rng, 20000, seed_base=100, extent=3.0)
    valid = np.ones(xyz.shape[0], bool)
    valid[::97] = False
    svalid = np.ones(scene.shape[0], bool)
    r, tol = 0.012, 0.024
    origins = np.array([[1.8, 0, 0.6], [-1.8, 0, 0.6], [0, 1.8, 0.6]], np.float32)
    blocked = edge = 0
    for o in origins:
        ref = np.asarray(jrc.cast_visibility(o, jnp.asarray(xyz), jnp.asarray(valid),
                                             jnp.asarray(t), jnp.asarray(scene),
                                             jnp.asarray(svalid), r, tol))
        got = trc.cast_visibility(o, torch.from_numpy(xyz), torch.from_numpy(valid),
                                  torch.from_numpy(t), torch.from_numpy(scene),
                                  torch.from_numpy(svalid), r, tol).numpy()
        differ = got != ref
        if differ.any():
            ambiguous = _edge_rays(o.astype(np.float64), xyz, t, scene, svalid, r, tol)
            assert (ambiguous | ~differ).all(), np.flatnonzero(differ & ~ambiguous)
            edge += int(differ.sum())
        blocked += int((valid & ~ref).sum())
    assert edge <= MAX_EDGE_RAYS
    assert blocked > 100  # self-occlusion and fog both block rays here


def test_cast_scores_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(5):
        vis = rng.random(300) > 0.3
        corrs = rng.integers(0, 300, 180).astype(np.int32)
        for count in (0, 37, 500):
            assert float(trc.cast_score(torch.from_numpy(vis), count)) == float(
                jrc.cast_score(jnp.asarray(vis), count))
        assert float(trc.cast_score_matched(torch.from_numpy(vis), corrs)) == float(
            jrc.cast_score_matched(jnp.asarray(vis), jnp.asarray(corrs)))
    vis = np.array([True, True, False, True])
    assert float(trc.cast_score_matched(torch.from_numpy(vis), [0, 0, 2, 3])) == pytest.approx(
        2.0 / 3.0)
    assert float(trc.cast_score_matched(torch.from_numpy(vis), [0, 1, 3])) == 1.0
    assert float(trc.cast_score_matched(torch.zeros(4, dtype=torch.bool), [0, 1])) == 0.0
    assert float(trc.cast_score(torch.zeros(4, dtype=torch.bool), 2)) == 0.0
