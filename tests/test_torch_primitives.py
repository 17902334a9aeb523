"""Primitive projectors and detection: PyTorch port vs JAX package.

Every function of each projector (plane, cylinder, sphere, identity) gives
the JAX values on the same float32 inputs within ATOL (different libm and
summation orders round otherwise in the last bits).  The detectors, given
the JAX package's own hypothesis draws (threefry, which torch does not
reproduce), pick the same hypothesis: the states agree within 1e-5 and the
inlier masks agree except for points within EPS of the threshold.  The
plane fitted from a whole cloud is compared up to the normal's sign, which
the eigen solver picks.  ``make_cylinder`` equals the JAX generator bit for
bit, and the default thresholds (3x and 5x the resolution) are the JAX ones.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triplet_match_tpu.core.cloud import PointCloud as JCloud
from triplet_match_tpu.core.cloud import resolution as jresolution
from triplet_match_tpu.io.synthetic import make_cylinder as jmake_cylinder
from triplet_match_tpu.io.synthetic import make_plane_patch, rotation_matrix
from triplet_match_tpu.primitives import cylinder as jcyl
from triplet_match_tpu.primitives import detect as jdet
from triplet_match_tpu.primitives import identity as jident
from triplet_match_tpu.primitives import plane as jpln
from triplet_match_tpu.primitives import sphere as jsph
from triplet_match_tpu.primitives.base import unit_orthogonal as junit_orthogonal

from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.core.cloud import resolution
from triplet_match_tpu_torch.io.synthetic import make_cylinder
from triplet_match_tpu_torch.primitives import cylinder as cyl
from triplet_match_tpu_torch.primitives import detect
from triplet_match_tpu_torch.primitives import identity as ident
from triplet_match_tpu_torch.primitives import plane as pln
from triplet_match_tpu_torch.primitives import sphere as sph
from triplet_match_tpu_torch.primitives.base import unit_orthogonal

torch.set_num_threads(2)

ATOL = 2e-5  # float32 values of order 1, rounded in another order
EPS = 1e-5  # an inlier decision may differ only this close to the threshold


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=0, atol=atol)


def _sphere_arrays(n=1500, radius=0.4, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = np.array([0.3, -0.2, 0.5])
    return (c + radius * d).astype(np.float32), d.astype(np.float32)


def _posed(xyz, nrm, seed, noise):
    rng = np.random.default_rng(seed)
    r = rotation_matrix(rng.normal(size=3), rng.uniform(0, np.pi))
    t = rng.uniform(-1, 1, 3).astype(np.float32)
    x = xyz @ r.T + t + rng.normal(0, noise, xyz.shape).astype(np.float32)
    return x.astype(np.float32), (nrm @ r.T).astype(np.float32)


def _cluttered(xyz, nrm, n_clutter, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (n_clutter, 3)).astype(np.float32)
    cn = rng.normal(size=(n_clutter, 3)).astype(np.float32)
    cn /= np.linalg.norm(cn, axis=1, keepdims=True)
    return np.concatenate([xyz, c]), np.concatenate([nrm, cn])


def test_make_cylinder_bit_equal():
    for kw in (dict(), dict(n=1234, radius=0.35, height=1.5, seed=2, rim_edges=False)):
        for a, b in zip(make_cylinder(**kw), jmake_cylinder(**kw)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_unit_orthogonal_matches_jax():
    rng = np.random.default_rng(0)
    vs = np.concatenate([rng.normal(size=(50, 3)),
                         [[0, 0, 1], [0, 0, -2], [1e-8, 1e-8, 3]]]).astype(np.float32)
    _close(unit_orthogonal(_t(vs)), junit_orthogonal(_j(vs)))


def test_default_thresholds_equal_jax():
    x, n = _posed(*make_cylinder(n=3000, radius=0.35, height=1.5, seed=2, rim_edges=False)[:2],
                  1, 0.002)
    tr = resolution(PointCloud.from_arrays(x, n, device="cpu"))
    jr = jresolution(JCloud.from_arrays(x, n))
    for f in (3.0, 5.0):
        assert float(f * tr) == float(f * jr)


def _states(module, jmodule, case):
    """A batch of hypothesis states of one projector from both packages."""
    rng = np.random.default_rng(7)
    if case == "plane":
        x, n = make_plane_patch(n=64, seed=3)[:2]
        x, n = _posed(x, n, 2, 0.0)
        thr = np.float32(0.05)
        ts, tok = pln.fit_from_samples(pln.reference_state(_t(thr)), _t(x), _t(n))
        js, jok = jpln.fit_from_samples(jpln.PlaneState(jnp.eye(4), jnp.eye(4), jnp.zeros(3),
                                                        jnp.float32(thr)), _j(x), _j(n))
        return x, n, ts, js, tok, jok
    if case == "cylinder":
        x, n, _ = make_cylinder(n=128, radius=0.5, seed=4, rim_edges=False)
    else:
        x, n = _sphere_arrays(n=128, seed=4)
    x, n = _posed(x, n, 3, 0.0)
    i = rng.permutation(128)
    p1, p2, n1, n2 = x[i[:64]], x[i[64:]], n[i[:64]], n[i[64:]]
    thr = np.float32(0.05)
    tref = module.fit_from_samples(None, _t(p1[:1]), _t(p2[:1]), _t(n1[:1]), _t(n2[:1]))[0]
    tref = tref._replace(threshold=torch.tensor(thr))
    jref = jmodule.fit_from_samples(None, _j(p1[:1]), _j(p2[:1]), _j(n1[:1]), _j(n2[:1]))[0]
    jref = jref._replace(threshold=jnp.float32(thr))
    ts, tok = module.fit_from_samples(tref, _t(p1), _t(p2), _t(n1), _t(n2))
    js, jok = jmodule.fit_from_samples(jref, _j(p1), _j(p2), _j(n1), _j(n2))
    return x, n, ts, js, tok, jok


@pytest.mark.parametrize("case", ["plane", "cylinder", "sphere"])
def test_projector_functions_match_jax(case):
    module, jmodule = {"plane": (pln, jpln), "cylinder": (cyl, jcyl),
                       "sphere": (sph, jsph)}[case]
    x, n, ts, js, tok, jok = _states(module, jmodule, case)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    for a, b in zip(ts, js):  # fit_from_samples: every state field
        _close(a, b)
    ok = tok.numpy()
    assert ok.sum() > 32
    # the states index by hypothesis; every point through hypothesis 0 and each
    # hypothesis through its own point
    tan = np.cross(n, np.array([0.3, 0.9, 0.1], np.float32)).astype(np.float32)
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    s0 = type(ts)(*(a[int(np.flatnonzero(ok)[0])] for a in ts))
    j0 = type(js)(*(a[int(np.flatnonzero(ok)[0])] for a in js))
    for st, jst, pts, tn, nr in ((s0, j0, x, tan, n),):
        uvw, valid = module.project(st, _t(pts))
        juvw, jvalid = jmodule.project(jst, _j(pts))
        _close(uvw, juvw, 1e-4)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        _close(module.unproject(st, uvw), jmodule.unproject(jst, juvw), 1e-4)
        _close(module.tangent(st, _t(pts), _t(tn)), jmodule.tangent(jst, _j(pts), _j(tn)), 1e-4)
        _close(module.normal(st, _t(pts), _t(tn), _t(nr)),
               jmodule.normal(jst, _j(pts), _j(tn), _j(nr)), 1e-4)
        _close(module.intrinsic_distance(st, uvw[:-1], uvw[1:]),
               jmodule.intrinsic_distance(jst, juvw[:-1], juvw[1:]), 1e-4)
    if case == "plane":
        p3 = (x[:3], n[:3])
        ta, tok3 = pln.fit_from_samples3(s0, *(_t(a) for a in p3[0]), *(_t(a) for a in p3[1]))
        ja, jok3 = jpln.fit_from_samples3(j0, *(_j(a) for a in p3[0]), *(_j(a) for a in p3[1]))
        assert bool(tok3) == bool(jok3)
        for a, b in zip(ta, ja):
            _close(a, b)
        _close(pln.intrinsic_distance(s0, uvw[:-1], uvw[1:], planar=True),
               jpln.intrinsic_distance(j0, juvw[:-1], juvw[1:], planar=True))


def test_identity_and_plane_fit_from_cloud_match_jax():
    x, n = _posed(*make_plane_patch(n=1500, seed=0)[:2], 5, 0.001)
    tc, jc = PointCloud.from_arrays(x, n, device="cpu"), JCloud.from_arrays(x, n)
    ts, js = pln.fit_from_cloud(tc), jpln.fit_from_cloud(jc)
    _close(ts.origin, js.origin)
    _close(ts.threshold, js.threshold, 1e-6)
    tn, jn = ts.g2l[2, :3].numpy(), np.asarray(js.g2l)[2, :3]
    _close(tn * np.sign(tn @ jn), jn)  # the normal up to its sign
    uvw, valid = pln.project(ts, tc.xyz)
    assert bool(valid.all()) and float(uvw[:, 2].abs().max()) < 5e-3
    _close(pln.unproject(ts, uvw), x, 1e-4)
    s = ident.fit_from_cloud(tc)
    for a, b in zip(ident.project(s, _t(x)), jident.project(jident.fit_from_cloud(jc), _j(x))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ident.unproject(s, _t(x)).numpy(), x)
    _close(ident.intrinsic_distance(s, _t(x[:-1]), _t(x[1:])),
           jident.intrinsic_distance(jident.IdentityState(), _j(x[:-1]), _j(x[1:])))


def _jax_draws(key, h, n, mask, split):
    """The JAX detectors' sample indices (Gumbel-argmax over the mask)."""
    k = jax.random.split(key)[0] if split else key
    g = jax.random.gumbel(k, (h, n))
    return np.asarray(jnp.argmax(g + jnp.where(jnp.asarray(mask), 0.0, -jnp.inf), axis=-1))


def _near_threshold_only(differ, resid, thr):
    return bool((np.abs(resid[differ] - thr) <= EPS).all())


@pytest.mark.parametrize("kind", ["plane", "cylinder", "sphere"])
def test_detectors_pick_the_jax_hypothesis(kind):
    if kind == "plane":
        x, n = _posed(*make_plane_patch(n=3000, size=(2.0, 2.0), seed=1)[:2], 11, 0.002)
        n_true, h, thr = 3000, 64, 0.01
    elif kind == "cylinder":
        x, n = _posed(*make_cylinder(n=3000, radius=0.35, height=1.5, seed=2,
                                     rim_edges=False)[:2], 12, 0.002)
        n_true, h, thr = 3000, 128, 0.015
    else:
        x, n = _posed(*_sphere_arrays(n=2000, radius=0.4, seed=3), 13, 0.002)
        n_true, h, thr = 2000, 128, 0.015
    x, n = _cluttered(x, n, 1500, 21)
    mask = np.ones(x.shape[0], bool)
    mask[::53] = False
    tc = PointCloud.from_arrays(x, n, device="cpu")
    jc = JCloud.from_arrays(x, n)
    key = jax.random.PRNGKey(3)
    if kind == "plane":
        idx = _jax_draws(key, h, x.shape[0], mask, split=False)
        jd = jdet.detect_plane(jc, jnp.asarray(mask), key=key, num_hypotheses=h, threshold=thr)
        td = detect._detect_plane(tc, torch.from_numpy(np.array(idx)), torch.from_numpy(mask),
                                  torch.tensor(thr, dtype=torch.float32))
        resid = np.abs(np.asarray(jax.vmap(lambda p: (jd.state.g2l[2, :3] @ p)
                                           + jd.state.g2l[2, 3])(jnp.asarray(x))))
    else:
        idx = _jax_draws(key, 2 * h, x.shape[0], mask, split=True).reshape(2, h)
        jfn = jdet.detect_cylinder if kind == "cylinder" else jdet.detect_sphere
        tfn = detect._detect_cylinder if kind == "cylinder" else detect._detect_sphere
        jd = jfn(jc, jnp.asarray(mask), key=key, num_hypotheses=h, threshold=thr)
        td = tfn(tc, torch.from_numpy(np.array(idx)), torch.from_numpy(mask),
                 torch.tensor(thr, dtype=torch.float32))
        st = jd.state
        if kind == "cylinder":
            loc = x.astype(np.float64) @ np.asarray(st.g2l, np.float64)[:3, :3].T + np.asarray(
                st.g2l, np.float64)[:3, 3]
            resid = np.abs(np.linalg.norm(loc[:, :2], axis=1) - float(st.radius))
        else:
            resid = np.abs(np.linalg.norm(x - np.asarray(st.center), axis=1) - float(st.radius))
    for a, b in zip(td.state, jd.state):
        _close(a, b, 1e-5)
    got, ref = td.inliers.numpy(), np.asarray(jd.inliers)
    differ = got != ref
    assert _near_threshold_only(differ, resid, thr), np.flatnonzero(differ)
    assert ref[:n_true].mean() > 0.95 and ref[n_true:].mean() < 0.05  # the right primitive


@pytest.mark.parametrize("kind", ["plane", "cylinder", "sphere"])
def test_detectors_with_their_own_draws_find_the_primitive(kind):
    if kind == "plane":
        x, n = _posed(*make_plane_patch(n=3000, size=(2.0, 2.0), seed=1)[:2], 11, 0.002)
        fn, kw, n_true = detect.detect_plane, dict(num_hypotheses=128, threshold=0.01), 3000
    elif kind == "cylinder":
        x, n = _posed(*make_cylinder(n=3000, radius=0.35, height=1.5, seed=2,
                                     rim_edges=False)[:2], 12, 0.002)
        fn, kw, n_true = detect.detect_cylinder, dict(num_hypotheses=256, threshold=0.015), 3000
    else:
        x, n = _posed(*_sphere_arrays(n=2000, radius=0.4, seed=3), 13, 0.002)
        fn, kw, n_true = detect.detect_sphere, dict(num_hypotheses=256), 2000
    x, n = _cluttered(x, n, 1500, 21)
    det = fn(PointCloud.from_arrays(x, n, device="cpu"),
             generator=torch.Generator().manual_seed(1), **kw)
    inl = det.inliers.numpy()
    assert inl[:n_true].mean() > 0.95 and inl[n_true:].mean() < 0.05
    if kind == "cylinder":
        assert abs(float(det.state.radius) - 0.35) < 5e-3
    if kind == "sphere":
        assert abs(float(det.state.radius) - 0.4) < 5e-3
        assert float(det.state.threshold) == float(
            5.0 * resolution(PointCloud.from_arrays(x, n, device="cpu")))
