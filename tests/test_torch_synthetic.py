"""The port's jax-free fixture generators vs the JAX package and the study scripts.

``chip_smoke.py`` builds its fixture from the port alone (the machine with the
card has no jax), so the port's copies must give the same clouds bit for bit.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from triplet_match_tpu.io import synthetic as jsyn

from triplet_match_tpu_torch.io import synthetic as tsyn

REPO = Path(__file__).resolve().parent.parent


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cloud_arrays(c):
    return [np.asarray(getattr(c, f)) for f in ("xyz", "normal", "tangent", "valid")]


def test_box_model_and_embed_identical():
    ref = jsyn.make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    got = tsyn.make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    js, jt, ji = jsyn.embed_in_scene(*ref, noise=0.001, n_clutter=200, seed=7, capacity=700)
    ts, tt, ti = tsyn.embed_in_scene(*got, noise=0.001, n_clutter=200, seed=7, capacity=700,
                                  device="cpu")
    for a, b in zip(_cloud_arrays(ts), _cloud_arrays(js)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tsyn.rotation_matrix([1, 2, 3], 0.7),
                                  jsyn.rotation_matrix([1, 2, 3], 0.7))


@pytest.mark.parametrize("seed", [0, 3])
def test_recall_scene_matches_recall_study(seed):
    study = _script("recall_study")
    arrays = tsyn.recall_box_model()
    for a, b in zip(arrays, study.model_arrays("box")):
        np.testing.assert_array_equal(a, b)
    jcloud, jt = study.build_scene(6000, seed)
    tcloud, tt = tsyn.recall_scene(6000, seed, device="cpu")
    for a, b in zip(_cloud_arrays(tcloud), _cloud_arrays(jcloud)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tt, jt)


def test_sym_delta_matches_baseline_script():
    ref_fn = _script("run_baseline_configs")._sym_delta
    rng = np.random.default_rng(2)
    t_gt = np.eye(4, dtype=np.float32)
    t_gt[:3, :3] = tsyn.rotation_matrix(rng.normal(size=3), 1.1)
    t_gt[:3, 3] = [0.3, -0.2, 0.5]
    for axis in (None, [1, 0, 0], [0, 0, 1]):
        t = t_gt.copy()
        if axis is not None:  # a box-symmetric copy of the ground truth
            t[:3, :3] = t[:3, :3] @ tsyn.rotation_matrix(axis, np.pi)
        t[:3, :3] = t[:3, :3] @ tsyn.rotation_matrix(rng.normal(size=3), np.radians(2.0))
        t[:3, 3] += rng.normal(0, 0.002, 3).astype(np.float32)
        got, ref = tsyn.sym_delta(t, t_gt), ref_fn(t, t_gt)
        assert abs(got[0] - ref[0]) <= 1e-6
        assert abs(got[1] - ref[1]) <= 1e-3
        assert got[0] < 0.01 and 1.0 < got[1] < 3.0  # the symmetric copy was found
    assert tsyn.sym_delta(t_gt, t_gt)[0] < 1e-6
