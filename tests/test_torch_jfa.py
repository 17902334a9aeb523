"""The jump-flood LUT and the recall protocol's model families: PyTorch port
vs JAX package.

``ops/jfa.nearest_point_volume`` against the JAX one on the same numpy
inputs, ``compile_model`` through the jump-flood route in both packages (the
voxel threshold lowered so a small model takes it), and the port's copies of
``make_lattice_model`` and ``scripts/recall_study.model_arrays``.  Integer
outputs and arrays must be equal exactly.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from triplet_match_tpu.config import DiscretizationParams, SampleParams, SearchPolicy
from triplet_match_tpu.core.cloud import PointCloud as JCloud
from triplet_match_tpu.index import model as jmodel
from triplet_match_tpu.io import synthetic as jsyn
from triplet_match_tpu.ops import jfa as jjfa

from triplet_match_tpu_torch import config as tcfg
from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.index import model as tmodel
from triplet_match_tpu_torch.io import synthetic as tsyn
from triplet_match_tpu_torch.ops import jfa as tjfa

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SAMPLE = SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
TSAMPLE = tcfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
MODELS = {
    "box": lambda: jsyn.make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0),
    "lattice": lambda: jsyn.make_lattice_model(cells=2, n_edge=3000, graded=True, seed=0),
}


@pytest.mark.parametrize("kind,resolution", [("box", 0.05), ("box", 0.03), ("lattice", 0.03)])
def test_nearest_point_volume_identical(kind, resolution):
    """Same points (some invalid), grid and affine: the same integer LUT."""
    xyz = MODELS[kind]()[0]
    valid = np.ones(xyz.shape[0], bool)
    valid[::17] = False
    extents, to_voxel = tmodel._voxel_grid_setup(xyz.min(0), xyz.max(0), resolution, 5)
    ref = np.asarray(jjfa.nearest_point_volume(jnp.asarray(xyz), jnp.asarray(valid),
                                               jnp.asarray(to_voxel), extents=extents))
    got = tjfa.nearest_point_volume(torch.from_numpy(xyz), torch.from_numpy(valid),
                                    torch.from_numpy(to_voxel), extents=extents)
    assert got.dtype == torch.int64 and tuple(got.shape) == extents
    np.testing.assert_array_equal(got.numpy(), ref)
    assert valid[got.numpy()].all()


def test_nearest_point_volume_refuses_above_2_20_points():
    pts = torch.zeros(((1 << 20) + 1, 3))
    with pytest.raises(ValueError, match="2\\^20"):
        tjfa.nearest_point_volume(pts, torch.ones(pts.shape[0], dtype=torch.bool),
                                  torch.eye(4), extents=(2, 2, 2))


def test_compile_model_jump_flood_route_identical(monkeypatch):
    """With the voxel threshold lowered in both packages, compile_model builds
    the LUT by jump flood: equal LUTs and equal pair tables."""
    # a model no other test compiles, so the JAX package's jitted build traces
    # anew under the lowered threshold
    xyz, nrm, tan = jsyn.make_box_model(n_edge=108, n_face=300, size=(1.0, 0.9, 0.5), seed=4)
    monkeypatch.setattr(jmodel, "_LUT_JFA_THRESHOLD", 1000)
    monkeypatch.setattr(tmodel, "_LUT_JFA_THRESHOLD", 1000)
    jm = jmodel.compile_model(JCloud.from_arrays(xyz, nrm, tan), DiscretizationParams(), SAMPLE,
                              SearchPolicy(), pair_block=64)
    tm = tmodel.compile_model(PointCloud.from_arrays(xyz, nrm, tan, device="cpu"),
                              tcfg.DiscretizationParams(), TSAMPLE, tcfg.SearchPolicy(),
                              pair_block=64)
    assert int(np.prod(tm.extents)) > 1000 and tm.extents == tuple(jm.lut.shape)
    np.testing.assert_array_equal(tm.lut.numpy(), np.asarray(jm.lut))
    for name in ("keys", "pairs", "pair_count", "n_edge"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
                                      err_msg=name)


def _recall_study():
    spec = importlib.util.spec_from_file_location("_recall_study",
                                                  REPO / "scripts" / "recall_study.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("graded", [False, True])
def test_make_lattice_model_identical(graded):
    ref = jsyn.make_lattice_model(cells=3, n_edge=1500, seed=2, jitter=0.001, graded=graded)
    got = tsyn.make_lattice_model(cells=3, n_edge=1500, seed=2, jitter=0.001, graded=graded)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["box", "low-edge", "lattice"])
def test_model_arrays_match_recall_study(kind):
    ref = _recall_study().model_arrays(kind)
    got = tsyn.model_arrays(kind)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tsyn.model_arrays("cylinder")
