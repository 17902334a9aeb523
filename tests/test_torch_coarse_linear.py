"""Linearised coarse ranking (TPU kernel B4): PyTorch port vs JAX package.

On the CPU the port runs ``score_groups_coarse_linear_plain``; the JAX side
runs ``score_groups_coarse_linear`` in Pallas interpret mode at "highest"
precision.  Parity contract (``score_kernel.check_coarse_parity``): both
integer counts equal except near-gate points, the fractional tiebreak within
K float32 ulps.  Against B1 (another operand build) the near-gate band is
``score_kernel.linear_band``.  The CUDA kernel against the plain version is in
tests/test_torch_kernels_cuda.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from triplet_match_tpu.config import DiscretizationParams, SampleParams, SearchPolicy
from triplet_match_tpu.core.cloud import PointCloud as JCloud
from triplet_match_tpu.index.model import compile_model
from triplet_match_tpu.index.serialize import _CLOUD_FIELDS, _MODEL_FIELDS
from triplet_match_tpu.io.synthetic import embed_in_scene, make_box_model, rotation_matrix
from triplet_match_tpu.search import score_pallas as jsp
from triplet_match_tpu.search.driver import prepare_scene

from triplet_match_tpu_torch.core.cloud import PointCloud

from triplet_match_tpu_torch.index.model import compiled_model_from_numpy
from triplet_match_tpu_torch.search import score_kernel as tsk

torch.set_num_threads(2)

POLICY = SearchPolicy()


@pytest.fixture(scope="module")
def setup():
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    jm = compile_model(JCloud.from_arrays(xyz, nrm, tan), DiscretizationParams(),
                       SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95), POLICY,
                       pair_block=128)
    d = {f"cloud_{k}": np.asarray(getattr(jm.cloud, k)) for k in _CLOUD_FIELDS}
    d.update({k: np.asarray(getattr(jm, k)) for k in _MODEL_FIELDS})
    d["margin"] = jm.margin
    tm = compiled_model_from_numpy(d, device="cpu")
    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=200, seed=7)
    prep = prepare_scene(scene, POLICY)
    g, hg, k = 4, 32, 256
    rng = np.random.default_rng(11)
    n = prep.cloud.xyz.shape[0]
    nbr_idx = rng.integers(0, n, (g, k)).astype(np.int32)
    nbr_valid = rng.random((g, k)) > 0.1
    ts = np.tile(np.linalg.inv(np.asarray(t_gt)).astype(np.float32), (g, hg, 1, 1))
    ts[:, : hg // 2, :3, 3] += rng.normal(0, 0.01, (g, hg // 2, 3)).astype(np.float32)
    ts[:, hg // 2:, :3, 3] += rng.normal(0, 0.3, (g, hg - hg // 2, 3)).astype(np.float32)
    groups = np.array(jsp.pack_groups(prep.cloud, prep.tangent_mask, jnp.zeros(n, bool),
                                      jnp.asarray(nbr_idx), jnp.asarray(nbr_valid)))
    thres = 3.0 * float(jm.resolution)
    return dict(jpack=jsp.pack_model(jm, coarse_points=256, fine_points=512),
                tpack=tsk.pack_model(tm, coarse_points=256, fine_points=512), groups=groups,
                rows=np.array(jsp.poses_to_rows(jnp.asarray(ts))), t2=thres * thres)


@pytest.mark.parametrize("block,stride,strict_primary", [("coarse", 8, False), ("fine", 4, True)])
def test_coarse_linear_plain_matches_jax_and_b1(setup, block, stride, strict_primary):
    jp, tp = setup["jpack"], setup["tpack"]
    groups = np.ascontiguousarray(setup["groups"][:, :, ::stride])
    rows, t2 = setup["rows"], setup["t2"]
    t2c = tsk._inflate(t2, tp.coarse_slack if block == "coarse" else tp.fine_slack)
    ref = jsp.score_groups_coarse_linear(jp, jnp.asarray(groups), jnp.asarray(rows), t2c, t2,
                                         pose_tile=16, interpret=True, mxu_precision="highest",
                                         block=block, strict_primary=strict_primary)
    tg = torch.from_numpy(groups)
    got = tsk.score_groups_coarse_linear(tp, tg, torch.from_numpy(rows), t2c, t2, block=block,
                                         strict_primary=strict_primary)
    shifted = torch.from_numpy(rows).clone()
    shifted[..., 9:12] -= tp.center
    md = tp.md_coarse if block == "coarse" else tp.md_fine
    args = (tg, shifted, md, t2c, tp.kind_off, t2, strict_primary)
    _, excused = tsk.check_coarse_parity(got, torch.from_numpy(np.array(ref)), *args)
    assert excused == 0  # the plain version reproduces the interpret kernel's rounding
    b1 = tsk.score_groups_coarse(tp, tg, torch.from_numpy(rows), t2c, t2, block=block,
                                 strict_primary=strict_primary)
    tsk.check_coarse_parity(got, b1, *args, atol=tsk.linear_band(tg, shifted, tp.kind_off, md))
    hg = rows.shape[1]
    assert (got[:, : hg // 2].mean(1) > got[:, hg // 2:].mean(1)).all()
    assert tsk.COARSE_LINEAR_RANK.launches == 0  # the CPU path never counts a launch


def test_coarse_linear_rows_equal_jax_caller(setup):
    """The coefficient rows both the kernel and the plain version consume are
    the JAX caller's ``wcat`` rows (score_pallas.py:1060-1077) bit for bit."""
    rows = torch.from_numpy(setup["rows"]).clone()
    rows[..., 9:12] -= setup["tpack"].center
    wm = tsk.coarse_linear_rows(rows).numpy()
    r = rows[..., :9].reshape(*rows.shape[:2], 3, 3).numpy()
    t = rows[..., 9:12].numpy()
    # traced as in the JAX caller, whose rows XLA builds under jit
    rt_t, t2n = (np.asarray(a) for a in jax.jit(
        lambda r, t: (jnp.einsum("...ji,...j->...i", r, t), jnp.sum(t * t, axis=-1)))(r, t))
    np.testing.assert_array_equal(wm[..., 0:3, 0:3], -2.0 * r)
    np.testing.assert_array_equal(wm[..., 0:3, 5], -2.0 * t)
    np.testing.assert_array_equal(wm[..., 6, 0:3], 2.0 * rt_t)
    np.testing.assert_array_equal(wm[..., 6, 5], t2n)
    assert (wm[..., 3, 6] == -2).all() and (wm[..., 4:6, 5] == 1).all()
    assert (wm[..., 7, :] == 0).all()


def test_two_phase_coarse_linear_matches_jax(setup):
    """Both phases through B4 (coarse block, then the fine block with the
    strict count primary): the keep sets, counts and scores equal JAX's."""
    jp, tp = setup["jpack"], setup["tpack"]
    rows = setup["rows"]
    ok = np.ones(rows.shape[:2], bool)
    ok[:, 3::7] = False
    kw = dict(pose_tile=8, coarse_stride=8, keep_frac=4, fine_stride=4, fine_coarse=True,
              fine_strict=True, coarse_model=True, coarse_linear=True)
    sj, cj = jsp.score_groups_two_phase(jp, jnp.asarray(setup["groups"]), jnp.asarray(rows),
                                        setup["t2"], jnp.asarray(ok), interpret=True, **kw)
    st, ct = tsk.score_groups_two_phase(tp, torch.from_numpy(setup["groups"]),
                                        torch.from_numpy(rows), setup["t2"],
                                        torch.from_numpy(ok), **kw)
    sj, cj = np.asarray(sj), np.asarray(cj)
    np.testing.assert_array_equal(st.numpy() >= 0, sj >= 0)  # identical keep sets
    np.testing.assert_array_equal(ct.numpy(), cj)
    k = setup["groups"].shape[2] // 4
    np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=k * np.spacing(np.float32(k + 1)))


@pytest.mark.parametrize("case", ["one_kind_block", "far_poses"])
@pytest.mark.parametrize("ranker", ["B1", "B4"])
def test_coarse_plain_counts_cross_kind_hits_as_jax(setup, ranker, case):
    """Gates above the squared kind offset (ROADMAP C18), where the TPU
    kernels count a point whose nearest real representative is of the other
    kind: a block without edge representatives (a model without edge points)
    against the scene's edge points at the gate off^2 + t2, and poses that
    carry the groups 100 kind offsets away from the model at the median
    distance of the pairs whose nearest representative is of the other kind.
    Both plain versions equal the interpret kernels with no near-gate excuse,
    and the CUDA launchers set their ``cross`` sweep at such a gate
    (tests/test_torch_kernels_cuda.py holds the kernels there)."""
    groups = np.ascontiguousarray(setup["groups"][:, :, ::4])
    tg = torch.from_numpy(groups)
    if case == "one_kind_block":
        xyz, nrm, _ = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
        jp = jsp.pack_model(SimpleNamespace(cloud=JCloud.from_arrays(xyz, nrm)),
                            coarse_points=256, fine_points=512)
        tp = tsk.pack_model(SimpleNamespace(cloud=PointCloud.from_arrays(xyz, nrm, device="cpu")),
                            coarse_points=256, fine_points=512)
        assert tp.n_edge_reps == (0, 0)
        rows = torch.from_numpy(setup["rows"][:, :16].copy())  # near the true pose
        shifted = tsk._centre_shifted(tp, rows)
        t2 = tp.kind_off ** 2 + setup["t2"]
    else:
        jp, tp = setup["jpack"], setup["tpack"]
        g, hg = groups.shape[0], 16
        rng = np.random.default_rng(5)
        ts = np.tile(np.eye(4, dtype=np.float32), (g, hg, 1, 1))
        for i in range(g):
            for h in range(hg):
                ts[i, h, :3, :3] = rotation_matrix(rng.normal(size=3), rng.uniform(0, np.pi))
        d = rng.normal(size=(g, hg, 3))
        ts[..., :3, 3] = 100.0 * tp.kind_off * d / np.linalg.norm(d, axis=-1, keepdims=True)
        shifted = tsk.poses_to_rows(torch.from_numpy(ts))
        rows = shifted.clone()
        rows[..., 9:12] += tp.center
    md = tp.md_fine
    own, best = tsk.kind_minima(tg, shifted, md, tp.kind_off)
    if case == "far_poses":
        t2 = float(best[best < own].median())
    t2c = 1.05 * t2
    # the data reaches the cross-kind path: pairs that hit only through the other kind
    assert int(((best <= t2) & (own > t2)).sum()) > 0
    jfn, tfn = ((jsp.score_groups_coarse, tsk.score_groups_coarse) if ranker == "B1"
                else (jsp.score_groups_coarse_linear, tsk.score_groups_coarse_linear))
    ref = jfn(jp, jnp.asarray(groups), jnp.asarray(rows.numpy()), t2c, t2, pose_tile=16,
              interpret=True, mxu_precision="highest", block="fine")
    got = tfn(tp, tg, rows, t2c, t2, block="fine")
    _, excused = tsk.check_coarse_parity(got, torch.from_numpy(np.array(ref)), tg, shifted, md,
                                         t2c, tp.kind_off, t2, False)
    assert excused == 0
    assert float(got.max()) > 0.0
    assert tsk._cross_kind(t2c, t2, tp.kind_off)
    assert not tsk._cross_kind(tsk._inflate(setup["t2"], tp.fine_slack), setup["t2"],
                               tp.kind_off)
