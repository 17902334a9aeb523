"""The benchmark's frozen copies equal, bit for bit, what they were copied
from: the port's scan generators and pose arithmetic
(``triplet_match_tpu_torch.io.synthetic``), and the kernel counts of
``chip_smoke.py`` with the pair arithmetic of ``search.score_kernel``."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "benchmark"))
sys.path.insert(1, str(ROOT))

import chip_smoke  # noqa: E402
from tmbench import counts, synthetic  # noqa: E402
from triplet_match_tpu_torch.io import synthetic as port  # noqa: E402
from triplet_match_tpu_torch.search import score_kernel as sk  # noqa: E402


def _same(a, b):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("size,seed", [((1.0, 0.8, 0.6), 0), ((1.3, 0.45, 0.85), 50)])
def test_box_model(size, seed):
    _same(synthetic.make_box_model(600, 1800, size, seed),
          port.make_box_model(n_edge=600, n_face=1800, size=size, seed=seed))


def test_rotation_and_fog():
    np.testing.assert_array_equal(synthetic.rotation_matrix([0.3, 1.0, 0.2], 1.1),
                                  port.rotation_matrix([0.3, 1.0, 0.2], 1.1))
    a = synthetic.fog_patches(np.random.default_rng(3), 5000, seed_base=77)
    b = port.fog_patches(np.random.default_rng(3), 5000, seed_base=77)
    _same(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_recall_scene(seed):
    model = port.recall_box_model()
    mine = synthetic.recall_scene_arrays(9000, seed, model)
    _same(mine, port.recall_scene_arrays(9000, seed, model))


def test_sym_pose_error():
    rng = np.random.default_rng(5)
    for _ in range(8):
        gt = np.eye(4, dtype=np.float32)
        gt[:3, :3] = port.rotation_matrix(rng.normal(size=3), rng.uniform(0, np.pi))
        gt[:3, 3] = rng.uniform(-1, 1, 3)
        t = gt.copy()
        t[:3, :3] = t[:3, :3] @ port.rotation_matrix(rng.normal(size=3), rng.uniform(0, 0.02))
        t[:3, 3] += rng.normal(0, 1e-3, 3).astype(np.float32)
        assert synthetic.sym_pose_error(t, gt) == port.sym_pose_error(t, gt)


def _kernel_inputs(g=6, k=24, hg=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    groups = torch.randn(g, 8, k, generator=gen)
    groups[:, 3] = (torch.rand(g, k, generator=gen) > 0.6).float()
    groups[:, 4] = (torch.rand(g, k, generator=gen) > 0.2).float()
    poses = torch.randn(g, hg, 16, generator=gen) * 0.5
    me = torch.randn(8, 20, generator=gen)
    ms = torch.randn(8, 30, generator=gen)
    me[3] = (me[:3] ** 2).sum(0)
    ms[3] = (ms[:3] ** 2).sum(0)
    return groups, poses, me, ms


def test_constants_and_bound():
    assert counts.FP32_INSTR_PER_S == chip_smoke.FP32_INSTR_PER_S
    assert counts.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    for instr, nbytes in ((1e9, 1e6), (1e6, 1e9)):
        assert counts.bound_s(instr, nbytes) * 1e3 == pytest.approx(
            chip_smoke._bound(instr, nbytes)[0], rel=1e-15)


def test_exact_pair_d2_bit_for_bit():
    groups, poses, me, ms = _kernel_inputs()
    mine = counts.exact_pair_d2(groups, poses, me, ms)
    theirs = sk.exact_pair_d2(groups, poses, me, ms)
    for a, b in zip(mine, theirs, strict=True):
        assert torch.equal(a, b)


def test_b2_work_is_chip_smokes_count():
    groups, poses, me, ms = _kernel_inputs(seed=1)
    center = torch.tensor([0.1, -0.2, 0.3])
    t2 = 0.7
    for negative in (False, True):
        instr, nbytes = counts.b2_work(groups, poses, me, ms, center, t2, negative)
        # chip_smoke._check_exact's count, on the plain version's distances
        shifted = poses.clone()
        shifted[..., 9:12] -= center
        n_poses, ne, ns = poses.shape[1], me.shape[1], ms.shape[1]
        gi, ki, d_own, _ = sk.exact_pair_d2(groups, shifted, me, ms)
        edge = (groups[gi, 3, ki] > 0.5)[:, None]
        own_cols = torch.where(edge, ne, ns).double()
        other_cols = torch.where(edge, ns, ne).double()
        gate = d_own <= t2
        surv = torch.ones_like(gate) if negative else gate
        want = (5.0 * (float(own_cols.sum()) * n_poses + float((other_cols * surv).sum()))
                + 17.0 * float(gate.numel()) + 3.0 * groups.shape[0] * n_poses)
        assert instr == want
        assert nbytes == chip_smoke._nbytes(groups, poses) + 16 * (ne + ns) + 8 * 6 * n_poses


def test_b1_work_is_chip_smokes_count():
    groups, poses, me, _ = _kernel_inputs(seed=2)
    n_edge, n_reps = 7, 18
    instr, nbytes = counts.b1_work(groups, poses, me, n_edge, n_reps)
    # chip_smoke.main's B1 phase count
    n_poses = poses.shape[1]
    el = groups[:, 4] > 0.5
    n_el_e = (el & (groups[:, 3] > 0.5)).sum(1).double()
    n_el = el.sum(1).double()
    evals = float((n_el_e * n_edge + (n_el - n_el_e) * (n_reps - n_edge)).sum()) * n_poses
    pairs = float(n_el.sum()) * n_poses
    assert instr == 7.0 * evals + 20.0 * pairs + 3.0 * groups.shape[0] * n_poses
    assert nbytes == chip_smoke._nbytes(groups, poses, me) + 4 * groups.shape[0] * n_poses
