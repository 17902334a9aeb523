"""What the coarse kernels (TPU kernels B1 and B4) rely on to sweep less.

The Hopper kernels sweep, for each eligible point, only the real
representatives of the point's own kind (below a gate of half the squared
kind offset), and skip ineligible points.  This file pins on the CPU that
such a sweep scores bit for bit what the plain all-representative versions
(``score_groups_coarse_plain``, ``score_groups_coarse_linear_plain``)
score, and that ``pack_model`` records the representative counts the
kernels take.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.io.synthetic import embed_in_scene, make_box_model
from triplet_match_tpu_torch.search import score_kernel as sk

torch.set_num_threads(2)


def _own_kind_score(a, tp2, groups, md, n_edge, n_reps, t2c, t2, w_inf, w_str):
    """The kernels' sweep in plain PyTorch: per eligible point the minimum
    over its own kind's real representatives (an edge point over columns
    [0, n_edge), a surface point over [n_edge, n_reps)), |tp4|^2 hi/lo added
    after the minimum; ineligible points add 0."""
    hi, lo = sk._bf16_split(tp2)

    def kind_min(c0, c1):
        m = md[:, c0:c1]
        if m.shape[1] == 0:
            return torch.full_like(tp2, float("inf"))
        d = a[0][..., None] * m[0]
        d = (a[1][..., None].double() * m[1].double() + d).float()
        d = (a[2][..., None].double() * m[2].double() + d).float()
        d = ((d + a[3][..., None] * m[3]) + m[4]) + m[5]
        return d.amin(-1)

    edge = groups[:, None, 3, :] > 0.5
    dmin = torch.where(edge, kind_min(0, n_edge), kind_min(n_edge, n_reps))
    d = (dmin + hi) + lo
    hit = (d <= t2c).float() * w_inf + (d <= t2).float() * w_str
    return torch.where(groups[:, None, 4, :] > 0.5, hit, 0.0).sum(-1)


@pytest.mark.parametrize("block,strict_primary,edges", [
    ("coarse", False, True), ("coarse", True, True), ("fine", False, True),
    ("fine", True, True), ("coarse", False, False)])
def test_own_kind_sweep_scores_as_the_plain_versions(block, strict_primary, edges):
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    if not edges:  # a model without edge points: every representative is a surface one
        tan = np.zeros_like(tan)
    pack = sk.pack_model(SimpleNamespace(cloud=PointCloud.from_arrays(xyz, nrm, tan,
                                                                      device="cpu")),
                         coarse_points=256, fine_points=512)
    for i, md in enumerate((pack.md_coarse, pack.md_fine)):
        real = (md[4] + md[5]) < 1e11
        assert pack.n_reps[i] == int(real.sum()) and bool(real[:pack.n_reps[i]].all())
        assert pack.n_edge_reps[i] == int((md[3] == pack.kind_off).sum())
        assert bool((md[3, :pack.n_edge_reps[i]] == pack.kind_off).all())
    assert (pack.n_edge_reps[0] > 0) == edges
    assert pack.center_xyz == tuple(float(c) for c in pack.center)

    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=300, seed=7,
                                    device="cpu")
    tm = torch.linalg.vector_norm(scene.tangent, dim=-1) > 0.7
    rng = np.random.default_rng(5)
    g, hg, k, stride = 6, 16, 256, 8 if block == "coarse" else 4
    nbr_idx = torch.from_numpy(rng.integers(0, scene.capacity, (g, k)))
    nbr_ok = torch.from_numpy(rng.random((g, k)) > 0.1)
    nbr_ok[1] = False  # a group with no eligible point
    groups = sk.pack_groups(scene, tm, torch.zeros(scene.capacity, dtype=torch.bool), nbr_idx,
                            nbr_ok)[:, :, ::stride].contiguous()
    ts = np.tile(np.linalg.inv(t_gt).astype(np.float32), (g, hg, 1, 1))
    ts[:, : hg // 2, :3, 3] += rng.normal(0, 0.004, (g, hg // 2, 3)).astype(np.float32)
    ts[:, hg // 2:, :3, 3] += rng.normal(0, 0.3, (g, hg - hg // 2, 3)).astype(np.float32)
    rows = sk.poses_to_rows(torch.from_numpy(ts))
    shifted = sk._centre_shifted(pack, rows)

    t2 = float(np.float32(0.012) ** 2)
    md, n_edge, n_reps, args = sk._coarse_inputs(pack, groups, sk._inflate(
        t2, pack.coarse_slack if block == "coarse" else pack.fine_slack), t2, block,
        strict_primary)
    t2c, off, _, w_inf, w_str = args
    for a, tp2, plain in (
            (*sk._coarse_operand(groups, shifted, off),
             sk.score_groups_coarse_plain(groups, shifted, md, *args)),
            (*sk._coarse_linear_operand(groups, sk.coarse_linear_rows(shifted), off),
             sk.score_groups_coarse_linear_plain(groups, sk.coarse_linear_rows(shifted), md,
                                                 *args))):
        own = _own_kind_score(a, tp2, groups, md, n_edge, n_reps, t2c, t2, w_inf, w_str)
        assert torch.equal(own, plain)
        assert float(plain[:, : hg // 2].sum()) > 0.0  # the near-true poses hit
        assert float(plain[1].abs().max()) == 0.0


@pytest.mark.parametrize("launch", [sk._coarse_launch, sk._coarse_linear_launch])
@pytest.mark.parametrize("strict_gate", [False, True])
def test_coarse_launch_rejects_a_gate_beyond_the_kind_offset(launch, strict_gate):
    """The own-kind sweep is exact only while a cross-kind pair (kind_off^2
    apart) can never be under a gate.  The launchers used to refuse a larger
    gate; since the kernels' cross-kind sweep (ROADMAP C18) they take it and
    set ``cross`` (``_cross_kind``), so such a call is rejected only for what
    any call is rejected for: here, tensors off the card."""
    off = 4.0
    t2, t2s = (1e-4, off * off) if strict_gate else (off * off + 1.0, 1e-4)
    assert sk._cross_kind(t2, t2s, off)
    assert not sk._cross_kind(1e-4, 0.49 * off * off, off)
    z = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch(z, torch.zeros(1, 2, 16), torch.zeros(8, 4), 0, 4, (0.0, 0.0, 0.0), t2, off, t2s,
               1.0, 0.0)
