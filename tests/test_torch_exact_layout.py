"""What the exact kernels (TPU kernels B2 and B3) rely on to sweep less.

The Hopper kernels (csrc/exact_rank.cuh) sweep the other kind's block only for
the (pose, eligible point) pairs whose own-kind squared distance is within the
gate, unless ``negative`` is on; they shift the poses by the model centre
themselves; and their launcher picks the poses per block.  This file pins on
the CPU that such a sweep scores bit for bit what the plain versions
(``score_groups_exact_plain``, ``score_groups_full_plain``) score, that the
skip would be wrong under ``negative``, that the launch geometry fills the
card and fits its shared memory, and that the plain path's centre shift is the
one float32 subtraction the kernels make.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.core.transforms import fma32
from triplet_match_tpu_torch.io.synthetic import embed_in_scene, make_box_model
from triplet_match_tpu_torch.search import score_kernel as sk

torch.set_num_threads(2)

H100_SMS = 132


@pytest.fixture(scope="module")
def setup():
    """The box model of tests/test_torch_exact_rank.py (120 edge + 360 face
    points) planted in a scene; groups [6, 8, 128] with a group of no
    eligible point; centre-shifted rows [6, 16, 16], half near the true pose
    and half junk."""
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    pack = sk.pack_model(SimpleNamespace(cloud=PointCloud.from_arrays(xyz, nrm, tan,
                                                                      device="cpu")))
    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=200, seed=7,
                                    device="cpu")
    tm = torch.linalg.vector_norm(scene.tangent, dim=-1) > 0.7
    rng = np.random.default_rng(5)
    g, hg, k = 6, 16, 128
    nbr_idx = torch.from_numpy(rng.integers(0, scene.capacity, (g, k)))
    nbr_ok = torch.from_numpy(rng.random((g, k)) > 0.1)
    nbr_ok[2] = False  # a group with no eligible point
    groups = sk.pack_groups(scene, tm, torch.zeros(scene.capacity, dtype=torch.bool), nbr_idx,
                            nbr_ok)
    ts = np.tile(np.linalg.inv(t_gt).astype(np.float32), (g, hg, 1, 1))
    ts[:, : hg // 2, :3, 3] += rng.normal(0, 0.004, (g, hg // 2, 3)).astype(np.float32)
    ts[:, hg // 2:, :3, 3] += rng.normal(0, 0.3, (g, hg - hg // 2, 3)).astype(np.float32)
    rows = sk.poses_to_rows(torch.from_numpy(ts))
    return dict(pack=pack, groups=groups, rows=rows, shifted=sk._centre_shifted(pack, rows),
                t2=float(np.float32(0.012) ** 2))


def _skip_sweep(groups, poses, md_edge, md_surf, refs, t2, inv2t, weighted, negative,
                skip=None):
    """The kernels' sweep in plain PyTorch: per eligible pair the own-kind
    minimum, the other-kind minimum only where the own-kind d2 <= t2 (or,
    unless ``skip`` says otherwise, everywhere with ``negative``; +inf where
    skipped), full mode's tie set for counted pairs; the plain versions'
    epilogue and order of summation."""
    g, hg = groups.shape[0], poses.shape[1]
    gi, ki = (groups[:, 4] > 0.5).nonzero(as_tuple=True)
    p = groups[gi, :, ki]
    q = [poses[gi, :, i] for i in range(12)]
    a, tp2 = sk._exact_operand(p, q)
    edge = (p[:, 3, None] > 0.5).expand_as(tp2)
    e_own = torch.where(edge, sk._block_min(a, md_edge), sk._block_min(a, md_surf))
    dk = tp2 + e_own
    need = (dk <= t2) | ((not skip) if skip is not None else negative)
    e_other = torch.full_like(dk, float("inf"))
    m, h = need.nonzero(as_tuple=True)
    sel = [ai[m, h] for ai in a]
    e_other[m, h] = torch.where(edge[m, h], sk._block_min(sel, md_surf),
                                sk._block_min(sel, md_edge))
    do = tp2 + e_other
    ok = (dk <= t2) & (dk <= do)
    count = torch.zeros((g, hg), dtype=torch.int32).index_add_(0, gi, ok.to(torch.int32))
    term = torch.exp(-dk * inv2t) if weighted else torch.ones_like(dk)
    if refs is not None:
        wam = torch.zeros_like(dk)
        thr = e_own + torch.tensor(sk._TIE_EPS)
        for own, blk, ref in ((edge, md_edge, refs[0]), (~edge, md_surf, refs[1])):
            mi, hi = (ok & own).nonzero(as_tuple=True)
            qs = [qi[mi, hi] for qi in q[:9]]
            rx, ry, rz = p[mi, 5], p[mi, 6], p[mi, 7]
            tr = [fma32(qs[3 * i + 2], rz, fma32(qs[3 * i], rx, qs[3 * i + 1] * ry))
                  for i in range(3)]
            wam[mi, hi] = sk._orientation_weight([ai[mi, hi] for ai in a], tr, thr[mi, hi],
                                                 blk, ref)
        term = wam * term
    pos = torch.zeros((g, hg), dtype=torch.float64).index_add_(
        0, gi, torch.where(ok, term, 0.0).double())
    neg = torch.zeros_like(pos)
    if negative:
        wrong = (do <= t2) & (do < dk)
        w_neg = torch.exp(-do * inv2t) if weighted else torch.ones_like(do)
        neg.index_add_(0, gi, torch.where(wrong, w_neg, 0.0).double())
    signed = refs is not None or weighted or negative
    return ((pos - neg).float() if signed else count.float()), count


@pytest.mark.parametrize("mode,weighted,kinds", [
    ("count", False, "both"), ("count", True, "both"), ("full", False, "both"),
    ("full", True, "both"), ("count", False, "edge"), ("full", False, "edge")])
def test_other_kind_skip_scores_as_the_plain_versions(setup, mode, weighted, kinds):
    """Skipping the other kind where the own-kind d2 is beyond the gate
    changes no count and no score bit, for both kinds of points (or edge
    points only, as the fog route ranks), ineligible points and a group with
    none eligible."""
    pack, shifted, t2 = setup["pack"], setup["shifted"], setup["t2"]
    groups = setup["groups"].clone()
    if kinds == "edge":
        groups[:, 4] *= groups[:, 3]
    el = groups[:, 4] > 0.5
    assert (~el).any() and not el[2].any()
    assert (el & (groups[:, 3] > 0.5)).any()
    assert (el & (groups[:, 3] < 0.5)).any() == (kinds == "both")
    me, ms = sk.exact_blocks(pack)
    refs = sk.ref_blocks(pack) if mode == "full" else None
    inv2t = sk._inv2t(t2)
    if refs is None:
        plain = sk.score_groups_exact_plain(groups, shifted, me, ms, t2, inv2t, weighted)
    else:
        plain = sk.score_groups_full_plain(groups, shifted, me, ms, *refs, t2, inv2t, weighted)
    got = _skip_sweep(groups, shifted, me, ms, refs, t2, inv2t, weighted, False)
    assert torch.equal(got[1], plain[1]) and torch.equal(got[0], plain[0])
    gi, ki, d_own, _ = sk.exact_pair_d2(groups, shifted, me, ms)
    within = d_own <= t2
    assert within.any() and (~within).any()  # the skip both sweeps and skips here
    assert int(plain[1].sum()) > 0 and int(plain[1][2].abs().max()) == 0


def test_negative_needs_the_other_kind_everywhere(setup):
    """With ``negative``, a point beyond the gate of its own kind still
    subtracts its other-kind neighbour: an edge-kind scene point on a surface
    model point is such a pair, and the skip would lose its term."""
    pack, t2 = setup["pack"], setup["t2"]
    me, ms = sk.exact_blocks(pack)
    inv2t = sk._inv2t(t2)
    groups = torch.zeros(1, 8, 1)
    groups[0, :3, 0] = ms[:3, 0]  # on the first surface column (centred coordinates)
    groups[0, 3, 0] = 1.0  # an edge point
    groups[0, 4, 0] = 1.0
    poses = torch.zeros(1, 1, 16)
    poses[0, 0, [0, 4, 8]] = 1.0  # identity, already centre-shifted
    gi, ki, d_own, d_other = sk.exact_pair_d2(groups, poses, me, ms)
    assert float(d_own[0, 0]) > t2 and float(d_other[0, 0]) <= t2
    for weighted in (False, True):
        plain = sk.score_groups_exact_plain(groups, poses, me, ms, t2, inv2t, weighted, True)
        assert float(plain[0][0, 0]) < 0.0 and int(plain[1][0, 0]) == 0
        kept = _skip_sweep(groups, poses, me, ms, None, t2, inv2t, weighted, True)
        assert torch.equal(kept[0], plain[0])
        skipped = _skip_sweep(groups, poses, me, ms, None, t2, inv2t, weighted, True, skip=True)
        assert torch.equal(skipped[1], plain[1]) and float(skipped[0][0, 0]) == 0.0


@pytest.mark.parametrize("g,hg", [(256, 512), (256, 64), (256, 32), (16, 96), (16, 33)])
def test_launch_geometry_fills_the_card(g, hg):
    """The main path's shapes (500k fog phase 1 and single phase, phase 2,
    131k full-mode phase 2) and the card-only tests' give at least two blocks
    per SM of an H100, with no more than half of a block's poses past Hg."""
    npt = sk.exact_pose_tiles(g, hg, H100_SMS)
    most = sk._EXACT_MAX_POSE_TILES
    assert 1 <= npt <= most and npt & (npt - 1) == 0 and sk.EXACT_THREADS % most == 0
    pb = npt * sk.EXACT_TILE[0]
    blocks = g * -(-hg // pb)
    assert pb // 2 < hg
    if g * hg >= 4 * H100_SMS * sk.EXACT_TILE[0]:
        assert blocks >= 2 * H100_SMS
    if npt < most:  # a larger block would have left fewer than two per SM
        assert g * -(-hg // (2 * pb)) < 2 * H100_SMS or pb >= hg


def test_shared_memory_fits_the_largest_pack():
    """A 4096-point pack ranked at K = 512 with the most pose tiles per block
    fits the card's 227 KB in both modes; the full mode stages twice the
    columns and points."""
    most = sk._EXACT_MAX_POSE_TILES
    for ne, ns in ((1024, 3072), (1, 4095)):
        count = sk.exact_smem_bytes(False, ne, ns, 512, most)
        full = sk.exact_smem_bytes(True, ne, ns, 512, most)
        assert full <= sk._SMEM_MAX and full - count == 16 * (4096 + 512 + 8)
    # the main path's: 600 + 1800 columns, K = 64 / 512 / 128
    assert sk.exact_smem_bytes(False, 600, 1800, 64, 128) < 80 * 1024
    assert sk.exact_smem_bytes(True, 600, 1800, 128, 8) < 100 * 1024


def test_centre_shift_is_one_float32_subtraction(setup):
    """The CPU path on uncentred rows equals the old clone-and-shift path bit
    for bit, and that shift is t - c rounded once to float32 per entry (the
    kernels' __fsub_rn with the centre's three floats)."""
    pack, groups, rows, t2 = setup["pack"], setup["groups"], setup["rows"], setup["t2"]
    old = rows.clone()
    old[..., 9:12] -= pack.center
    t = rows[..., 9:12].numpy()
    c = np.asarray(pack.center_xyz, np.float32)
    np.testing.assert_array_equal(old[..., 9:12].numpy(), (t - c).astype(np.float32))
    assert torch.equal(sk._centre_shifted(pack, rows), old)
    me, ms = sk.exact_blocks(pack)
    inv2t = sk._inv2t(t2)
    for mode, weighted, negative in (("count", False, False), ("count", True, True),
                                     ("full", True, False)):
        got = sk.score_groups_exact(pack, groups, rows, t2, mode=mode, weighted_distance=weighted,
                                    negative_scores=negative)
        if mode == "full":
            ref = sk.score_groups_full_plain(groups, old, me, ms, *sk.ref_blocks(pack), t2,
                                             inv2t, weighted, negative)
        else:
            ref = sk.score_groups_exact_plain(groups, old, me, ms, t2, inv2t, weighted, negative)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
