"""Two-phase hypothesis ranking (counterpart of ``triplet_match_tpu.search.score_pallas``).

Hypotheses minted from one first point share that point's K-point scene
neighbourhood, staged once per *group* as [8, K] channel planes.  Phase 1
ranks every pose on a strided neighbourhood subsample; the per-group top
1/keep_frac survive to phase 2, which re-ranks them (impl/scene.hpp:421-425,
492-506 batched).  At standard density both phases sweep 4-D representative
blocks (256, then 512 with the strict count as the primary key); on the
fog-density route both take exact distances to the whole model.

Four kernels rank, one for each TPU kernel of ``score_pallas.py``:

* ``score_groups_coarse`` (B1, ``_coarse_kernel``) sweeps a 4-D
  representative block; the standard-density configuration runs it in both
  phases.
* ``score_groups_exact`` (B2, ``_kernel`` in count mode) takes the exact
  nearest-neighbour distance to the whole compact edge and surface blocks; the
  fog-density route runs it in both phases, the single-phase route alone.
* ``score_groups_exact(mode="full")`` (B3, ``_kernel`` in full mode) adds the
  reference's orientation weight to B2's count; ``ranking_mode="full"`` runs
  it wherever B2 would rank the survivors or the single phase.
* ``score_groups_coarse_linear`` (B4, ``_coarse_linear_kernel``) is B1 with a
  pose-linearised operand; ``two_phase_coarse_linear`` runs it in place of B1.

On a CUDA tensor each launches its hand-written Hopper kernel
(``csrc/coarse_rank.cu``, ``exact_rank.cu``, ``full_rank.cu``,
``coarse_linear_rank.cu``); on a CPU tensor it runs its plain PyTorch version
of the same arithmetic.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import numpy as np
import torch

from triplet_match_tpu_torch.core.transforms import fma32
from triplet_match_tpu_torch.kernels.build import (
    LaunchCounter,
    load_coarse_linear_rank,
    load_coarse_rank,
    load_exact_rank,
    load_full_rank,
)

_BIG = np.float32(1.0e12)
_FAR = 1.0e6  # padding coordinate for invalid points


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class ModelPack(NamedTuple):
    """Model arrays staged for the ranking kernels (built once per model).

    The JAX ``ModelPack``'s arrays: ``md_edge``/``md_surf`` are the compact
    blocks [x, y, z, |p|^2, 0, 0, 0, 0] that B2 and B3 sweep (their first
    ``n_edge_cols``/``n_surf_cols`` columns are model points, the rest FAR
    padding); ``channels_d``/``channels_w`` are the full pack that the TPU's
    B3 sweeps; ``md_coarse``/``md_fine`` are the 4-D representative blocks
    [x, y, z, w(kind), |p4|^2_hi, |p4|^2_lo, 1, 1] that B1 and B4 sweep.  The
    port adds ``mref_edge``/``mref_surf`` [3, *], the reference vectors
    (tangents, normals) of the compact blocks' columns, for B3, and for B1 and
    B4 the centre as host floats and each 4-D block's representative counts
    (its first ``n_edge_reps`` columns are edge representatives, the next up
    to ``n_reps`` surface ones, the rest padding).  The scalars are python
    floats (float32 values) and ints.
    """

    channels_d: torch.Tensor
    channels_w: torch.Tensor
    n_pad: int
    center: torch.Tensor  # [3] the subtracted model centroid
    md_edge: torch.Tensor
    md_surf: torch.Tensor
    md_coarse: torch.Tensor  # [8, NcP]
    kind_off: float
    coarse_slack: float
    md_fine: torch.Tensor  # [8, NfP]
    fine_slack: float
    n_edge_cols: int  # model points in md_edge
    n_surf_cols: int  # model points in md_surf
    mref_edge: torch.Tensor  # [3, NeP] tangents of md_edge's columns (0 on padding)
    mref_surf: torch.Tensor  # [3, NsP] normals of md_surf's columns
    center_xyz: tuple  # (x, y, z) of ``center``
    n_edge_reps: tuple  # (md_coarse, md_fine) edge representatives
    n_reps: tuple  # (md_coarse, md_fine) real representatives


def _coverage_subsample(xyz, valid, cap: int):
    """Pick <= cap representatives with uniform surface coverage (host numpy).

    Voxel-downsample: bisect the cell size until the occupied-cell count
    fits the cap, keep one point per occupied cell.
    """
    idx = np.where(valid)[0]
    if idx.size <= cap:
        return idx
    pts = xyz[idx]
    lo = pts.min(0)
    ext = float(max((pts.max(0) - lo).max(), 1e-9))

    def occupied(cell):
        q = np.floor((pts - lo) / cell).astype(np.int64)
        return (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]

    lo_c, hi_c = ext / 4096.0, ext
    for _ in range(40):
        mid = 0.5 * (lo_c + hi_c)
        if np.unique(occupied(mid)).size > cap:
            lo_c = mid
        else:
            hi_c = mid
    _, first = np.unique(occupied(hi_c), return_index=True)
    return np.sort(idx[first])


_PACK_CACHE: dict = {}
_PACK_CACHE_MAX = 8


def pack_model_cached(model, max_points: int = 4096, coarse_points: int = 512,
                      fine_points: int = 1536) -> ModelPack:
    """Memoized :func:`pack_model`, keyed on the model's identity and the knobs.

    The model is held weakly, and a recycled ``id`` never serves a stale pack.
    """
    key = (id(model), max_points, coarse_points, fine_points)
    hit = _PACK_CACHE.get(key)
    if hit is not None:
        ref, pack = hit
        if ref() is model:
            return pack
        _PACK_CACHE.pop(key, None)
    pack = pack_model(model, max_points, coarse_points, fine_points)
    _PACK_CACHE[key] = (weakref.ref(model), pack)
    while len(_PACK_CACHE) > _PACK_CACHE_MAX:
        _PACK_CACHE.pop(next(iter(_PACK_CACHE)))
    return pack


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 (round to nearest even) -> float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def pack_model(model, max_points: int = 4096, coarse_points: int = 512,
               fine_points: int = 1536) -> ModelPack:
    """Stage a CompiledModel's cloud for gather-free ranking (host numpy; the
    arithmetic of the JAX ``pack_model``, array for array).

    Models above ``max_points`` are voxel-downsampled to a coverage-uniform
    subsample.  Each 4-D block splits its representatives evenly between
    edge and surface points; its slack is the exact per-kind coverage radius,
    by which the ranking inflates its distance gate so that a pose scoring
    on the full model cannot miss on the block.  Edge points sit ``kind_off``
    away in the 4th coordinate, so a 4-D hit is an own-kind hit.
    """
    dev = model.cloud.device
    xyz = model.cloud.xyz.cpu().numpy().astype(np.float32)
    nrm = model.cloud.normal.cpu().numpy().astype(np.float32)
    mtan = model.cloud.tangent.cpu().numpy().astype(np.float32)
    valid = model.cloud.valid.cpu().numpy()
    if int(valid.sum()) > max_points:
        keep = _coverage_subsample(xyz, valid, max_points)
        xyz, nrm, mtan = xyz[keep], nrm[keep], mtan[keep]
        valid = np.ones(keep.size, bool)

    n = xyz.shape[0]
    n_pad = _round_up(n, 128)
    center = xyz[valid].mean(axis=0) if valid.any() else np.zeros(3, np.float32)
    xyz = np.where(valid[:, None], xyz - center, _FAR).astype(np.float32)
    is_edge = (np.linalg.norm(mtan, axis=-1) > 0.7) & valid  # impl/scene.hpp:470
    mref = np.where(is_edge[:, None], mtan, nrm)

    def padn(a, fill=0.0, to=n_pad):
        shape = (to - a.shape[0],) + a.shape[1:]
        return np.concatenate([a, np.full(shape, fill, a.dtype)], axis=0)

    xyz_p = padn(xyz, _FAR)
    mref_p = padn(mref)
    is_edge_p = padn(is_edge, False)
    mp2 = np.sum(xyz_p * xyz_p, axis=-1)
    zeros = np.zeros((n_pad,), np.float32)
    ch_d = np.stack([xyz_p[:, 0], xyz_p[:, 1], xyz_p[:, 2], mp2,
                     np.where(is_edge_p, 0.0, float(_BIG)), np.where(is_edge_p, float(_BIG), 0.0),
                     zeros, zeros], axis=0).astype(np.float32)
    ch_w = np.stack([zeros, zeros, zeros, zeros, zeros, mref_p[:, 0], mref_p[:, 1], mref_p[:, 2]],
                    axis=0).astype(np.float32)

    def block(pts):
        bp = _round_up(max(pts.shape[0], 1), 128)
        pts = padn(pts.astype(np.float32), _FAR, to=bp)
        z = np.zeros((bp,), np.float32)
        return np.stack([pts[:, 0], pts[:, 1], pts[:, 2], np.sum(pts * pts, axis=-1), z, z, z, z],
                        axis=0).astype(np.float32)

    edge_pts = xyz[valid & is_edge]
    surf_pts = xyz[valid & ~is_edge]

    def ref_block(refs):
        bp = _round_up(max(refs.shape[0], 1), 128)
        return np.ascontiguousarray(padn(refs.astype(np.float32), 0.0, to=bp).T)

    def coarse(pts, cap):
        if pts.shape[0] == 0:
            return pts, 0.0
        reps = pts[_coverage_subsample(pts, np.ones(pts.shape[0], bool), cap)]
        r = 0.0
        for s in range(0, pts.shape[0], 8192):
            d2 = ((pts[s:s + 8192][:, None, :] - reps[None, :, :]) ** 2).sum(-1)
            r = max(r, float(np.sqrt(d2.min(axis=1).max())))
        return reps, r

    # 4th-coordinate kind offset: a power of two >> the pack extent, so
    # cross-kind pairs sit off^2 apart and a plain 4-D hit is an own-kind hit
    ext = float(np.abs(xyz[valid]).max()) if valid.any() else 1.0
    off = float(2.0 ** np.ceil(np.log2(max(4.0 * ext, 1e-6))))

    def fourd_block(cap):
        edge_c, r_e = coarse(edge_pts, cap // 2)
        surf_c, r_s = coarse(surf_pts, cap // 2)
        nb = edge_c.shape[0] + surf_c.shape[0]
        nb_pad = _round_up(max(nb, 1), 128)
        c_xyz = padn(np.concatenate([edge_c, surf_c], axis=0).astype(np.float32), 0.0, to=nb_pad)
        c_w = padn(np.concatenate([np.full(edge_c.shape[0], off, np.float32),
                                   np.zeros(surf_c.shape[0], np.float32)]), 0.0, to=nb_pad)
        mp2 = np.sum(c_xyz * c_xyz, axis=-1) + c_w * c_w
        mp2[nb:] = 2.0 * float(_BIG)  # padded entries can never register a hit
        mp2_hi = _bf16_round(mp2)
        mp2_lo = mp2 - mp2_hi
        one = np.ones((nb_pad,), np.float32)
        md = np.stack([c_xyz[:, 0], c_xyz[:, 1], c_xyz[:, 2], c_w, mp2_hi, mp2_lo, one, one],
                      axis=0).astype(np.float32)
        return md, max(r_e, r_s), int(edge_c.shape[0]), nb

    md_coarse, slack_c, ne_c, nb_c = fourd_block(coarse_points)
    md_fine, slack_f, ne_f, nb_f = fourd_block(fine_points)
    center = center.astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return ModelPack(t(ch_d), t(ch_w), n_pad, t(center),
                     t(block(edge_pts)), t(block(surf_pts)), t(md_coarse),
                     float(np.float32(off)), float(np.float32(slack_c)), t(md_fine),
                     float(np.float32(slack_f)), int(edge_pts.shape[0]), int(surf_pts.shape[0]),
                     t(ref_block(mtan[valid & is_edge])), t(ref_block(nrm[valid & ~is_edge])),
                     tuple(float(c) for c in center), (ne_c, ne_f), (nb_c, nb_f))


def group_channels(scene, tangent_mask, consumed, nbr_idx, nbr_valid,
                   samples_on_all: bool = True) -> torch.Tensor:
    """Per-neighbour channel vectors, channels-LAST [..., K, 8]: 0-2 xyz (FAR
    when ineligible), 3 use_tangent, 4 eligibility, 5-7 ref vector."""
    xyz = scene.xyz[nbr_idx]
    use_tan = tangent_mask[nbr_idx]
    elig = nbr_valid & scene.valid[nbr_idx] & ~consumed[nbr_idx]
    if not samples_on_all:
        elig = elig & (torch.linalg.vector_norm(scene.tangent[nbr_idx], dim=-1) > 0.7)
    ref = torch.where(use_tan[..., None], scene.tangent[nbr_idx], scene.normal[nbr_idx])
    xyz = torch.where(elig[..., None], xyz, _FAR)
    return torch.cat([xyz, use_tan[..., None].to(torch.float32),
                      elig[..., None].to(torch.float32), ref], dim=-1)


def pack_groups(scene, tangent_mask, consumed, nbr_idx, nbr_valid,
                samples_on_all: bool = True) -> torch.Tensor:
    """Per-group scene neighbourhoods as [G, 8, K] channel planes."""
    ch = group_channels(scene, tangent_mask, consumed, nbr_idx, nbr_valid,
                        samples_on_all=samples_on_all)
    return ch.transpose(-1, -2).contiguous()


def poses_to_rows(ts: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 16] row-major (R rows, t, zero pad) kernel layout."""
    r = ts[..., :3, :3].reshape(*ts.shape[:-2], 9)
    pad = torch.zeros(ts.shape[:-2] + (4,), dtype=ts.dtype, device=ts.device)
    return torch.cat([r, ts[..., :3, 3], pad], dim=-1)


# ---------------------------------------------------------------------------
# B1: the coarse 4-D hit-count ranker
# ---------------------------------------------------------------------------


COARSE_RANK = LaunchCounter()


def _f32(x) -> float:
    return float(np.float32(x))


# the plain ranker sweeps this many representatives, and about this many
# (pose, point, rep) triples, at a time: its temporaries stay in cache
_PLAIN_REP_CHUNK = 16
_PLAIN_MAX_ELEMS = 1 << 21


def _coarse_hits(a: list, hi: torch.Tensor, lo: torch.Tensor, block: torch.Tensor, thres2: float,
                 thres2_strict: float, w_inf: float, w_str: float) -> torch.Tensor:
    """Per-pose score of the coarse rankers (B1, B4) from their operand:
    a = [-2tx, -2ty, -2tz, -2w] and |tp4|^2 = hi + lo, each [M, Hg, K].  The
    4-D squared distance to each representative is the kernel's 8-channel
    product accumulated in channel order with fused multiply-adds; per point
    its minimum, then ``w_inf * #(dmin <= thres2) + w_str * #(dmin <=
    thres2_strict)`` per pose ([M, Hg])."""
    a0, a3 = a[0][..., None], a[3][..., None]
    a1, a2 = a[1][..., None].double(), a[2][..., None].double()
    hi, lo = hi[..., None], lo[..., None]
    dmin = None
    for r0 in range(0, block.shape[1], _PLAIN_REP_CHUNK):
        m = block[:, r0:r0 + _PLAIN_REP_CHUNK]
        d = a0 * m[0]
        d = (a1 * m[1].double() + d).float()  # fused multiply-add, see fma32
        d = (a2 * m[2].double() + d).float()
        # channel 3: -2w * w_rep is 0 or -2 off^2 (off a power of two), exact
        # in float32, so its fused multiply-add is a plain add
        d = ((((d + a3 * m[3]) + m[4]) + m[5]) + hi) + lo  # [M, Hg, K, chunk]
        d = d.amin(-1)
        dmin = d if dmin is None else torch.minimum(dmin, d)
    hit = (dmin <= thres2).float() * w_inf + (dmin <= thres2_strict).float() * w_str
    return hit.sum(-1)


def _bf16_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = x.to(torch.bfloat16).float()
    return hi, x - hi


def _coarse_operand(groups: torch.Tensor, poses: torch.Tensor, off: float):
    """B1's operand of every (pose, point) pair in the TPU kernel's order of
    float32 operations: a = [-2tx, -2ty, -2tz, -2w] and |tp4|^2 (ineligible
    points +BIG), each [G, Hg, K].  groups [G, 8, K]; poses [G, Hg, 16]
    centre-shifted."""
    px, py, pz = (groups[:, None, c, :] for c in range(3))  # [G, 1, K]
    w = off * groups[:, None, 3, :]
    inelig = (1.0 - groups[:, None, 4, :]) * float(_BIG)
    q = [poses[:, :, i, None] for i in range(12)]  # [G, Hg, 1]
    tp = [fma32(q[3 * i + 2], pz, fma32(q[3 * i], px, q[3 * i + 1] * py)) + q[9 + i]
          for i in range(3)]
    tp2 = fma32(tp[2], tp[2], fma32(tp[0], tp[0], tp[1] * tp[1])) + w * w + inelig
    return [-2.0 * tp[0], -2.0 * tp[1], -2.0 * tp[2], (-2.0 * w).expand_as(tp2)], tp2


def score_groups_coarse_plain(groups: torch.Tensor, poses: torch.Tensor, block: torch.Tensor,
                              thres2: float, off: float, thres2_strict: float, w_inf: float,
                              w_str: float) -> torch.Tensor:
    """Plain PyTorch version of the coarse ranker, in the TPU kernel's order
    of float32 operations.

    groups [G, 8, K]; poses [G, Hg, 16] already centre-shifted; block
    [8, Nc].  Per pose: transform the K points, take the complete 4-D squared
    distance to each representative as the kernel's 8-channel product
    (channels [-2x, -2y, -2z, -2w, 1, 1, hi(|tp4|^2), lo(|tp4|^2)] against the
    block's rows, accumulated in channel order with fused multiply-adds), the
    per-point minimum, and the score
    ``w_inf * #(dmin <= thres2) + w_str * #(dmin <= thres2_strict)``.
    Ineligible points add +BIG to |tp4|^2.  Every representative is swept,
    as the TPU kernel sweeps them.  Returns [G, Hg] float32.
    """
    g, _, k = groups.shape
    hg = poses.shape[1]
    gc = max(1, _PLAIN_MAX_ELEMS // max(hg * k * _PLAIN_REP_CHUNK, 1))
    out = []
    for s in range(0, g, gc):
        a, tp2 = _coarse_operand(groups[s:s + gc], poses[s:s + gc], off)
        out.append(_coarse_hits(a, *_bf16_split(tp2), block, thres2, thres2_strict, w_inf,
                                w_str))
    return torch.cat(out)


def check_coarse_parity(got: torch.Tensor, ref: torch.Tensor, groups: torch.Tensor,
                        poses: torch.Tensor, block: torch.Tensor, thres2: float, off: float,
                        thres2_strict: float, strict_primary: bool,
                        atol: float = 0.0) -> tuple[float, int]:
    """Hold two coarse rankings of the same inputs to the B1 parity contract.

    Both counts (inflated and strict) must agree exactly, except that a pose
    may differ by as many points as it has points whose float64 4-D squared
    distance lies within 1e-5 of a gate (relative), or within ``atol`` of it:
    near a gate, two float32 sums taken in different orders may round to
    either side (``linear_band`` gives the ``atol`` of two rankings whose
    operands are built differently, B1 against B4).  Where the counts
    agree, the scores agree within K float32 ulps (the per-pose sum order).
    ``poses`` are centre-shifted kernel rows.  Raises AssertionError;
    returns (max |got - ref|, number of poses excused by near-gate points).
    """
    k = groups.shape[2]
    got, ref = got.double().cpu(), ref.double().cpu()

    def split(s):
        major = torch.floor(s)
        minor = torch.round((s - major) * (k + 1))
        return (minor, major) if strict_primary else (major, minor)

    (g_inf, g_str), (r_inf, r_str) = split(got), split(ref)
    diff = (g_inf - r_inf).abs() + (g_str - r_str).abs()
    bk = block.double().cpu()
    bk = bk[:, (bk[4] + bk[5]) < 1e11]  # padded representatives never hit
    excused = 0
    for g, h in (diff > 0).nonzero().tolist():
        q = poses[g, h].double().cpu()
        sc = groups[g].double().cpu()
        p = sc[:3].T @ q[:9].reshape(3, 3).T + q[9:12]
        w = off * sc[3]
        d2 = ((p[:, None, :] - bk[:3].T[None]) ** 2).sum(-1) + (w[:, None] - bk[3][None]) ** 2
        dmin = d2.min(1).values + (1.0 - sc[4]) * float(_BIG)
        near = (((dmin - thres2).abs() <= max(1e-5 * thres2, atol))
                | ((dmin - thres2_strict).abs() <= max(1e-5 * thres2_strict, atol)))
        if float(diff[g, h]) > 2 * int(near.sum()):
            raise AssertionError(f"pose ({g}, {h}): score {float(got[g, h])} vs "
                                 f"{float(ref[g, h])} with {int(near.sum())} near-gate points")
        excused += 1
    err = (got - ref).abs()
    tol = k * float(np.spacing(np.float32(k + 1)))
    worst = float(torch.where(diff == 0, err, 0.0).max()) if err.numel() else 0.0
    if worst > tol:
        raise AssertionError(f"fractional tiebreak differs by {worst} > K ulps ({tol})")
    return float(err.max()) if err.numel() else 0.0, excused


def kind_minima(groups: torch.Tensor, poses: torch.Tensor, block: torch.Tensor, off: float,
                group_chunk: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Float64 4-D minima of every eligible (pose, point) pair of a coarse
    ranking, over the real representatives of the point's own kind and over
    every real representative (own, best; flat).  A pair hits a gate only
    through the other kind where best <= gate < own: the checks of the coarse
    rankers' ``cross`` sweep count such pairs.  ``poses`` are centre-shifted
    kernel rows."""
    bk = block.double()
    bk = bk[:, (bk[4] + bk[5]) < 1e11]
    rep_edge = bk[3] != 0.0
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=groups.device)
    own, best = [], []
    for s in range(0, groups.shape[0], group_chunk):
        sc = groups[s:s + group_chunk].double()
        q = poses[s:s + group_chunk].double()
        p = torch.einsum("ghij,gjk->ghki", q[..., :9].unflatten(-1, (3, 3)), sc[:, :3])
        d2 = ((p + q[..., None, 9:12])[..., None, :] - bk[:3].T).square().sum(-1)
        d2 = d2 + (off * sc[:, 3][:, None, :, None] - bk[3]).square()  # [g, Hg, K, reps]
        same = (sc[:, 3] > 0.5)[:, None, :, None] == rep_edge
        el = (sc[:, 4] > 0.5)[:, None, :].expand(d2.shape[:3])
        own.append(torch.where(same, d2, inf).amin(-1)[el])
        best.append(d2.amin(-1)[el])
    return torch.cat(own), torch.cat(best)


def _cross_kind(thres2, thres2_strict, off) -> bool:
    """Whether a coarse kernel must also sweep the other kind: a gate at or
    above half the squared kind offset.  A cross-kind pair lies off^2 apart,
    and the half keeps the flag clear of the float32 rounding of the
    expanded distance."""
    return max(_f32(thres2), _f32(thres2_strict)) >= 0.5 * _f32(off) * _f32(off)


def _coarse_kernel_launch(name, load, counter, groups, poses, block, n_edge, n_reps, center,
                         thres2, off, thres2_strict, w_inf, w_str):
    """Launch B1's or B4's kernel (``csrc/<name>.cu``) on the current stream:
    uncentred pose rows, the centre as three floats, and the block's first
    ``n_reps`` columns, edge representatives first (``n_edge``).  The kernel
    sweeps each point's own kind, and with ``_cross_kind`` gates the other
    kind's too (``cross``, csrc/coarse_rank.cuh)."""
    for arg, t, dims in (("groups", groups, 3), ("poses", poses, 3), ("block", block, 2)):
        if (t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != dims
                or not t.is_contiguous()):
            raise ValueError(f"{arg}: need a contiguous float32 CUDA tensor of rank {dims}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    g, ch, k = groups.shape
    hg = poses.shape[1]
    ld = block.shape[1]
    if ch != 8 or poses.shape != (g, hg, 16) or block.shape[0] != 8:
        raise ValueError(f"shapes groups {tuple(groups.shape)} poses {tuple(poses.shape)} "
                         f"block {tuple(block.shape)}")
    if not (groups.device == poses.device == block.device):
        raise ValueError("groups, poses and block must share one device")
    if not (0 <= n_edge <= n_reps <= ld) or len(center) != 3:
        raise ValueError(f"representatives {n_edge} edge of {n_reps} in a block of {ld}, "
                         f"centre {center}")
    lib = load()
    out = torch.empty((g, hg), dtype=torch.float32, device=groups.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(groups.device).cuda_stream
    f = ctypes.c_float
    err = getattr(lib, f"{name}_launch")(
        groups.data_ptr(), poses.data_ptr(), block.data_ptr(), out.data_ptr(), g, hg, k, ld,
        n_edge, n_reps, *(f(c) for c in center), f(thres2), f(off), f(thres2_strict), f(w_inf),
        f(w_str), int(_cross_kind(thres2, thres2_strict, off)), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{getattr(lib, f'{name}_error_string')(err).decode()}")
    counter.launches += 1
    return out


def _coarse_launch(groups, poses, block, n_edge, n_reps, center, thres2, off, thres2_strict,
                   w_inf, w_str):
    """Launch ``csrc/coarse_rank.cu`` (B1) on the current stream (CUDA tensors
    only); ``poses`` are uncentred ``poses_to_rows`` rows."""
    return _coarse_kernel_launch("coarse_rank", load_coarse_rank, COARSE_RANK, groups, poses,
                                 block, n_edge, n_reps, center, thres2, off, thres2_strict,
                                 w_inf, w_str)


def _centre_shifted(mpack: ModelPack, poses: torch.Tensor) -> torch.Tensor:
    poses = poses.clone()
    poses[..., 9:12] -= mpack.center
    return poses


def _coarse_inputs(mpack: ModelPack, groups: torch.Tensor, dist_thres2, dist_thres2_strict,
                   block: str, strict_primary: bool):
    """The coarse rankers' (B1, B4) 4-D block, its edge and real
    representative counts, and scalar arguments (thres2, kind offset,
    thres2_strict, w_inf, w_str)."""
    if groups.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no coarse ranker for device {groups.device}")
    k = groups.shape[2]
    t2 = _f32(dist_thres2)
    t2s = t2 if dist_thres2_strict is None else _f32(dist_thres2_strict)
    frac = _f32(1.0 / (k + 1))
    w_inf, w_str = (frac, 1.0) if strict_primary else (1.0, frac)
    i = 0 if block == "coarse" else 1
    md = mpack.md_coarse if i == 0 else mpack.md_fine
    return md, mpack.n_edge_reps[i], mpack.n_reps[i], (t2, mpack.kind_off, t2s, w_inf, w_str)


def score_groups_coarse(mpack: ModelPack, groups: torch.Tensor, poses: torch.Tensor,
                        dist_thres2, dist_thres2_strict=None, *, block: str = "coarse",
                        strict_primary: bool = False) -> torch.Tensor:
    """Rank all G*Hg poses against one of the pack's 4-D blocks (TPU kernel B1).

    groups [G, 8, K]; poses [G, Hg, 16] (``poses_to_rows`` layout).  The score
    is ``count_inflated + count_strict/(K+1)``, or with ``strict_primary``
    ``count_strict + count_inflated/(K+1)``; ``dist_thres2`` is the
    slack-inflated gate and ``dist_thres2_strict`` (default: the same) the
    strict one.  A CUDA tensor runs the Hopper kernel (one launch, which
    shifts the poses by the centre itself), a CPU tensor the plain version.
    Returns [G, Hg] float32.
    """
    md, n_edge, n_reps, args = _coarse_inputs(mpack, groups, dist_thres2, dist_thres2_strict,
                                              block, strict_primary)
    if groups.device.type == "cuda":
        return _coarse_launch(groups, poses, md, n_edge, n_reps, mpack.center_xyz, *args)
    return score_groups_coarse_plain(groups, _centre_shifted(mpack, poses), md, *args)


# ---------------------------------------------------------------------------
# B4: the pose-linearised coarse ranker
# ---------------------------------------------------------------------------

COARSE_LINEAR_RANK = LaunchCounter()
_LIN_C = 7  # statics channels: [x, y, z, p2_hi, p2_lo, 1, w]


def coarse_linear_rows(poses: torch.Tensor) -> torch.Tensor:
    """Per-pose coefficient rows W [..., 8, 7] of the linearised coarse ranker
    (the JAX caller's ``wm``, score_pallas.py:1057-1077), from centre-shifted
    kernel rows [..., 16].

    Row i < 3 holds -2 R_i on the xyz statics and -2 t_i on the ones channel,
    row 3 -2 on w, rows 4 and 5 a 1 on the ones channel, row 6
    tp^2 = 2 p . R^T t + p2_hi + p2_lo + |t|^2; row 7 stays zero.  R^T t and
    |t|^2 are FMA chains in XLA's order, so the rows equal the JAX caller's
    bit for bit.  The plain version consumes these rows; the kernel builds
    the same rows from the pose itself.
    """
    r = poses[..., :9].unflatten(-1, (3, 3))
    t = poses[..., 9:12]
    rt_t = torch.stack([fma32(r[..., 2, i], t[..., 2], fma32(r[..., 1, i], t[..., 1],
                                                          r[..., 0, i] * t[..., 0]))
                        for i in range(3)], -1)
    t2n = fma32(t[..., 2], t[..., 2], fma32(t[..., 1], t[..., 1], t[..., 0] * t[..., 0]))
    wm = torch.zeros(poses.shape[:-1] + (8, _LIN_C), dtype=torch.float32, device=poses.device)
    wm[..., 0:3, 0:3] = -2.0 * r
    wm[..., 0:3, 5] = -2.0 * t
    wm[..., 3, 6] = -2.0
    wm[..., 4, 5] = 1.0
    wm[..., 5, 5] = 1.0
    wm[..., 6, 0:3] = 2.0 * rt_t
    wm[..., 6, 3] = 1.0
    wm[..., 6, 4] = 1.0
    wm[..., 6, 5] = t2n
    return wm


def score_groups_coarse_linear_plain(groups: torch.Tensor, wrows: torch.Tensor,
                                     block: torch.Tensor, thres2: float, off: float,
                                     thres2_strict: float, w_inf: float,
                                     w_str: float) -> torch.Tensor:
    """Plain PyTorch version of the linearised coarse ranker, in the TPU
    kernel's order of float32 operations.

    groups [G, 8, K]; wrows [G, Hg, 8, 7] (``coarse_linear_rows``); block
    [8, Nc].  Per group the statics S = [x, y, z, p2_hi, p2_lo, 1, w] with
    p2 = |p|^2 + w^2 + inelig split in bfloat16; per pose and point rows 0-3
    and 6 of A = W S, each an FMA chain over the 7 channels in channel order,
    row 6 (tp^2) split in bfloat16; then B1's sweep and score
    (``_coarse_hits``).  Returns [G, Hg] float32.
    """
    g, _, k = groups.shape
    hg = wrows.shape[1]
    gc = max(1, _PLAIN_MAX_ELEMS // max(hg * k * _PLAIN_REP_CHUNK, 1))
    out = []
    for s in range(0, g, gc):
        a, tp2 = _coarse_linear_operand(groups[s:s + gc], wrows[s:s + gc], off)
        out.append(_coarse_hits(a, *_bf16_split(tp2), block, thres2, thres2_strict, w_inf,
                                w_str))
    return torch.cat(out)


def _coarse_linear_operand(groups: torch.Tensor, wrows: torch.Tensor, off: float):
    """B4's operand of every (pose, point) pair: rows 0-3 of A = W S and row 6
    (|tp4|^2), each [G, Hg, K], from the statics S of ``groups`` [G, 8, K] and
    the coefficient rows ``wrows`` [G, Hg, 8, 7]."""
    x, y, z = (groups[:, None, c, :] for c in range(3))  # [G, 1, K]
    w = off * groups[:, None, 3, :]
    inelig = (1.0 - groups[:, None, 4, :]) * float(_BIG)
    p2 = fma32(z, z, fma32(x, x, y * y)) + w * w + inelig
    statics = [x, y, z, *_bf16_split(p2), torch.ones_like(x), w]

    def row(i):
        acc = wrows[:, :, i, 0, None] * statics[0]
        for c in range(1, _LIN_C):
            acc = fma32(wrows[:, :, i, c, None], statics[c], acc)
        return acc  # [G, Hg, K]

    return [row(i) for i in range(4)], row(6)


def linear_band(groups: torch.Tensor, poses: torch.Tensor, off: float,
                block: torch.Tensor) -> float:
    """An absolute bound on how far two coarse rankings of one (pose, point)
    pair may round apart when one builds its operand from the pose (B1) and
    the other from the linearised rows (B4): 64 float32 ulps of the largest
    squared magnitude either sums, (|p| + |t|)^2 + off^2 + the block's
    largest |p4|^2.  ``check_coarse_parity``'s ``atol`` for B4 against B1."""
    el = groups[:, 4] > 0.5
    p = torch.linalg.vector_norm(groups[:, :3], dim=1)
    pmax = float(torch.where(el, p, 0.0).max()) if el.any() else 0.0
    tmax = float(torch.linalg.vector_norm(poses[..., 9:12], dim=-1).max())
    real = (block[4] + block[5]) < 1e11
    m4 = float((block[4] + block[5])[real].max()) if real.any() else 0.0
    return 64.0 * float(np.finfo(np.float32).eps) * ((pmax + tmax) ** 2 + off * off + m4)


def _coarse_linear_launch(groups, poses, block, n_edge, n_reps, center, thres2, off,
                          thres2_strict, w_inf, w_str):
    """Launch ``csrc/coarse_linear_rank.cu`` (B4) on the current stream (CUDA
    tensors only); ``poses`` are uncentred ``poses_to_rows`` rows, from which
    the kernel builds the coefficient rows."""
    return _coarse_kernel_launch("coarse_linear_rank", load_coarse_linear_rank,
                                 COARSE_LINEAR_RANK, groups, poses, block, n_edge, n_reps, center,
                                 thres2, off, thres2_strict, w_inf, w_str)


def score_groups_coarse_linear(mpack: ModelPack, groups: torch.Tensor, poses: torch.Tensor,
                               dist_thres2, dist_thres2_strict=None, *, block: str = "coarse",
                               strict_primary: bool = False) -> torch.Tensor:
    """Linearised drop-in for :func:`score_groups_coarse` (TPU kernel B4): the
    same contract, arguments and output, with the operand built from
    per-pose coefficient rows (``coarse_linear_rows``) and per-point statics.
    A CUDA tensor runs the Hopper kernel (one launch, which builds the rows
    itself), a CPU tensor the plain version.  Returns [G, Hg] float32.
    """
    md, n_edge, n_reps, args = _coarse_inputs(mpack, groups, dist_thres2, dist_thres2_strict,
                                              block, strict_primary)
    if groups.device.type == "cuda":
        return _coarse_linear_launch(groups, poses, md, n_edge, n_reps, mpack.center_xyz, *args)
    wrows = coarse_linear_rows(_centre_shifted(mpack, poses))
    return score_groups_coarse_linear_plain(groups, wrows, md, *args)


# ---------------------------------------------------------------------------
# B2 and B3: the exact two-minimum rankers (count and full mode)
# ---------------------------------------------------------------------------

EXACT_RANK = LaunchCounter()
FULL_RANK = LaunchCounter()
# every launch counter, by the TPU kernel its kernel replaces
LAUNCH_COUNTERS = {"B1": COARSE_RANK, "B2": EXACT_RANK, "B3": FULL_RANK,
                   "B4": COARSE_LINEAR_RANK}
_TIE_EPS = np.float32(1e-6)  # the TPU kernel's argmin tie tolerance on E (params :578)
# shared memory one block may hold on an H100 (227 KB, cudaFuncSetAttribute)
_SMEM_MAX = 232448
# csrc/exact_rank.cuh: threads per block, the thread tile (poses x points of
# one kind), and the most pose tiles a block takes
EXACT_THREADS = 256
EXACT_TILE = (2, 4)
_EXACT_MAX_POSE_TILES = EXACT_THREADS


def exact_pose_tiles(g: int, hg: int, sms: int) -> int:
    """Pose tiles per block of B2 / B3 (``npt``, the block ranks ``npt *
    EXACT_TILE[0]`` poses): the largest power of two <= 256 that leaves no
    more than half of a block's poses past ``hg`` and puts at least two blocks
    on each of ``sms`` SMs (1 when nothing does)."""
    npt = _EXACT_MAX_POSE_TILES
    while npt > 1:
        pb = npt * EXACT_TILE[0]
        if pb // 2 < hg and g * -(-hg // pb) >= 2 * sms:
            break
        npt //= 2
    return npt


def exact_smem_bytes(full: bool, ne: int, ns: int, k: int, npt: int) -> int:
    """Dynamic shared memory of one B2 / B3 block (``exact_rank::Layout``): the
    blocks' columns, the eligible points (each kind padded to whole tiles) and,
    in full mode, the reference vectors of both, 16 bytes each; 48 bytes per
    pose; the survivor list of one round, 8 bytes per thread-tile entry, which
    at the end holds the per-(thread, pose) partials, 20 bytes each."""
    tp, tq = EXACT_TILE
    per = 2 if full else 1
    lst = max(8 * EXACT_THREADS * tp * tq, 20 * EXACT_THREADS * tp)
    return 16 * (per * (ne + ns + k + 2 * tq) + 3 * npt * tp) + lst


def _inv2t(thres2: float) -> float:
    """1 / (2 thres) in float32, as the TPU kernel's params: 0.5 / sqrt(max(t2, 1e-30))."""
    t2 = np.maximum(np.float32(thres2), np.float32(1e-30))
    return float(np.float32(0.5) / np.sqrt(t2))


def exact_blocks(mpack: ModelPack) -> tuple[torch.Tensor, torch.Tensor]:
    """The compact edge and surface blocks cut to their model points (views).

    The FAR padding columns of a block can never be an eligible point's
    nearest neighbour, so B2 and B3 sweep only real columns; a block without
    model points keeps one FAR column, which gates as no neighbour.
    """
    return (mpack.md_edge[:, :max(mpack.n_edge_cols, 1)],
            mpack.md_surf[:, :max(mpack.n_surf_cols, 1)])


def ref_blocks(mpack: ModelPack) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference vectors of ``exact_blocks``' columns (views), for B3."""
    return (mpack.mref_edge[:, :max(mpack.n_edge_cols, 1)],
            mpack.mref_surf[:, :max(mpack.n_surf_cols, 1)])


def _block_e(a: list, m: torch.Tensor) -> torch.Tensor:
    """E = -2 tp . m + |m|^2 against block columns m [8, C], in the TPU
    kernel's order: the channel product as a fused multiply-add chain
    (x, y, z), then |m|^2 added.  a: [-2tx, -2ty, -2tz], each [...];
    returns [..., C]."""
    e = a[0][..., None] * m[0]
    e = (a[1][..., None].double() * m[1].double() + e).float()  # fused multiply-add, see fma32
    e = (a[2][..., None].double() * m[2].double() + e).float()
    return e + m[3]


def _block_min(a: list, block: torch.Tensor) -> torch.Tensor:
    """Per-point min over a block's columns of ``_block_e``, [M, Hg]."""
    emin = None
    for r0 in range(0, block.shape[1], _PLAIN_REP_CHUNK):
        e = _block_e(a, block[:, r0:r0 + _PLAIN_REP_CHUNK]).amin(-1)
        emin = e if emin is None else torch.minimum(emin, e)
    return emin


def _orientation_weight(a: list, tr: list, thr: torch.Tensor, block: torch.Tensor,
                        refs: torch.Tensor) -> torch.Tensor:
    """B3's w_at_min for counted points: |mean over the tie set E <= thr of
    tr . mref| over one own-kind block (the mean divided in float32).  a, tr:
    lists of 3 [M]-tensors; thr [M]; block [8, C], refs [3, C]."""
    wsum = torch.zeros(thr.shape, dtype=torch.float64, device=thr.device)
    ties = torch.zeros(thr.shape, dtype=torch.int64, device=thr.device)
    for r0 in range(0, block.shape[1], _PLAIN_REP_CHUNK):
        sel = _block_e(a, block[:, r0:r0 + _PLAIN_REP_CHUNK]) <= thr[:, None]
        mr = refs[:, r0:r0 + _PLAIN_REP_CHUNK]
        w = fma32(tr[2][:, None], mr[2], fma32(tr[1][:, None], mr[1], tr[0][:, None] * mr[0]))
        wsum += torch.where(sel, w, 0.0).double().sum(-1)
        ties += sel.sum(-1)
    return (wsum.float() / torch.clamp(ties, min=1).float()).abs()


def score_groups_exact_plain(groups: torch.Tensor, poses: torch.Tensor, md_edge: torch.Tensor,
                             md_surf: torch.Tensor, thres2: float, inv2t: float,
                             weighted: bool = False,
                             negative: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the exact count ranker, in the TPU kernel's
    order of float32 operations.

    groups [G, 8, K]; poses [G, Hg, 16] already centre-shifted; md_edge
    [8, Ne] and md_surf [8, Ns] compact blocks.  Per pose and eligible point:
    tp = R p + t, d2 to each block = |tp|^2 + min_m(-2 tp . m + |m|^2), and
    the point counts when its own-kind d2 is within ``thres2`` and no larger
    than the other kind's.  ``weighted`` scores exp(-dk * inv2t) per counted
    point; ``negative`` subtracts exp(-do * inv2t) (or 1) per eligible point
    whose other-kind d2 is within the gate and smaller.  Ineligible points
    add nothing, so only eligible ones are evaluated.  Returns (score [G, Hg]
    float32, count [G, Hg] int32); without either knob the score is the count.
    """
    return _exact_plain(groups, poses, md_edge, md_surf, None, thres2, inv2t, weighted, negative)


def score_groups_full_plain(groups: torch.Tensor, poses: torch.Tensor, md_edge: torch.Tensor,
                            md_surf: torch.Tensor, mref_edge: torch.Tensor,
                            mref_surf: torch.Tensor, thres2: float, inv2t: float,
                            weighted: bool = False,
                            negative: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the orientation-weighted ranker (B3), in the
    TPU kernel's order of float32 operations.

    As ``score_groups_exact_plain``, with mref_edge [3, Ne] / mref_surf
    [3, Ns] the blocks' reference vectors.  Each counted point adds
    w_at_min (times exp(-dk * inv2t) when ``weighted``): the mean over the
    tie set of the own-kind model points whose E lies within 1e-6 of the
    own-kind minimum (the threshold rounded to float32) of tr . mref, with
    tr = R ref_point an FMA chain, taken as an absolute value.  Returns
    (score [G, Hg] float32, count [G, Hg] int32).
    """
    return _exact_plain(groups, poses, md_edge, md_surf, (mref_edge, mref_surf), thres2, inv2t,
                        weighted, negative)


def _exact_operand(p: torch.Tensor, q: list) -> tuple[list, torch.Tensor]:
    """-2 tp and |tp|^2 ([M, Hg] each) of eligible points p [M, 8] under the
    pose rows q (12 tensors [M, Hg], centre-shifted), in the TPU kernel's
    order of float32 operations."""
    px, py, pz = p[:, 0, None], p[:, 1, None], p[:, 2, None]
    tp = [fma32(q[3 * i + 2], pz, fma32(q[3 * i], px, q[3 * i + 1] * py)) + q[9 + i]
          for i in range(3)]
    tp2 = fma32(tp[2], tp[2], fma32(tp[0], tp[0], tp[1] * tp[1]))
    return [-2.0 * t for t in tp], tp2


def exact_pair_d2(groups: torch.Tensor, poses: torch.Tensor, md_edge: torch.Tensor,
                  md_surf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """Every (eligible point, pose) pair's own-kind and other-kind squared
    distance, in the plain version's arithmetic.

    groups [G, 8, K]; poses [G, Hg, 16] centre-shifted.  Returns (group index
    [M], point index [M], own-kind d2 [M, Hg], other-kind d2 [M, Hg]) over the
    M eligible points, group-major: what the survivor shares and the recounted
    bound of B2 / B3 are counted from."""
    gi, ki = (groups[:, 4] > 0.5).nonzero(as_tuple=True)
    pts = groups[gi, :, ki]
    own, other = [], []
    mc = max(1, _PLAIN_MAX_ELEMS // max(poses.shape[1] * _PLAIN_REP_CHUNK, 1))
    for s in range(0, pts.shape[0], mc):
        p, gs = pts[s:s + mc], gi[s:s + mc]
        a, tp2 = _exact_operand(p, [poses[gs, :, i] for i in range(12)])
        d2_e, d2_s = tp2 + _block_min(a, md_edge), tp2 + _block_min(a, md_surf)
        kind = (p[:, 3, None] > 0.5).expand_as(tp2)
        own.append(torch.where(kind, d2_e, d2_s))
        other.append(torch.where(kind, d2_s, d2_e))
    empty = poses.new_zeros((0, poses.shape[1]))
    return (gi, ki, torch.cat(own) if own else empty, torch.cat(other) if other else empty)


def _exact_plain(groups, poses, md_edge, md_surf, refs, thres2, inv2t, weighted, negative):
    g, _, k = groups.shape
    hg = poses.shape[1]
    gi, ki = (groups[:, 4] > 0.5).nonzero(as_tuple=True)
    pts = groups[gi, :, ki]  # [M, 8] eligible points, group-major
    count = torch.zeros((g, hg), dtype=torch.int32, device=groups.device)
    pos = torch.zeros((g, hg), dtype=torch.float64, device=groups.device)
    neg = torch.zeros_like(pos)
    signed = refs is not None or weighted or negative
    eps = torch.tensor(_TIE_EPS, device=groups.device)
    mc = max(1, _PLAIN_MAX_ELEMS // max(hg * _PLAIN_REP_CHUNK, 1))
    for s in range(0, pts.shape[0], mc):
        p, gs = pts[s:s + mc], gi[s:s + mc]
        q = [poses[gs, :, i] for i in range(12)]  # [mc, Hg]
        a, tp2 = _exact_operand(p, q)
        emin_e, emin_s = _block_min(a, md_edge), _block_min(a, md_surf)
        d2_e, d2_s = tp2 + emin_e, tp2 + emin_s
        kind = (p[:, 3, None] > 0.5).expand_as(tp2)
        dk = torch.where(kind, d2_e, d2_s)
        do = torch.where(kind, d2_s, d2_e)
        ok = (dk <= thres2) & (dk <= do)
        count.index_add_(0, gs, ok.to(torch.int32))
        if not signed:
            continue
        term = torch.exp(-dk * inv2t) if weighted else torch.ones_like(dk)
        if refs is not None:
            wam = torch.zeros_like(dk)
            thr = torch.where(kind, emin_e, emin_s) + eps
            for own, blk, ref in ((kind, md_edge, refs[0]), (~kind, md_surf, refs[1])):
                pi, hi = (ok & own).nonzero(as_tuple=True)
                if pi.numel() == 0:
                    continue
                qs = [qi[pi, hi] for qi in q[:9]]
                rx, ry, rz = p[pi, 5], p[pi, 6], p[pi, 7]
                tr = [fma32(qs[3 * i + 2], rz, fma32(qs[3 * i], rx, qs[3 * i + 1] * ry))
                      for i in range(3)]
                wam[pi, hi] = _orientation_weight([ai[pi, hi] for ai in a], tr, thr[pi, hi],
                                                  blk, ref)
            term = wam * term
        pos.index_add_(0, gs, torch.where(ok, term, 0.0).double())
        if negative:
            wrong = (do <= thres2) & (do < dk)
            w_neg = torch.exp(-do * inv2t) if weighted else torch.ones_like(do)
            neg.index_add_(0, gs, torch.where(wrong, w_neg, 0.0).double())
    score = (pos - neg).float() if signed else count.float()
    return score, count


def check_exact_parity(got: tuple, ref: tuple, groups: torch.Tensor, poses: torch.Tensor,
                       md_edge: torch.Tensor, md_surf: torch.Tensor,
                       thres2: float) -> tuple[float, int]:
    """Hold two exact rankings (score, count) of the same inputs to the B2
    parity contract.

    Counts must agree exactly, except that a pose may differ by as many
    points as it has eligible points whose float64 squared distance lies
    within 1e-5 * thres2 of the gate, or of the other kind's distance: near
    a gate, float32 sums taken in different orders may round to either side.
    Scores of poses without such points agree within 1e-5 relative (at least
    1e-5 absolute): the weighted terms are summed in different orders and
    ``expf`` differs from another exp in the last ulp.  ``poses`` are
    centre-shifted kernel rows; the blocks are those the rankings swept.
    Raises AssertionError; returns (max |score difference|, number of poses
    excused by near-gate points).
    """
    gs, gc = got[0].double().cpu(), got[1].long().cpu()
    rs, rc = ref[0].double().cpu(), ref[1].long().cpu()
    cdiff = (gc - rc).abs()
    sdiff = (gs - rs).abs()
    bad = (cdiff > 0) | (sdiff > 1e-5 * torch.clamp(rs.abs(), min=1.0))
    be, bs = md_edge.double().cpu(), md_surf.double().cpu()
    excused = 0
    for g, h in bad.nonzero().tolist():
        q = poses[g, h].double().cpu()
        sc = groups[g].double().cpu()
        el = sc[4] > 0.5
        p = sc[:3, el].T @ q[:9].reshape(3, 3).T + q[9:12]
        d2e = ((p[:, None, :] - be[:3].T[None]) ** 2).sum(-1).min(1).values
        d2s = ((p[:, None, :] - bs[:3].T[None]) ** 2).sum(-1).min(1).values
        tol = 1e-5 * thres2
        near = (((d2e - thres2).abs() <= tol) | ((d2s - thres2).abs() <= tol)
                | ((d2e - d2s).abs() <= tol))
        if int(cdiff[g, h]) > int(near.sum()) or int(near.sum()) == 0:
            raise AssertionError(f"pose ({g}, {h}): score {float(gs[g, h])} vs {float(rs[g, h])}, "
                                 f"count {int(gc[g, h])} vs {int(rc[g, h])} with "
                                 f"{int(near.sum())} near-gate points")
        excused += 1
    return (float(sdiff.max()) if sdiff.numel() else 0.0), excused


def _exact_launch(groups, poses, md_edge, md_surf, center, thres2, inv2t, weighted, negative,
                  refs=None):
    """Launch ``csrc/exact_rank.cu`` (B2), or with ``refs`` = (mref_edge,
    mref_surf) ``csrc/full_rank.cu`` (B3), on the current stream (CUDA
    tensors only): uncentred ``poses_to_rows`` rows and the centre as three
    floats, which the kernel subtracts itself."""
    named = [("groups", groups, 3), ("poses", poses, 3), ("md_edge", md_edge, 2),
             ("md_surf", md_surf, 2)]
    if refs is not None:
        named += [("mref_edge", refs[0], 2), ("mref_surf", refs[1], 2)]
    for name, t, dims in named:
        if t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != dims:
            raise ValueError(f"{name}: need a float32 CUDA tensor of rank {dims}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if t.device != groups.device:
            raise ValueError("groups, poses and blocks must share one device")
    if not (groups.is_contiguous() and poses.is_contiguous()):
        raise ValueError("groups and poses must be contiguous")
    g, ch, k = groups.shape
    hg = poses.shape[1]
    ne, ns = md_edge.shape[1], md_surf.shape[1]
    if ch != 8 or poses.shape != (g, hg, 16) or md_edge.shape[0] < 4 or md_surf.shape[0] < 4:
        raise ValueError(f"shapes groups {tuple(groups.shape)} poses {tuple(poses.shape)} "
                         f"md_edge {tuple(md_edge.shape)} md_surf {tuple(md_surf.shape)}")
    if refs is not None and (refs[0].shape[0] < 3 or refs[0].shape[1] != ne
                             or refs[1].shape[0] < 3 or refs[1].shape[1] != ns):
        raise ValueError(f"reference blocks {tuple(refs[0].shape)} {tuple(refs[1].shape)} do "
                         f"not match the blocks' {ne} / {ns} columns")
    if any(t.stride(1) != 1 for _, t, _ in named[2:]):
        raise ValueError("model blocks need unit column stride")
    if len(center) != 3:
        raise ValueError(f"centre {center}")
    score = torch.empty((g, hg), dtype=torch.float32, device=groups.device)
    count = torch.empty((g, hg), dtype=torch.int32, device=groups.device)
    if score.numel() == 0:
        return score, count
    npt = exact_pose_tiles(g, hg, _sm_count(groups.device))
    smem = exact_smem_bytes(refs is not None, ne, ns, k, npt)
    if smem > _SMEM_MAX:
        raise ValueError(f"{ne} + {ns} model points and K = {k} need {smem} bytes of shared "
                         f"memory per block, above the card's {_SMEM_MAX}: pack the model "
                         "with fewer max_points or rank fewer score_neighbors")
    stream = torch.cuda.current_stream(groups.device).cuda_stream
    f = ctypes.c_float
    head = (groups.data_ptr(), poses.data_ptr(), md_edge.data_ptr(), ne, md_edge.stride(0),
            md_surf.data_ptr(), ns, md_surf.stride(0))
    tail = (score.data_ptr(), count.data_ptr(), g, hg, k, npt, *(f(c) for c in center),
            f(thres2), f(inv2t))
    if refs is None:
        lib, name, counter = load_exact_rank(), "exact_rank", EXACT_RANK
        err = lib.exact_rank_launch(*head, *tail, int(weighted), int(negative), stream)
    else:
        lib, name, counter = load_full_rank(), "full_rank", FULL_RANK
        err = lib.full_rank_launch(*head, refs[0].data_ptr(), refs[0].stride(0),
                                   refs[1].data_ptr(), refs[1].stride(0), *tail,
                                   f(float(_TIE_EPS)), int(weighted), int(negative), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{getattr(lib, name + '_error_string')(err).decode()}")
    counter.launches += 1
    return score, count


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached per device)."""
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def score_groups_exact(mpack: ModelPack, groups: torch.Tensor, poses: torch.Tensor,
                       dist_thres2, *, mode: str = "count", weighted_distance: bool = False,
                       negative_scores: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-NN ranking of all G*Hg poses against the compact edge and surface
    blocks (``score_groups_pallas``): TPU kernel B2 in count mode, B3 in full
    mode.

    groups [G, 8, K]; poses [G, Hg, 16] (``poses_to_rows`` layout, shifted by
    ``-mpack.center`` in the kernel, or here before the plain version).
    Returns (score [G, Hg] float32, count [G, Hg] int32).  In count mode the
    score is the count, or with ``weighted_distance`` / ``negative_scores``
    the weighted/signed sum (impl/scene.hpp:468-475); in full mode every
    counted point's term is weighted by its orientation agreement with the
    nearest own-kind model point (impl/scene.hpp:469-489).  The count stays
    the plain correspondence count.  A CUDA tensor runs the Hopper kernel (one
    launch), a CPU tensor the plain version.
    """
    if mode not in ("count", "full"):
        raise ValueError(f"mode must be 'count' or 'full', got {mode!r}")
    t2 = _f32(dist_thres2)
    inv2t = _inv2t(t2)
    md_edge, md_surf = exact_blocks(mpack)
    refs = ref_blocks(mpack) if mode == "full" else None
    if groups.device.type == "cuda":
        return _exact_launch(groups, poses, md_edge, md_surf, mpack.center_xyz, t2, inv2t,
                             weighted_distance, negative_scores, refs)
    if groups.device.type != "cpu":
        raise ValueError(f"no exact ranker for device {groups.device}")
    return _exact_plain(groups, _centre_shifted(mpack, poses), md_edge, md_surf, refs, t2, inv2t,
                        weighted_distance, negative_scores)


# ---------------------------------------------------------------------------
# the ranking routes
# ---------------------------------------------------------------------------


def _inflate(thres2, slack: float) -> float:
    s = np.sqrt(np.float32(thres2)) + np.float32(slack)
    return float(np.float32(s * s))


def two_phase_keep(hg: int, keep_frac: int, pose_tile: int) -> int:
    """Poses per group that survive phase 1: 1/keep_frac of ``hg``, rounded up
    to whole pose tiles, at least one tile."""
    return max(pose_tile, -(-(hg // keep_frac) // pose_tile) * pose_tile)


def score_groups_two_phase(mpack: ModelPack, groups: torch.Tensor, poses: torch.Tensor,
                           dist_thres2, ok: torch.Tensor | None = None, *, mode: str = "count",
                           pose_tile: int = 8, coarse_stride: int = 8, keep_frac: int = 32,
                           coarse_model: bool = True, fine_stride: int = 1,
                           weighted_distance: bool = False, negative_scores: bool = False,
                           coarse_linear: bool = False, fine_coarse: bool = False,
                           fine_strict: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Early-drop analog: rank every pose on the strided subsample, keep the
    per-group top 1/keep_frac (at least ``pose_tile``), re-rank the survivors.

    Phase 1 sweeps the coarse 4-D block at the slack-inflated gate (B1, or
    B4 with ``coarse_linear``; ``coarse_model``) or the exact compact blocks
    at the strict gate (B2).  Phase 2 sweeps the fine 4-D block (B1 or B4,
    ``fine_coarse`` in count mode without the weighted/negative knobs) or
    the exact blocks in ``mode`` (B2 or B3, with both knobs passed through).
    Invalid hypotheses (``ok`` False) rank at -1 before the keep, so they
    never take a slot a valid pose needs; dropped poses score -1, or -BIG
    under ``negative_scores``, whose signed scores can fall below -1.
    Returns (scores, counts) [G, Hg].
    """
    g, hg = poses.shape[:2]
    keep = two_phase_keep(hg, keep_frac, pose_tile)
    coarse = groups[:, :, ::coarse_stride].contiguous()
    block_rank = score_groups_coarse_linear if coarse_linear else score_groups_coarse
    if coarse_model:
        s1 = block_rank(mpack, coarse, poses, _inflate(dist_thres2, mpack.coarse_slack),
                        dist_thres2)
    else:
        s1, _ = score_groups_exact(mpack, coarse, poses, dist_thres2)
    if ok is not None:
        s1 = torch.where(ok, s1, -1.0)
    # stable descending sort: equal scores keep index order, as lax.top_k does
    kept = torch.sort(s1, dim=1, descending=True, stable=True)[1][:, :keep]
    poses_kept = torch.gather(poses, 1, kept[..., None].expand(-1, -1, poses.shape[2]))
    fine_groups = groups if fine_stride == 1 else groups[:, :, ::fine_stride].contiguous()
    if fine_coarse and mode == "count" and not (weighted_distance or negative_scores):
        s2 = block_rank(mpack, fine_groups, poses_kept, _inflate(dist_thres2, mpack.fine_slack),
                        dist_thres2, block="fine", strict_primary=fine_strict)
        c2 = s2.to(torch.int64)
    else:
        s2, c2 = score_groups_exact(mpack, fine_groups, poses_kept, dist_thres2, mode=mode,
                                    weighted_distance=weighted_distance,
                                    negative_scores=negative_scores)
        c2 = c2.to(torch.int64)
    drop = -float(_BIG) if negative_scores else -1.0
    out = torch.full((g, hg), drop, device=poses.device).scatter(1, kept, s2)
    cnt = torch.zeros((g, hg), dtype=torch.int64, device=poses.device).scatter(1, kept, c2)
    if ok is not None:
        out = torch.where(ok, out, drop)
        cnt = torch.where(ok, cnt, 0)
    return out, cnt


def rank_groups(mpack: ModelPack, groups: torch.Tensor, rows: torch.Tensor, thres2,
                ok: torch.Tensor, policy) -> torch.Tensor:
    """Policy-driven ranking dispatch.

    The two-phase screen when it is ranking-safe for the configured
    semantics (K >= 256, neither ``weighted_distance`` nor
    ``negative_scores``: phase 1 keeps top optimistic counts, which do not
    bound a signed score from below); otherwise every pose is scored once by
    the exact ranker.  Returns [G, P] scores with invalid poses at -1, or at
    -1e12 under ``negative_scores``.
    """
    ks = groups.shape[-1]
    exact_semantics = policy.weighted_distance or policy.negative_scores
    if policy.early_drop and policy.two_phase_scoring and ks >= 256 and not exact_semantics:
        s_pl, _ = score_groups_two_phase(
            mpack, groups, rows, thres2, ok, mode=policy.ranking_mode,
            pose_tile=policy.two_phase_pose_tile, coarse_stride=policy.two_phase_stride,
            keep_frac=policy.two_phase_keep_frac, coarse_model=policy.two_phase_coarse_model,
            fine_stride=policy.two_phase_fine_stride,
            weighted_distance=policy.weighted_distance, negative_scores=policy.negative_scores,
            coarse_linear=policy.two_phase_coarse_linear,
            fine_coarse=policy.two_phase_fine_coarse, fine_strict=policy.two_phase_fine_strict)
    else:
        s_pl, _ = score_groups_exact(mpack, groups, rows, thres2, mode=policy.ranking_mode,
                                     weighted_distance=policy.weighted_distance,
                                     negative_scores=policy.negative_scores)
    invalid = -float(_BIG) if policy.negative_scores else -1.0
    return torch.where(ok, s_pl, invalid)
