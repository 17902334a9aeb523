"""Frozen copies of the scan generators and the pose arithmetic.

Copied from ``triplet_match_tpu_torch/io/synthetic.py`` and
``core/transforms.py`` (the recall protocol of ``scripts/recall_study.py``),
so that the yardstick stays fixed while the program changes.  ``tests/test_bench_frozen.py``
holds each copy bit for bit to the original.  Plain numpy, and torch on the
CPU for the pose error; nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np
import torch


def rotation_matrix(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    r = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)
    return r.astype(np.float32)


def make_box_model(n_edge: int = 400, n_face: int = 800, size=(1.0, 0.7, 0.4), seed: int = 0):
    """Box CAD model: edge points on the 12 edges (unit tangents along the
    edge, normals the mean of the two faces) and face points on the 6 faces.
    Returns (xyz, normal, tangent) float32 arrays."""
    rng = np.random.default_rng(seed)
    h = np.array([s / 2.0 for s in size], np.float32)
    edges = []
    for vary in range(3):
        fixed = [a for a in range(3) if a != vary]
        for s0 in (-1, 1):
            for s1 in (-1, 1):
                edges.append((vary, fixed, (s0, s1)))

    per_edge = max(n_edge // 12, 2)
    pts, tans, nrms = [], [], []
    for vary, fixed, (s0, s1) in edges:
        t = rng.uniform(-1, 1, per_edge)
        p = np.zeros((per_edge, 3), np.float32)
        p[:, vary] = t * h[vary]
        p[:, fixed[0]] = s0 * h[fixed[0]]
        p[:, fixed[1]] = s1 * h[fixed[1]]
        tg = np.zeros((per_edge, 3), np.float32)
        tg[:, vary] = 1.0
        nm = np.zeros((per_edge, 3), np.float32)
        nm[:, fixed[0]] = s0
        nm[:, fixed[1]] = s1
        nm /= np.linalg.norm(nm, axis=1, keepdims=True)
        pts.append(p)
        tans.append(tg)
        nrms.append(nm)

    per_face = max(n_face // 6, 2)
    for axis in range(3):
        others = [a for a in range(3) if a != axis]
        for sgn in (-1, 1):
            uv = rng.uniform(-1, 1, (per_face, 2))
            p = np.zeros((per_face, 3), np.float32)
            p[:, axis] = sgn * h[axis]
            p[:, others[0]] = uv[:, 0] * h[others[0]]
            p[:, others[1]] = uv[:, 1] * h[others[1]]
            nm = np.zeros((per_face, 3), np.float32)
            nm[:, axis] = sgn
            pts.append(p)
            tans.append(np.zeros((per_face, 3), np.float32))
            nrms.append(nm)

    xyz = np.concatenate(pts)
    return (xyz.astype(np.float32), np.concatenate(nrms).astype(np.float32),
            np.concatenate(tans).astype(np.float32))


def make_plane_patch(n: int, size, seed: int):
    """Planar patch in z=0 without border edges (the fog's patch)."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((n, 3), np.float32)
    xyz[:, 0] = rng.uniform(-size[0] / 2, size[0] / 2, n)
    xyz[:, 1] = rng.uniform(-size[1] / 2, size[1] / 2, n)
    normal = np.tile(np.array([0, 0, 1], np.float32), (n, 1))
    return xyz, normal


def fog_patches(rng, n_clutter: int, seed_base: int, n_per: int = 2000, size=(1.5, 1.5),
                extent: float = 5.0):
    """Touching surface clutter: plane patches placed uniformly in a
    +-extent cube, free to touch, cross or overlap the instances.
    Returns (xyz, normals) [n_clutter, 3], tangent-free."""
    patches = []
    for i in range(max(-(-n_clutter // n_per), 1)):
        pxyz, pn = make_plane_patch(n_per, size, seed_base + i)
        rr = rotation_matrix(rng.normal(size=3), rng.uniform(0, np.pi))
        tt = rng.uniform(-extent, extent, 3).astype(np.float32)
        patches.append(((pxyz @ rr.T + tt).astype(np.float32), (pn @ rr.T).astype(np.float32)))
    cx = np.concatenate([p[0] for p in patches])[:n_clutter]
    cn = np.concatenate([p[1] for p in patches])[:n_clutter]
    return cx, cn


def _rigid_np(r, t) -> np.ndarray:
    tg = np.eye(4, dtype=np.float32)
    tg[:3, :3] = r
    tg[:3, 3] = t
    return tg


def recall_scene_arrays(n_points: int, seed: int, arrays):
    """The recall protocol's touching-fog scene (``recall_study.build_scene``):
    the model instance at a random pose with 1 mm noise, then fog patches up
    to ``n_points``.  Returns (xyz, normal, tangent, t_gt model -> scene)."""
    xyz, nrm, tan = arrays
    rngc = np.random.default_rng(1000 + seed)
    r_inst = rotation_matrix(rngc.normal(size=3), rngc.uniform(0, np.pi))
    t_off = rngc.uniform(-1.5, 1.5, 3).astype(np.float32)
    c_xyz, c_nrm = fog_patches(rngc, n_points - xyz.shape[0], seed_base=5000 + 100 * seed)
    s_xyz = np.concatenate([
        xyz @ r_inst.T + t_off + rngc.normal(0, 0.001, xyz.shape).astype(np.float32), c_xyz])
    s_nrm = np.concatenate([nrm @ r_inst.T, c_nrm])
    s_tan = np.concatenate([tan @ r_inst.T, np.zeros_like(c_xyz)])
    return s_xyz, s_nrm, s_tan, _rigid_np(r_inst, t_off)


def _rigid(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(r.shape[:-2] + (4, 4), dtype=r.dtype, device=r.device)
    out[..., :3, :3] = r
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def invert_rigid(t: torch.Tensor) -> torch.Tensor:
    rt = t[..., :3, :3].transpose(-1, -2)
    return _rigid(rt, -(rt @ t[..., :3, 3:4])[..., 0])


def pose_delta(t_a: torch.Tensor, t_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(translation delta, rotation delta radians) between two rigid poses."""
    d = invert_rigid(t_a) @ t_b
    r = d[..., :3, :3]
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    return (torch.linalg.vector_norm(d[..., :3, 3], dim=-1),
            torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)))


def sym_pose_error(transform, t_gt) -> tuple[float, float, int]:
    """(metres, degrees, k) pose error against the best box-symmetry-equivalent
    ground truth: the box's {I, Rx(pi), Ry(pi), Rz(pi)} poses (k = 0..3) are
    the same match, since pair features cannot tell them apart.  Ranked by
    dt + 0.01 * deg, as the baseline scripts do.  float32 on the CPU."""
    best = (np.inf, np.inf, 0)
    t = torch.as_tensor(np.asarray(transform, np.float32))
    for k, axis in enumerate([None, [1, 0, 0], [0, 1, 0], [0, 0, 1]]):
        tg = np.asarray(t_gt, np.float32).copy()
        if axis is not None:
            tg[:3, :3] = tg[:3, :3] @ rotation_matrix(axis, np.pi)
        dt, dr = pose_delta(t, torch.as_tensor(tg))
        dt, dr = float(dt), float(np.degrees(float(dr)))
        if dt + 0.01 * dr < best[0] + 0.01 * best[1]:
            best = (dt, dr, k)
    return best
