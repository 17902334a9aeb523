"""Synthetic clouds for tests, benchmarks and the chip smoke run.

jax-free copies of the generators in ``triplet_match_tpu.io.synthetic``
(the same numpy draws, so the same clouds bit for bit), plus the recall
protocol of ``scripts/recall_study.py``, its model families
(``model_arrays``) and its touching-fog scene (``recall_scene``), and
``sym_delta``, the box-symmetry-aware pose error of
``scripts/run_baseline_configs.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.core.transforms import pose_delta


def rotation_matrix(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    r = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)
    return r.astype(np.float32)


def make_box_model(n_edge: int = 400, n_face: int = 800, size=(1.0, 0.7, 0.4), seed: int = 0,
                   jitter: float = 0.0):
    """Box "CAD model": edge points on the 12 edges (unit tangents along the
    edge, normals the mean of the two faces) + surface points on the 6 faces.

    Returns (xyz, normal, tangent) float32 arrays.
    """
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
    if jitter > 0:
        xyz = xyz + rng.normal(0, jitter, xyz.shape).astype(np.float32)
    return (xyz.astype(np.float32), np.concatenate(nrms).astype(np.float32),
            np.concatenate(tans).astype(np.float32))


def make_plane_patch(n: int = 2000, size=(2.0, 2.0), seed: int = 1, border_edges: bool = True):
    """Planar patch in z=0 with optional edge-tangent border points."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((n, 3), np.float32)
    xyz[:, 0] = rng.uniform(-size[0] / 2, size[0] / 2, n)
    xyz[:, 1] = rng.uniform(-size[1] / 2, size[1] / 2, n)
    normal = np.tile(np.array([0, 0, 1], np.float32), (n, 1))
    tangent = np.zeros((n, 3), np.float32)
    if border_edges:
        nb = n // 5
        for i, (axis, sgn) in enumerate([(0, -1), (0, 1), (1, -1), (1, 1)]):
            sl = slice(i * nb // 4, (i + 1) * nb // 4)
            xyz[sl, axis] = sgn * size[axis] / 2
            tangent[sl, 1 - axis] = 1.0
    return xyz, normal, tangent


def fog_patches(rng, n_clutter: int, seed_base: int, n_per: int = 2000, size=(1.5, 1.5),
                extent: float = 5.0):
    """Touching surface clutter: plane patches placed uniformly in a
    +-extent cube, free to touch, cross or overlap the instances.

    Returns (xyz [n_clutter, 3], normals [n_clutter, 3]), tangent-free.
    """
    patches = []
    for i in range(max(-(-n_clutter // n_per), 1)):
        pxyz, pn, _ = make_plane_patch(n=n_per, size=size, seed=seed_base + i, border_edges=False)
        rr = rotation_matrix(rng.normal(size=3), rng.uniform(0, np.pi))
        tt = rng.uniform(-extent, extent, 3).astype(np.float32)
        patches.append(((pxyz @ rr.T + tt).astype(np.float32), (pn @ rr.T).astype(np.float32)))
    cx = np.concatenate([p[0] for p in patches])[:n_clutter]
    cn = np.concatenate([p[1] for p in patches])[:n_clutter]
    return cx, cn


def embed_in_scene(model_xyz, model_normal, model_tangent, *, rotation=None, translation=None,
                   noise: float = 0.0, n_clutter: int = 0, clutter_extent: float = 4.0,
                   seed: int = 7, capacity: int | None = None, device="cuda"):
    """Place a transformed copy of the model into a cluttered scene.

    Returns (scene PointCloud on ``device``, t_model_to_scene [4, 4] float32,
    instance_mask).
    """
    rng = np.random.default_rng(seed)
    r = rotation if rotation is not None else rotation_matrix(rng.normal(size=3),
                                                               rng.uniform(0, np.pi))
    t = translation if translation is not None else rng.uniform(-1, 1, 3).astype(np.float32)
    r = np.asarray(r, np.float32)
    t = np.asarray(t, np.float32)
    xyz = model_xyz @ r.T + t
    if noise > 0:
        xyz = xyz + rng.normal(0, noise, xyz.shape).astype(np.float32)
    normal = model_normal @ r.T
    tangent = model_tangent @ r.T
    if n_clutter > 0:
        cx = rng.uniform(-clutter_extent / 2, clutter_extent / 2, (n_clutter, 3)).astype(np.float32)
        cn = rng.normal(size=(n_clutter, 3)).astype(np.float32)
        cn /= np.linalg.norm(cn, axis=1, keepdims=True)
        xyz = np.concatenate([xyz, cx])
        normal = np.concatenate([normal, cn])
        tangent = np.concatenate([tangent, np.zeros((n_clutter, 3), np.float32)])
    inst = np.zeros(xyz.shape[0], bool)
    inst[: model_xyz.shape[0]] = True
    tm = np.eye(4, dtype=np.float32)
    tm[:3, :3] = r
    tm[:3, 3] = t
    return PointCloud.from_arrays(xyz, normal, tangent, capacity=capacity, device=device), tm, inst


def recall_box_model():
    """The recall protocol's box model: 600 edge + 1800 face points."""
    return make_box_model(n_edge=600, n_face=1800, size=(1.0, 0.8, 0.6), seed=0)


def make_lattice_model(cells: int = 4, n_edge: int = 20000, size: float = 1.0, seed: int = 0,
                       jitter: float = 0.0, graded: bool = False):
    """Wireframe lattice "scaffold" model: every point is an edge point, on the
    axis-aligned beams of a (cells x cells x cells) grid, tangents along the
    beam, normals radial.  ``graded`` spaces the grid planes geometrically,
    which breaks the lattice's self-symmetries.

    Returns (xyz, normal, tangent) float32 arrays with ~n_edge points.
    """
    rng = np.random.default_rng(seed)
    if graded:
        u = np.geomspace(1.0, 2.0, cells + 1)
        lin = (size * (u - u[0]) / (u[-1] - u[0]) - size / 2).astype(np.float32)
    else:
        lin = np.linspace(-size / 2, size / 2, cells + 1).astype(np.float32)

    beams = []  # (vary axis, fixed axes, fixed coords)
    for vary in range(3):
        fixed = [a for a in range(3) if a != vary]
        for fa in lin:
            for fb in lin:
                beams.append((vary, fixed, fa, fb))
    per_beam = max(n_edge // len(beams), 2)

    pts, tans, nrms = [], [], []
    for vary, fixed, fa, fb in beams:
        t = rng.uniform(-size / 2, size / 2, per_beam).astype(np.float32)
        p = np.zeros((per_beam, 3), np.float32)
        p[:, vary] = t
        p[:, fixed[0]] = fa
        p[:, fixed[1]] = fb
        tg = np.zeros((per_beam, 3), np.float32)
        tg[:, vary] = 1.0
        theta = rng.uniform(0, 2 * np.pi, per_beam).astype(np.float32)
        nm = np.zeros((per_beam, 3), np.float32)
        nm[:, fixed[0]] = np.cos(theta)
        nm[:, fixed[1]] = np.sin(theta)
        pts.append(p)
        tans.append(tg)
        nrms.append(nm)

    xyz = np.concatenate(pts)
    tangent = np.concatenate(tans)
    normal = np.concatenate(nrms)
    if jitter > 0:
        xyz = xyz + rng.normal(0, jitter, xyz.shape).astype(np.float32)
    return xyz.astype(np.float32), normal.astype(np.float32), tangent.astype(np.float32)


def model_arrays(kind: str = "box"):
    """The recall protocol's model families (``scripts/recall_study.py
    --model``): ``box`` (600 edge + 1800 face points), ``low-edge`` (120 +
    2280) and ``lattice`` (the graded 20000-point scaffold)."""
    if kind == "box":
        return recall_box_model()
    if kind == "low-edge":
        return make_box_model(n_edge=120, n_face=2280, size=(1.0, 0.8, 0.6), seed=0)
    if kind == "lattice":
        return make_lattice_model(cells=4, n_edge=20000, graded=True, seed=0)
    raise ValueError(f"unknown model kind {kind!r}")


def recall_scene_arrays(n_points: int, seed: int, arrays=None):
    """Numpy arrays of the touching-fog recall-protocol scene
    (``scripts/recall_study.build_scene``, bit for bit): the box instance at a
    random pose with 1 mm noise, then fog patches up to ``n_points``.

    Returns (xyz, normal, tangent, t_gt [4, 4] model -> scene).
    """
    xyz, nrm, tan = arrays if arrays is not None else recall_box_model()
    rngc = np.random.default_rng(1000 + seed)
    r_inst = rotation_matrix(rngc.normal(size=3), rngc.uniform(0, np.pi))
    t_off = rngc.uniform(-1.5, 1.5, 3).astype(np.float32)
    c_xyz, c_nrm = fog_patches(rngc, n_points - xyz.shape[0], seed_base=5000 + 100 * seed)
    s_xyz = np.concatenate([
        xyz @ r_inst.T + t_off + rngc.normal(0, 0.001, xyz.shape).astype(np.float32), c_xyz])
    s_nrm = np.concatenate([nrm @ r_inst.T, c_nrm])
    s_tan = np.concatenate([tan @ r_inst.T, np.zeros_like(c_xyz)])
    t_gt = np.eye(4, dtype=np.float32)
    t_gt[:3, :3] = r_inst
    t_gt[:3, 3] = t_off
    return s_xyz, s_nrm, s_tan, t_gt


def recall_scene(n_points: int, seed: int, arrays=None, device="cuda"):
    """The recall-protocol scene as a PointCloud on ``device``: (cloud, t_gt)."""
    s_xyz, s_nrm, s_tan, t_gt = recall_scene_arrays(n_points, seed, arrays)
    return PointCloud.from_arrays(s_xyz, s_nrm, s_tan, device=device), t_gt


def sym_delta(transform, t_gt) -> tuple[float, float]:
    """(metres, degrees) pose error against the best box-symmetry-equivalent
    ground truth: the box's {I, Rx(pi), Ry(pi), Rz(pi)} poses are the same
    match (pair features cannot tell them apart).  Ranked by
    dt + 0.01 * deg, as the baseline scripts do."""
    best = (np.inf, np.inf)
    t = torch.as_tensor(np.asarray(transform, np.float32))
    for axis in [None, [1, 0, 0], [0, 1, 0], [0, 0, 1]]:
        tg = np.asarray(t_gt, np.float32).copy()
        if axis is not None:
            tg[:3, :3] = tg[:3, :3] @ rotation_matrix(axis, np.pi)
        dt, dr = pose_delta(t, torch.as_tensor(tg))
        dt, dr = float(dt), float(np.degrees(float(dr)))
        if dt + 0.01 * dr < best[0] + 0.01 * best[1]:
            best = (dt, dr)
    return best
