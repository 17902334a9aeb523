"""Synthetic clouds for tests, benchmarks and the chip smoke run.

jax-free copies of the generators in ``triplet_match_tpu.io.synthetic``
(the same numpy draws, so the same clouds bit for bit), plus the recall
protocol of ``scripts/recall_study.py``, its model families
(``model_arrays``) and its touching-fog scene (``recall_scene``), the
scenes of the BASELINE configs (``baseline_*_arrays``, from
``scripts/run_baseline_configs.py``), and ``sym_delta``, that script's
box-symmetry-aware pose error.
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


def make_cylinder(n: int = 3000, radius: float = 0.5, height: float = 2.0, seed: int = 2,
                  rim_edges: bool = True):
    """Cylinder barrel about z with optional rim edge points (tangent along
    the rim): the first n // 5 points sit on the two rims."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-height / 2, height / 2, n)
    xyz = np.stack([radius * np.cos(theta), radius * np.sin(theta), z], 1).astype(np.float32)
    normal = np.stack([np.cos(theta), np.sin(theta), np.zeros_like(theta)], 1).astype(np.float32)
    tangent = np.zeros((n, 3), np.float32)
    if rim_edges:
        nb = n // 5
        for i, sgn in enumerate([-1, 1]):
            sl = slice(i * nb // 2, (i + 1) * nb // 2)
            xyz[sl, 2] = sgn * height / 2
            tangent[sl, 0] = -np.sin(theta[sl])
            tangent[sl, 1] = np.cos(theta[sl])
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


def baseline_plane_arrays():
    """BASELINE config 1 (``scripts/run_baseline_configs.py`` config1_plane,
    bit for bit): a 6000-point 2 x 2 m plane patch under a pose with 2 mm
    noise, then 4000 uniform clutter points.  Returns (xyz, normal, n_plane)."""
    rng = np.random.default_rng(42)
    pxyz, pn, _ = make_plane_patch(n=6000, size=(2.0, 2.0), seed=1)
    r = rotation_matrix([0.4, 1.0, 0.2], 0.7)
    pxyz = (pxyz @ r.T + np.array([0.3, -0.5, 1.2], np.float32))
    pxyz += rng.normal(0, 0.002, pxyz.shape).astype(np.float32)
    clutter = rng.uniform(-3, 3, (4000, 3)).astype(np.float32)
    cn = rng.normal(size=(4000, 3)).astype(np.float32)
    cn /= np.linalg.norm(cn, axis=1, keepdims=True)
    return np.concatenate([pxyz, clutter]), np.concatenate([pn @ r.T, cn]), 6000


def baseline_cylinder_arrays():
    """BASELINE config 2 (config2_cylinder, bit for bit): an 8000-point
    cylinder barrel of radius 0.35 m under a pose with 2 mm noise, then 4000
    uniform clutter points.  Returns (xyz, normal, n_cylinder)."""
    rng = np.random.default_rng(7)
    cxyz, cn, _ = make_cylinder(n=8000, radius=0.35, height=1.5, seed=2, rim_edges=False)
    r = rotation_matrix([1, 0.3, 0.5], 1.3)
    x = (cxyz @ r.T + np.array([0.5, 1.0, -0.2], np.float32))
    x += rng.normal(0, 0.002, x.shape).astype(np.float32)
    clutter = rng.uniform(-3, 3, (4000, 3)).astype(np.float32)
    kn = rng.normal(size=(4000, 3)).astype(np.float32)
    kn /= np.linalg.norm(kn, axis=1, keepdims=True)
    return np.concatenate([x, clutter]), np.concatenate([cn @ r.T, kn]), 8000


def _rigid_np(r, t) -> np.ndarray:
    tg = np.eye(4, dtype=np.float32)
    tg[:3, :3] = r
    tg[:3, 3] = t
    return tg


def baseline_match_arrays(n_clutter: int, two_models: bool = False):
    """BASELINE configs 3-5 (``_match_config``, bit for bit): box model A
    (1.0 x 0.8 x 0.6 m, 600 edge + 1800 face points) and, with
    ``two_models``, box model B (1.3 x 0.45 x 0.85 m, seed 50), each planted
    once with 1 mm noise ahead of ``n_clutter`` points of fog patches.
    Returns ([(xyz, normal, tangent)] per model, (xyz, normal, tangent) of
    the scene, [t_gt] per model)."""
    specs = [((1.0, 0.8, 0.6), 0, np.array([0.0, 0.0, 0.0], np.float32),
              rotation_matrix([0.3, 1.0, 0.2], 1.1))]
    if two_models:
        specs.append(((1.3, 0.45, 0.85), 50, np.array([2.6, 2.4, 0.3], np.float32),
                      rotation_matrix([0.9, -0.2, 0.4], 2.0)))
    models = [make_box_model(n_edge=600, n_face=1800, size=size, seed=seed)
              for size, seed, _, _ in specs]
    rngc = np.random.default_rng(17)
    c_xyz, c_nrm = fog_patches(rngc, n_clutter, seed_base=100)
    parts = [(xyz @ r.T + t + rngc.normal(0, 0.001, xyz.shape).astype(np.float32), nrm @ r.T,
              tan @ r.T) for (xyz, nrm, tan), (_, _, t, r) in zip(models, specs)]
    scene = (np.concatenate([p[0] for p in parts] + [c_xyz]),
             np.concatenate([p[1] for p in parts] + [c_nrm]),
             np.concatenate([p[2] for p in parts] + [np.zeros_like(c_xyz)]))
    return models, scene, [_rigid_np(r, t) for _, _, t, r in specs]


# config 5's camera origins (run_baseline_configs.py _match_config)
BASELINE_ORIGINS = np.array([[1.8, 0, 0.6], [-1.8, 0, 0.6], [0, 1.8, 0.6], [0, -1.8, 0.6],
                             [2.6, 2.4, 2.2]], np.float32)


def baseline_two_instances_arrays(n_points: int = 131072):
    """BASELINE config 6 (config6_two_instances, bit for bit): two instances
    of box model A with 1 mm noise in fog patches up to ``n_points``.
    Returns ((xyz, normal, tangent) of the model, of the scene, [t_gt] per
    instance)."""
    xyz, nrm, tan = make_box_model(n_edge=600, n_face=1800, size=(1.0, 0.8, 0.6), seed=0)
    rngc = np.random.default_rng(77)
    insts = []
    for off in [(-2.2, -1.5, 0.0), (2.0, 1.8, 0.5)]:
        r = rotation_matrix(rngc.normal(size=3), rngc.uniform(0, np.pi))
        insts.append((r, np.array(off, np.float32)))
    cx, cn = fog_patches(rngc, n_points - 2 * xyz.shape[0], seed_base=900)
    sx = np.concatenate([xyz @ r.T + t + rngc.normal(0, 0.001, xyz.shape).astype(np.float32)
                         for r, t in insts] + [cx])
    sn = np.concatenate([nrm @ r.T for r, _ in insts] + [cn])
    st = np.concatenate([tan @ r.T for r, _ in insts] + [np.zeros_like(cx)])
    return (xyz, nrm, tan), (sx, sn, st), [_rigid_np(r, t) for r, t in insts]


def sym_pose_error(transform, t_gt) -> tuple[float, float, int]:
    """(metres, degrees, k) pose error against the best box-symmetry-
    equivalent ground truth: the box's {I, Rx(pi), Ry(pi), Rz(pi)} poses
    (k = 0..3) are the same match (pair features cannot tell them apart).
    Ranked by dt + 0.01 * deg, as the baseline scripts do."""
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


def sym_delta(transform, t_gt) -> tuple[float, float]:
    """(metres, degrees) of ``sym_pose_error``."""
    return sym_pose_error(transform, t_gt)[:2]
