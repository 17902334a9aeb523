"""Model compilation: voxel LUT + sorted pair-feature table (counterpart of
``triplet_match_tpu.index.model``; ``model<Point>::init``, impl/model.hpp:15-192).

* The dense voxel LUT maps every voxel of the model's bounding volume to its
  nearest model point: one batched 1-NN of voxel centres against the cloud.
* The ``unordered_multimap<discrete_feature, (i, j)>`` becomes a sorted key
  table queried by ``searchsorted`` plus a bounded even-stride gather.

Grids above ``_LUT_JFA_THRESHOLD`` voxels build the LUT by jump flood
(``ops/jfa.nearest_point_volume``), as the JAX package does; smaller ones by
the exact brute 1-NN.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from triplet_match_tpu_torch.config import (
    DEFAULT_DISCRETIZATION,
    DEFAULT_POLICY,
    DEFAULT_SAMPLE_PARAMS,
    DiscretizationParams,
    SampleParams,
    SearchPolicy,
)
from triplet_match_tpu_torch.core import cloud as cl
from triplet_match_tpu_torch.core.transforms import strict_fp32
from triplet_match_tpu_torch.features import discretize as dz
from triplet_match_tpu_torch.features import pairfeat as pf
from triplet_match_tpu_torch.ops import knn as knn_ops
from triplet_match_tpu_torch.ops.jfa import nearest_point_volume
from triplet_match_tpu_torch.ops.curvature import edge_mask as edge_mask_op
from triplet_match_tpu_torch.ops.curvature import principal_curvatures

_INVALID_KEY = 0xFFFFFFFF
# voxels above which the LUT builds by jump flood instead of brute 1-NN
_LUT_JFA_THRESHOLD = 2_000_000
_MAX_LUT_VOXELS = 134_217_728


@dataclasses.dataclass(frozen=True)
class CompiledModel:
    """Compiled model index; fields as in the JAX ``CompiledModel``.

      cloud:      the finite-filtered model cloud.
      resolution, diameter: 0-d float32 tensors.
      to_voxel:   [4, 4] affine world -> voxel.
      lut:        [ex, ey, ez] int64 nearest model point per voxel.
      edge:       [N] bool edge-point mask.
      bounds_min/bounds_max: [4] feature bounds.
      keys:       [P] int64 sorted packed keys (0xFFFFFFFF = invalid, at the tail).
      pairs:      [P, 2] int64 (i, j) model point indices, co-sorted.
      pair_count, n_edge, n_all: 0-d int64 tensors.
      margin:     voxel margin (5, impl/model.hpp:48).
    """

    cloud: cl.PointCloud
    resolution: torch.Tensor
    diameter: torch.Tensor
    to_voxel: torch.Tensor
    lut: torch.Tensor
    edge: torch.Tensor
    bounds_min: torch.Tensor
    bounds_max: torch.Tensor
    keys: torch.Tensor
    pairs: torch.Tensor
    pair_count: torch.Tensor
    n_edge: torch.Tensor
    n_all: torch.Tensor
    margin: int

    @property
    def extents(self) -> tuple[int, int, int]:
        return tuple(self.lut.shape)


def compiled_model_from_numpy(d, device="cuda") -> CompiledModel:
    """Build a ``CompiledModel`` from a mapping of numpy arrays.

    Field names are those of ``triplet_match_tpu.index.serialize``
    (``cloud_xyz``, ``cloud_normal``, ``cloud_tangent``, ``cloud_valid``,
    ``lut``, ``keys``, ``pairs``, ...), so an ``np.load`` of a saved JAX
    model, or the JAX model's arrays converted with ``np.asarray``, carry
    across.  Integer arrays widen to int64; tensors land on ``device``
    (default the CUDA card).
    """

    def t(name, dtype=None):
        a = np.asarray(d[name])
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        out = torch.from_numpy(np.array(a)).to(device)
        return out if dtype is None else out.to(dtype)

    cloud = cl.PointCloud(t("cloud_xyz"), t("cloud_normal"), t("cloud_tangent"),
                          t("cloud_valid", torch.bool))
    return CompiledModel(
        cloud=cloud, resolution=t("resolution"), diameter=t("diameter"),
        to_voxel=t("to_voxel"), lut=t("lut"), edge=t("edge", torch.bool),
        bounds_min=t("bounds_min"), bounds_max=t("bounds_max"), keys=t("keys"),
        pairs=t("pairs"), pair_count=t("pair_count"), n_edge=t("n_edge"),
        n_all=t("n_all"), margin=int(np.asarray(d["margin"])),
    )


def _voxel_grid_setup(lower, upper, resolution_val: float, margin: int):
    """Voxel extents + world -> voxel affine (impl/model.hpp:41-65); host numpy,
    a verbatim copy of the JAX helper including the isotropic shrink above
    ``_MAX_LUT_VOXELS``."""
    rng = upper - lower
    ext = np.minimum(np.maximum(rng / (0.5 * max(resolution_val, 1e-30)), 1.0), 1e9)
    for _ in range(40):
        total = float(np.prod(ext + 2.0 * margin))
        if total <= _MAX_LUT_VOXELS:
            break
        shrinkable = ext > 1.0
        n_s = max(int(np.sum(shrinkable)), 1)
        f = (total / _MAX_LUT_VOXELS) ** (1.0 / n_s)
        ext = np.where(shrinkable, np.maximum(ext / f, 1.0), ext)
    extents = (ext + 2.0 * margin).astype(np.int32)
    scale = np.where(rng < 1e-5, 1.0, ext / np.maximum(rng, 1e-12))
    to_voxel = np.eye(4, dtype=np.float32)
    to_voxel[0, 0], to_voxel[1, 1], to_voxel[2, 2] = scale
    to_voxel[:3, 3] = scale * (-lower) + margin - 0.5
    return tuple(int(e) for e in extents), to_voxel


def _pair_pass(exyz, etan, evalid, bounds, params, lower_bound, upper_bound, parallel_eps,
               block: int = 256):
    """Pass over the compacted edge-point pair square [E, E], ``block`` rows
    at a time (impl/model.hpp:100-149).  ``bounds=None`` returns the feature
    bounds (pass 1); otherwise the packed keys [E, E] (pass 2)."""
    e = exyz.shape[0]
    cols = torch.arange(e, device=exyz.device)
    bmin = torch.full((4,), float("inf"), device=exyz.device)
    bmax = torch.full((4,), -float("inf"), device=exyz.device)
    keys = []
    for i0 in range(0, e, block):
        rows = torch.arange(i0, min(i0 + block, e), device=exyz.device)
        p0, t0 = exyz[rows][:, None], etan[rows][:, None]
        p1, t1 = exyz[None], etan[None]
        gates = pf.pair_gates(p0, p1, t0, lower_bound, upper_bound, parallel_eps)
        valid = evalid[rows][:, None] & evalid[None] & (rows[:, None] != cols[None]) & gates
        f = pf.pair_feature(p0, p1, t0, t1)
        if bounds is None:
            v = valid[..., None]
            bmin = torch.minimum(bmin, torch.where(v, f, float("inf")).amin((0, 1)))
            bmax = torch.maximum(bmax, torch.where(v, f, -float("inf")).amax((0, 1)))
        else:
            valid = valid & pf.feature_valid(f, bounds[0], bounds[1])
            key = dz.pack_key(dz.discretize_feature(f, bounds[0], bounds[1], params))
            keys.append(torch.where(valid, key, _INVALID_KEY))
    return (bmin, bmax) if bounds is None else torch.cat(keys)


def _measure(cloud: cl.PointCloud, policy: SearchPolicy):
    """Stage 1: finite filter, resolution, bbox, curvature -> edge mask."""
    cloud = cl.finite_filter(cloud)
    res = cl.resolution(cloud)
    lower, upper = cl.bbox(cloud)
    curv = principal_curvatures(cloud, k=policy.curvature_k)
    edge = edge_mask_op(cloud, curv, tangent_norm_threshold=policy.tangent_norm_threshold,
                        curvature_ratio_threshold=policy.curvature_ratio_threshold)
    return res, lower, upper, edge


def _build(cloud, edge, edge_idx, edge_idx_valid, to_voxel, res, dia, lower_bound,
           upper_bound, *, extents, discretization, policy, pair_block, margin) -> CompiledModel:
    """Stage 2: LUT + pair table over the edge subset."""
    cloud = cl.finite_filter(cloud)
    dev = cloud.device
    ex, ey, ez = extents
    if ex * ey * ez > _LUT_JFA_THRESHOLD:
        # big grids (densely sampled models): the jump flood, O(V log V) with
        # no O(V * N) term; almost exact (ops/jfa.py)
        lut = nearest_point_volume(cloud.xyz, cloud.valid, to_voxel, extents=extents)
    else:
        inv = torch.linalg.inv(to_voxel)
        ii, jj, kk = torch.meshgrid(
            torch.arange(ex, dtype=torch.float32, device=dev),
            torch.arange(ey, dtype=torch.float32, device=dev),
            torch.arange(ez, dtype=torch.float32, device=dev), indexing="ij")
        centers = torch.stack([ii, jj, kk], dim=-1).reshape(-1, 3) @ inv[:3, :3].T + inv[:3, 3]
        lut_idx, _ = knn_ops.nn1(centers, cloud.xyz, cloud.valid)
        lut = lut_idx.reshape(ex, ey, ez)

    exyz = cloud.xyz[edge_idx]
    etan = cloud.tangent[edge_idx]
    evalid = edge_idx_valid & cloud.valid[edge_idx] & edge[edge_idx]
    args = (discretization, lower_bound, upper_bound, policy.pair_parallel_epsilon)
    bmin, bmax = _pair_pass(exyz, etan, evalid, None, *args, block=pair_block)
    bmin, bmax = pf.valid_bounds(bmin, bmax, 0.0, 1.0)
    key_sq = _pair_pass(exyz, etan, evalid, (bmin, bmax), *args, block=pair_block)

    e = edge_idx.shape[0]
    keys_sorted, order = torch.sort(key_sq.reshape(-1), stable=True)
    pairs = torch.stack([edge_idx[order // e], edge_idx[order % e]], dim=-1)
    return CompiledModel(
        cloud=cloud, resolution=res, diameter=dia, to_voxel=to_voxel, lut=lut, edge=edge,
        bounds_min=bmin, bounds_max=bmax, keys=keys_sorted, pairs=pairs,
        pair_count=(keys_sorted != _INVALID_KEY).sum(), n_edge=edge.sum(),
        n_all=cloud.count(), margin=margin,
    )


def compile_model(cloud: cl.PointCloud, discretization: DiscretizationParams = DEFAULT_DISCRETIZATION,
                  sample_params: SampleParams = DEFAULT_SAMPLE_PARAMS,
                  policy: SearchPolicy = DEFAULT_POLICY, *, margin: int = 5,
                  pair_block: int = 256, max_pair_points: int = 4096,
                  subset: np.ndarray | None = None) -> CompiledModel:
    """Compile a model cloud into its two query indexes (``model::init``,
    impl/model.hpp:15-167) on the cloud's device.

    ``subset`` restricts edge/pair-table eligibility only; ``max_pair_points``
    evenly subsamples the edge points feeding the pair table.  Runs under
    ``strict_fp32``.
    """
    with strict_fp32():
        dev = cloud.device
        res_d, lower_d, upper_d, edge_d = _measure(cloud, policy)
        if subset is not None:
            edge_d = edge_d & torch.as_tensor(np.asarray(subset, bool), device=dev)
        res = float(res_d)
        lower, upper = lower_d.cpu().numpy(), upper_d.cpu().numpy()
        dia = float(np.linalg.norm(upper - lower))
        if not (res > 0.0) or not np.isfinite(res):
            import warnings

            res = max(dia / 100.0, 1e-9)
            warnings.warn("model cloud resolution is 0 (exactly duplicated points?); "
                          f"falling back to diameter/100 = {res:.3g}", stacklevel=2)
        extents, to_voxel = _voxel_grid_setup(lower, upper, res, margin)

        eidx = np.where(edge_d.cpu().numpy())[0]
        if eidx.size > max_pair_points:
            eidx = eidx[np.linspace(0, eidx.size - 1, max_pair_points).astype(np.int64)]
        e_pad = max(-(-max(eidx.size, 1) // pair_block) * pair_block, pair_block)
        edge_idx = np.zeros(e_pad, np.int64)
        edge_idx[: eidx.size] = eidx
        edge_idx_valid = np.zeros(e_pad, bool)
        edge_idx_valid[: eidx.size] = True

        def f32(x):
            return torch.tensor(np.float32(x), device=dev)

        return _build(
            cloud, edge_d, torch.from_numpy(edge_idx).to(dev),
            torch.from_numpy(edge_idx_valid).to(dev), torch.from_numpy(to_voxel).to(dev),
            f32(res), f32(dia), f32(dia * sample_params.min_diameter_factor),
            f32(dia * sample_params.max_diameter_factor),
            extents=extents, discretization=discretization, policy=policy,
            pair_block=pair_block, margin=margin,
        )


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------


def query_pairs(model: CompiledModel, features: torch.Tensor, params: DiscretizationParams,
                cap: int, limit: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Model pairs matching each query feature (``model::query``,
    impl/model.hpp:169-178, plus the ``query_limit`` cap, impl/scene.hpp:19,310).

    Buckets larger than min(cap, limit) return that many entries at
    even-stride positions spanning the WHOLE bucket.  Returns
    (pairs [..., cap, 2] int64, valid [..., cap] bool).
    """
    keys = dz.pack_key(dz.discretize_feature(features, model.bounds_min, model.bounds_max, params))
    shape = keys.shape
    kf = keys.reshape(-1)
    left = torch.searchsorted(model.keys, kf, right=False)
    blen = torch.searchsorted(model.keys, kf, right=True) - left
    take = torch.clamp(blen, max=cap)
    if limit is not None and limit > 0:
        take = torch.clamp(take, max=limit)
    offs = torch.arange(cap, device=kf.device)
    pos = torch.where(blen[:, None] <= take[:, None], offs[None],
                      (offs[None] * blen[:, None]) // torch.clamp(take[:, None], min=1))
    valid = offs[None] < take[:, None]
    gather_idx = torch.clamp(left[:, None] + pos, max=model.keys.shape[0] - 1)
    pairs = model.pairs[gather_idx]
    return pairs.reshape(*shape, cap, 2), valid.reshape(*shape, cap)


def _to_voxel_coords(model: CompiledModel, pos: torch.Tensor) -> torch.Tensor:
    return pos @ model.to_voxel[:3, :3].T + model.to_voxel[:3, 3]


def voxel_query(model: CompiledModel, pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest model point through the voxel LUT (``model::voxel_query``,
    impl/model.hpp:180-192): (index [...], in_bounds [...])."""
    ijk = torch.floor(_to_voxel_coords(model, pos)).to(torch.int64)
    hi = torch.tensor(model.lut.shape, device=pos.device) - 1
    in_bounds = ((ijk >= 0) & (ijk <= hi)).all(-1)
    c = torch.minimum(torch.clamp(ijk, min=0), hi)
    return model.lut[c[..., 0], c[..., 1], c[..., 2]], in_bounds


def voxel_query_exact(model: CompiledModel, pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """LUT-seeded exact nearest model point: the argmin over the LUT entries
    of the 2x2x2 voxels around ``pos`` (the ``naive_corrs`` analog,
    impl/scene.hpp:446-453).  Returns (index [...], in_bounds [...])."""
    base = torch.floor(_to_voxel_coords(model, pos) - 0.5).to(torch.int64)
    hi = torch.tensor(model.lut.shape, device=pos.device) - 1
    best_d2 = torch.full(pos.shape[:-1], float("inf"), device=pos.device)
    best_idx = torch.zeros(pos.shape[:-1], dtype=torch.int64, device=pos.device)
    any_inb = torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz_ in (0, 1):
                ijk = base + torch.tensor([dx, dy, dz_], device=pos.device)
                inb = ((ijk >= 0) & (ijk <= hi)).all(-1)
                c = torch.minimum(torch.clamp(ijk, min=0), hi)
                idx = model.lut[c[..., 0], c[..., 1], c[..., 2]]
                d = pos - model.cloud.xyz[idx]
                d2 = torch.where(inb, (d * d).sum(-1), float("inf"))
                take = d2 < best_d2
                best_d2 = torch.where(take, d2, best_d2)
                best_idx = torch.where(take, idx, best_idx)
                any_inb = any_inb | inb
    return best_idx, any_inb
