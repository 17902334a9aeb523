"""Struct-of-arrays point cloud (counterpart of ``triplet_match_tpu.core.cloud``).

A cloud is four tensors on one device: positions, normals, edge tangents and a
validity mask.  Capacities may exceed the logical size (padding rows carry
``valid=False``) so that clouds round-trip with the JAX package unchanged.
Points with a near-zero tangent are "surface" points, points with a unit
tangent are "edge" points (impl/model.hpp:96-99).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Padded struct-of-arrays point cloud.

    Attributes:
      xyz:     [N, 3] float32 positions.
      normal:  [N, 3] float32 surface normals.
      tangent: [N, 3] float32 edge tangents (zero for non-edge points).
      valid:   [N]    bool    validity mask (False for padding).
    """

    xyz: torch.Tensor
    normal: torch.Tensor
    tangent: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def count(self) -> torch.Tensor:
        """Number of valid points (0-d int64 tensor on the cloud's device)."""
        return self.valid.sum()

    def to(self, device) -> "PointCloud":
        return PointCloud(self.xyz.to(device), self.normal.to(device),
                          self.tangent.to(device), self.valid.to(device))

    @staticmethod
    def from_arrays(xyz, normal=None, tangent=None, valid=None, capacity: int | None = None,
                    device="cuda") -> "PointCloud":
        """Build a cloud from host arrays on ``device``, padding to ``capacity``.

        The default device is the CUDA card; without one this raises as torch
        does, and a CPU cloud must be asked for (``device="cpu"``).

        Rows with NaN/inf in any field are invalidated and zeroed up front
        (impl/model.hpp:24-30), exactly as the JAX ``from_arrays`` does.
        """
        xyz = np.asarray(xyz, np.float32)
        n = xyz.shape[0]
        normal = np.zeros_like(xyz) if normal is None else np.asarray(normal, np.float32)
        tangent = np.zeros_like(xyz) if tangent is None else np.asarray(tangent, np.float32)
        valid = np.ones((n,), bool) if valid is None else np.asarray(valid, bool)
        finite = (np.isfinite(xyz).all(axis=-1) & np.isfinite(normal).all(axis=-1)
                  & np.isfinite(tangent).all(axis=-1))
        if not finite.all():
            xyz = np.where(finite[:, None], xyz, 0.0).astype(np.float32)
            normal = np.where(finite[:, None], normal, 0.0).astype(np.float32)
            tangent = np.where(finite[:, None], tangent, 0.0).astype(np.float32)
            valid = valid & finite
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < point count {n}")
        pad = cap - n

        def _pad(a, fill=0.0):
            if pad:
                a = np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return PointCloud(_pad(xyz), _pad(normal), _pad(tangent), _pad(valid, False))


def finite_filter(cloud: PointCloud) -> PointCloud:
    """Invalidate AND zero points with non-finite position/normal/tangent.

    Zeroing keeps every arithmetic masking idiom downstream NaN-safe
    (``NaN * 0 = NaN``), as in the JAX package.
    """
    finite = (torch.isfinite(cloud.xyz).all(-1) & torch.isfinite(cloud.normal).all(-1)
              & torch.isfinite(cloud.tangent).all(-1))
    f = finite[:, None]
    zero = torch.zeros((), dtype=cloud.xyz.dtype, device=cloud.device)
    return PointCloud(
        xyz=torch.where(f, cloud.xyz, zero),
        normal=torch.where(f, cloud.normal, zero),
        tangent=torch.where(f, cloud.tangent, zero),
        valid=cloud.valid & finite,
    )


def bbox(cloud: PointCloud) -> tuple[torch.Tensor, torch.Tensor]:
    """Axis-aligned bounding box (lower, upper) over valid points."""
    v = cloud.valid[:, None]
    inf = torch.tensor(float("inf"), device=cloud.device)
    lower = torch.where(v, cloud.xyz, inf).amin(0)
    upper = torch.where(v, cloud.xyz, -inf).amax(0)
    return lower, upper


def diameter(cloud: PointCloud) -> torch.Tensor:
    """Bounding-box diagonal length (impl/pointcloud.hpp:84-97)."""
    lower, upper = bbox(cloud)
    return torch.linalg.vector_norm(upper - lower)


def resolution(cloud: PointCloud) -> torch.Tensor:
    """Mean distance to the nearest *other* valid point (impl/pointcloud.hpp:66-82)."""
    from triplet_match_tpu_torch.ops.knn import nn1_exclusive_dist

    d = nn1_exclusive_dist(cloud)
    w = cloud.valid.to(torch.float32)
    return (d * w).sum() / torch.clamp(w.sum(), min=1.0)


def pad_capacity(cloud: PointCloud, multiple: int) -> PointCloud:
    """Pad the capacity up to a multiple with invalid filler rows."""
    cap = cloud.capacity
    m = max(multiple, 1)
    pad = -(-cap // m) * m - cap
    if pad == 0:
        return cloud

    def _pad(a):
        return torch.cat([a, torch.zeros((pad,) + a.shape[1:], dtype=a.dtype, device=a.device)])

    return PointCloud(_pad(cloud.xyz), _pad(cloud.normal), _pad(cloud.tangent), _pad(cloud.valid))
