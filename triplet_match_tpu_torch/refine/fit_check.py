"""The yardstick of the join's pose-fit kernel (``csrc/join_fit.cu``).

The kernel computes ``refine.icp._fit_plain`` in float64 and rounds the pose
to float32 once, so it is held to the plain fit evaluated in float64 on the
same inputs: per pose, no farther from it than the float32 plain fit is,
plus 1e-6 rad and 1e-6 x the scene's extent.  The card tests and
``chip_smoke.py``'s join audit read these functions; the search does not.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.refine.icp import _fit_plain
from triplet_match_tpu_torch.search.score import DenseCorrs


def fit_float64(model, scene, tangent_mask, t, corrs: DenseCorrs, group=None,
                **mode) -> torch.Tensor:
    """``_fit_plain`` evaluated in float64 on the same inputs (points,
    directions and poses widened exactly; ``group`` and ``mode`` as
    ``_fit_plain``'s).  Returns float64 poses."""
    def wide(c):
        return PointCloud(c.xyz.double(), c.normal.double(), c.tangent.double(), c.valid)

    return _fit_plain(SimpleNamespace(cloud=wide(model.cloud)), wide(scene), tangent_mask,
                      t.double(), corrs, group=group, **mode)


def fit_gap(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(translation gap, rotation gap in radians) between poses ``a`` and
    ``b`` [..., 4, 4], in float64: the angle from the relative rotation's
    skew and trace parts by atan2, which resolves the 1e-7 rad of float32
    rounding (an arccos of the trace alone reads it as some 1e-4)."""
    a, b = a.double(), b.double()
    d = a[..., :3, :3].transpose(-1, -2) @ b[..., :3, :3]
    skew = torch.stack([d[..., 2, 1] - d[..., 1, 2], d[..., 0, 2] - d[..., 2, 0],
                        d[..., 1, 0] - d[..., 0, 1]], -1)
    cos2 = d[..., 0, 0] + d[..., 1, 1] + d[..., 2, 2] - 1.0
    angle = torch.atan2(torch.linalg.vector_norm(skew, dim=-1), cos2)
    return torch.linalg.vector_norm(a[..., :3, 3] - b[..., :3, 3], dim=-1), angle


def fit_excess(model, scene, tangent_mask, t, corrs: DenseCorrs, got: torch.Tensor,
               group=None, **mode) -> tuple[torch.Tensor, torch.Tensor, tuple, tuple]:
    """How far ``got``, a fit of ``_fit_plain``'s inputs (the kernel's),
    lies beyond its bound: per pose, its gap to ``fit_float64`` less the
    float32 plain fit's gap and a slack of 1e-6 x the scene's extent (the
    translation; under a sharded ``group``, this shard's extent) or 1e-6 rad
    (the rotation).  Returns (translation excess, rotation excess, ``got``'s
    gaps, the plain fit's gaps): within the bound where both excesses are
    <= 0."""
    plain = _fit_plain(model, scene, tangent_mask, t, corrs, group=group, **mode)
    wide = fit_float64(model, scene, tangent_mask, t, corrs, group=group, **mode)
    xyz = scene.xyz[scene.valid]
    extent = float(torch.linalg.vector_norm(xyz.amax(0) - xyz.amin(0))) if len(xyz) else 0.0
    (kt, kr), (pt, pr) = fit_gap(got, wide), fit_gap(plain, wide)
    return kt - (pt + 1e-6 * extent), kr - (pr + 1e-6), (kt, kr), (pt, pr)
