"""Feature quantization and key packing (counterpart of
``triplet_match_tpu.features.discretize``; src/discretize.cpp).

The reference's ``unordered_multimap`` becomes a sorted table of packed keys:
the bins (distance, angle1, angle2) pack losslessly into one 32-bit value.
Keys are held in int64 tensors (the values are the JAX package's uint32 keys):
torch's uint32 lacks arithmetic on many builds.
"""

from __future__ import annotations

import torch

_DIST_BITS = 12
_ANG_BITS = 10


def discretize_range(value, min_value, range_value, steps: int) -> torch.Tensor:
    """Range-normalized binning, clamped (src/discretize.cpp:19-25)."""
    nval = (value - min_value) / range_value
    bins = torch.floor(nval * steps).to(torch.int64)
    bins = torch.where(nval < 0.0, torch.zeros_like(bins), bins)
    return torch.where(nval >= 1.0, torch.full_like(bins, steps - 1), bins)


def discretize_step(value: torch.Tensor, step_size: float) -> torch.Tensor:
    """Fixed-step binning (src/discretize.cpp:27-30); values are >= 0."""
    return (value / step_size).to(torch.int64)


def discretize_feature(f: torch.Tensor, bounds_min, bounds_max, params) -> torch.Tensor:
    """[..., 4] feature -> [..., 4] int64 bins [distance, angle1, angle2, distance]."""
    d0 = discretize_range(f[..., 0], bounds_min[0], bounds_max[0] - bounds_min[0],
                          params.distance_step_count)
    a1 = discretize_step(f[..., 1], params.angle_step)
    a2 = discretize_step(f[..., 2], params.angle_step)
    return torch.stack([d0, a1, a2, d0], dim=-1)


def pack_key(df: torch.Tensor) -> torch.Tensor:
    """Pack bins [..., 4] into one sort key (the 4th bin repeats the 1st)."""
    return (df[..., 0] << (2 * _ANG_BITS)) | (df[..., 1] << _ANG_BITS) | df[..., 2]

