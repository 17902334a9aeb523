"""Feature quantization, key packing and the MurmurHash3 parity op
(counterpart of ``triplet_match_tpu.features.discretize``; src/discretize.cpp,
include/impl/discretize.hpp).

The reference's ``unordered_multimap`` becomes a sorted table of packed keys:
the bins (distance, angle1, angle2) pack losslessly into one 32-bit value.
Keys are held in int64 tensors (the values are the JAX package's uint32 keys):
torch's uint32 lacks arithmetic on many builds, so 32-bit words live in int64
and every multiply and shift is masked back to 32 bits.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32

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



def max_angle_bins(params) -> int:
    """Static upper bound on angle bins: angles lie in [0, pi/2]."""
    return int(math.floor((math.pi / 2) / params.angle_step)) + 1


# MurmurHash3_x86_32, seed 42 (impl/discretize.hpp:12-45)
_MURMUR_SEED = 42
_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def murmur(key: torch.Tensor) -> torch.Tensor:
    """MurmurHash3_x86_32 (seed 42) over 32-bit words along the last axis.

    key: [..., Dim] integer words (uint32 values).  Returns [...] int64 holding
    the uint32 hash, bit for bit ``triplet_match::detail::murmur`` for any Dim.
    """
    key = key.to(torch.int64) & MASK32
    dim = key.shape[-1]
    h1 = torch.full(key.shape[:-1], _MURMUR_SEED, dtype=torch.int64, device=key.device)
    for i in range(dim):
        k1 = _rotl32(mul32(key[..., i], _C1), 15)
        h1 = _rotl32(h1 ^ mul32(k1, _C2), 13)
        h1 = (mul32(h1, 5) + 0xE6546B64) & MASK32
    h1 = h1 ^ (4 * dim)
    h1 = mul32(h1 ^ (h1 >> 16), 0x85EBCA6B)
    h1 = mul32(h1 ^ (h1 >> 13), 0xC2B2AE35)
    return h1 ^ (h1 >> 16)
