"""Batched RANSAC pair sampling (counterpart of ``triplet_match_tpu.search.sampling``).

The reference's outer loop (sample first points from unconsumed edge points)
and inner loop (shuffled neighbourhood second points, gated) become one batched
draw per round (impl/scene.hpp:131-166, 266-297).

The JAX package draws from threefry streams that torch does not reproduce, so
each round here takes a :class:`RoundDraws`: the two 32-bit key words of every
``hash_uniform`` call and the Gumbel noise of ``sample_seconds``.
``draw_round`` makes them from a ``torch.Generator``; the parity tests build
them from a JAX key instead, and the round is then bit-identical in its
samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from triplet_match_tpu_torch.features.discretize import MASK32 as _MASK32
from triplet_match_tpu_torch.features.discretize import mul32 as _mul32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_uniform(words, idx: torch.Tensor) -> torch.Tensor:
    """Per-element uniform [0, 1] priorities from two key words and a GLOBAL index.

    ``words`` are the two uint32 words of the already-salted key (on the JAX
    side ``jax.random.key_data(jax.random.fold_in(key, salt))``).  Bit-exact
    with the JAX ``hash_uniform``: the murmur3 finalizer over the index, run
    twice, in int64 arithmetic masked to 32 bits.
    """
    w0, w1 = (int(w) & _MASK32 for w in words)
    x = _fmix((idx.to(torch.int64) & _MASK32) ^ w0)
    x = _fmix(x ^ w1)
    return x.to(torch.float32) * (2.0 ** -32)


class RoundDraws(NamedTuple):
    """The random inputs of one search round."""

    first_words: tuple[int, int]  # sample_firsts priorities (JAX: fold_in(k1, 1))
    nbr_words: tuple[int, int]  # scoring-neighbourhood priorities (fold_in(k3, 0))
    pool_words: tuple[int, int]  # second-point pool priorities (fold_in(k4, 0))
    gumbel: torch.Tensor  # [B1, second_pool] Gumbel noise for sample_seconds (k2)


def draw_round(generator: torch.Generator, b1: int, pool: int, device) -> RoundDraws:
    """Draw one round's random inputs from a CPU ``generator``.

    Drawn on the host so a seed gives the same search on every device.
    """
    words = torch.randint(0, 1 << 32, (3, 2), generator=generator, dtype=torch.int64)
    u = torch.rand((b1, pool), generator=generator, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    w = [tuple(int(v) for v in row) for row in words]
    return RoundDraws(w[0], w[1], w[2], gumbel.to(device))


class FirstSamples(NamedTuple):
    idx: torch.Tensor  # [B1] int64 scene indices
    valid: torch.Tensor  # [B1] bool


def sample_firsts(words, eligible: torch.Tensor, b1: int) -> FirstSamples:
    """B1 distinct uniform indices from the eligibility mask (``vw::sample``).

    The B1 lowest hash priorities win; ties go to the lower index, as JAX's
    ``top_k`` resolves them.
    """
    n = eligible.shape[0]
    pr = torch.where(eligible, hash_uniform(words, torch.arange(n, device=eligible.device)),
                     float("inf"))
    k = min(b1, n)
    idx = torch.sort(pr, stable=True)[1][:k]
    valid = eligible[idx]
    if k < b1:
        idx = torch.cat([idx, idx.new_zeros(b1 - k)])
        valid = torch.cat([valid, valid.new_zeros(b1 - k)])
    return FirstSamples(idx, valid)


class SecondSamples(NamedTuple):
    idx: torch.Tensor  # [B1, B2] int64 scene indices
    valid: torch.Tensor  # [B1, B2] bool


def sample_seconds(gumbel: torch.Tensor, firsts: FirstSamples, nbr_idx: torch.Tensor,
                   nbr_in_radius: torch.Tensor, second_eligible: torch.Tensor,
                   b2: int) -> SecondSamples:
    """B2 distinct uniform draws per first from its eligible neighbourhood
    (impl/scene.hpp:284-290): Gumbel top-B2 over the eligible slots, ties to
    the lower slot.  ``gumbel`` is [B1, K] noise."""
    eligible = (nbr_in_radius & second_eligible[nbr_idx]
                & (nbr_idx != firsts.idx[:, None]) & firsts.valid[:, None])
    scores = torch.where(eligible, gumbel, -float("inf"))
    top, slots = torch.sort(scores, dim=1, descending=True, stable=True)
    top, slots = top[:, :b2], slots[:, :b2]
    idx = torch.gather(nbr_idx, 1, slots)
    valid = torch.gather(eligible, 1, slots) & torch.isfinite(top)
    return SecondSamples(idx, valid)
