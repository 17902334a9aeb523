"""Projector primitive interface and shared math (counterpart of
``triplet_match_tpu.primitives.base``).

The reference carries projector traits (identity / plane / plane2 /
cylinder, include/*_traits) that map points into a primitive-intrinsic
(u, v, w) chart; here, as in the JAX package, they are first-class because
the acceptance configs detect planes and cylinders.  Each primitive is a
bundle of functions over a ``NamedTuple`` state of tensors:

  fit_from_cloud(cloud, mask)          -> state          (init_from_model)
  fit_from_samples(ref_state, samples) -> (state, valid) (init_from_samples)
  project(state, xyz)                  -> (uvw, valid)
  unproject(state, uvw)                -> xyz
  tangent(state, xyz, tangent)         -> uvw tangent
  normal(state, xyz, tangent, normal)  -> uvw normal
  intrinsic_distance(state, uvw0, uvw1)-> distance

All functions are batched over leading axes and run on their inputs'
device.  Point transforms are elementwise float32 sums (no matmul, so no
TF32 on the card), as the JAX package pins them to full precision.
"""

from __future__ import annotations

import torch

from triplet_match_tpu_torch.core.cloud import resolution

_MSAC_CHUNK = 64  # hypotheses per MSAC pass: [64, N, 3] float32 temporaries


def unit_orthogonal(v: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to v (Eigen ``unitOrthogonal``): if x or y is
    not much smaller than z, (-y, x, 0) / |(x, y)|, else (0, -z, y) / |(y, z)|."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    eps = 1e-12
    use_xy = (x.abs() > z.abs() * 1e-6) | (y.abs() > z.abs() * 1e-6)
    inv_xy = 1.0 / torch.sqrt(torch.clamp(x * x + y * y, min=eps))
    inv_yz = 1.0 / torch.sqrt(torch.clamp(y * y + z * z, min=eps))
    zero = torch.zeros_like(x)
    a = torch.stack([-y * inv_xy, x * inv_xy, zero], dim=-1)
    b = torch.stack([zero, -z * inv_yz, y * inv_yz], dim=-1)
    return torch.where(use_xy[..., None], a, b)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting the leading ones."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] times [..., 3], elementwise in float32."""
    return (m * v[..., None, :]).sum(-1)


def frame_to_g2l(origin: torch.Tensor, ex: torch.Tensor, ey: torch.Tensor,
                 ez: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] global -> local transform with rows (ex, ey, ez) and
    translation -R origin (cylinder_traits impl:32-38)."""
    r = torch.stack(torch.broadcast_tensors(ex, ey, ez), dim=-2)
    out = torch.zeros(r.shape[:-2] + (4, 4), dtype=r.dtype, device=r.device)
    out[..., :3, :3] = r
    out[..., :3, 3] = -_matvec(r, origin)
    out[..., 3, 3] = 1.0
    return out


def apply_h(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply homogeneous [..., 4, 4] to points [..., 3]."""
    return _matvec(m[..., :3, :3], p) + m[..., :3, 3]


def rotate(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply the rotation block of [..., 4, 4] to vectors [..., 3]."""
    return _matvec(m[..., :3, :3], v)


def eye4(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=like.device)


def draw_samples(mask: torch.Tensor, count: int,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """``count`` indices drawn uniformly, with replacement, from the True
    entries of ``mask`` (the distribution of the JAX package's Gumbel-argmax
    draws) by a CPU ``generator`` (default seeded with 0), on the mask's
    device."""
    cand = torch.nonzero(mask)[:, 0]
    if cand.numel() == 0:
        raise ValueError("no masked point to draw a hypothesis from")
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    pick = torch.randint(0, cand.numel(), (count,), generator=gen)
    return cand[pick.to(cand.device)]


def resolved_threshold(cloud, threshold, factor: float) -> torch.Tensor:
    """``threshold`` as a float32 tensor on the cloud's device; None gives
    ``factor`` x the cloud's resolution (the reference's default inlier
    band)."""
    if threshold is None:
        return factor * resolution(cloud)
    return torch.as_tensor(threshold, dtype=torch.float32, device=cloud.device)


def msac_best(residual, n_hyp: int, mask: torch.Tensor, threshold: torch.Tensor,
              ok: torch.Tensor | None = None) -> torch.Tensor:
    """Index of the hypothesis of least MSAC cost, the sum over the masked
    points of min(residual^2, threshold^2).  ``residual(s, e)`` gives the
    [e - s, N] residuals of hypotheses s..e-1, taken a chunk at a time;
    hypotheses with ``ok`` False cost +inf; the first of equal costs wins."""
    w = mask.to(torch.float32)
    costs = []
    for s in range(0, n_hyp, _MSAC_CHUNK):
        e = min(s + _MSAC_CHUNK, n_hyp)
        cost = (torch.minimum(residual(s, e).square(), threshold.square()) * w).sum(-1)
        costs.append(cost if ok is None else torch.where(ok[s:e], cost, float("inf")))
    return torch.argmin(torch.cat(costs))
