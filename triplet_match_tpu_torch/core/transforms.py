"""Rigid-transform math (counterpart of ``triplet_match_tpu.core.transforms``).

Pair-frame alignment (``scene::base_transform_``, impl/scene.hpp:538-567) and
weighted Kabsch (``Eigen::umeyama(src, dst, false)``, impl/scene.hpp:393),
batched over leading dims.  All pose math is float32 with TF32 off: the JAX
package pins every pose matmul to HIGHEST because a ~1e-3 relative rounding
costs millimetres, and TF32 keeps about three decimal digits.
``strict_fp32`` is the context that ``compile_model`` and ``find_all`` run
under.
"""

from __future__ import annotations

import contextlib

import torch

from triplet_match_tpu_torch.parallel.mesh import psum, sharded


@contextlib.contextmanager
def strict_fp32():
    """Run the body with float32 matmuls and convolutions at full precision.

    Sets ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False and restores both (and the
    float32 matmul precision they map onto) on exit.
    """
    try:
        prev_prec = torch.get_float32_matmul_precision()
    except RuntimeError:
        # PyTorch >= 2.9 refuses the global getter once the legacy flags and
        # the per-backend precisions were both set; the two flags below are
        # then the whole state this context changes, and restoring them is
        # exact
        prev_prec = None
    prev_mm = torch.backends.cuda.matmul.allow_tf32
    prev_dnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_mm
        if prev_prec is not None:
            torch.set_float32_matmul_precision(prev_prec)
        torch.backends.cudnn.allow_tf32 = prev_dnn


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add ``a * b + c``, the FMA that XLA fuses on
    the CPU (ROADMAP C7), exact through float64 (a*b of two float32 values is
    exact in float64; the sum rounds once more on the way down, which differs
    from one rounding in ~2^-29 of cases)."""
    return (a.double() * b.double() + c.double()).float()


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


def _rigid(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(r.shape[:-2] + (4, 4), dtype=r.dtype, device=r.device)
    out[..., :3, :3] = r
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def base_transform(src_i, src_j, src_t, tgt_i, tgt_j, tgt_t) -> torch.Tensor:
    """Rigid transform aligning the source pair frame to the target pair frame.

    Inputs [..., 3]; returns [..., 4, 4].  u = pair direction, v = tangent
    orthogonalised against u, w = u x v (impl/scene.hpp:547-564).
    """
    u_a = _normalize(src_j - src_i)
    u_b = _normalize(tgt_j - tgt_i)
    v_a = _normalize(src_t - (src_t * u_a).sum(-1, keepdim=True) * u_a)
    v_b = _normalize(tgt_t - (tgt_t * u_b).sum(-1, keepdim=True) * u_b)
    w_a = _normalize(torch.linalg.cross(u_a, v_a, dim=-1))
    w_b = _normalize(torch.linalg.cross(u_b, v_b, dim=-1))
    base_a = torch.stack([u_a, v_a, w_a], dim=-1)  # columns
    base_b = torch.stack([u_b, v_b, w_b], dim=-1)
    r = base_b @ base_a.transpose(-1, -2)
    t = tgt_i - (r @ src_i[..., None])[..., 0]
    return _rigid(r, t)


def weighted_kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                    group=None) -> torch.Tensor:
    """Least-squares rigid transform mapping src -> dst under weights.

    src, dst: [..., N, 3]; w: [..., N].  Returns [..., 4, 4]; all-zero
    weights return identity (umeyama without scaling, det(R) = +1).

    ``group``: a ``parallel.mesh.MeshAxis`` when the points are one shard of a
    scene sharded over it.  The weight and the weighted sums of src and dst
    are summed over the shards first, then the covariance about those global
    means (two collectives: raw second moments would lose the pose's digits
    to cancellation in float32), so every shard computes the same fit.
    """
    if not sharded(group):
        # moments as elementwise products and reductions over N: a matmul
        # whose contraction is the N-long point axis runs as one serial GEMM
        # tile on the card (~0.9 ms at N = 131072, where the reduction takes
        # microseconds)
        wn = (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12))[..., None]
        mu_s = (wn * src).sum(-2)
        mu_d = (wn * dst).sum(-2)
        ds = src - mu_s[..., None, :]
        dd = dst - mu_d[..., None, :]
        sigma = ((wn * dd)[..., :, None] * ds[..., None, :]).sum(-3)  # cov(dst, src)
        wtot = w.sum(-1)
    else:
        first = psum(torch.cat([w.sum(-1, keepdim=True), (w[..., None] * src).sum(-2),
                                 (w[..., None] * dst).sum(-2)], dim=-1), *group)
        wtot = first[..., 0]
        wsum = torch.clamp(wtot, min=1e-12)[..., None]
        mu_s, mu_d = first[..., 1:4] / wsum, first[..., 4:7] / wsum
        wn = (w / wsum)[..., None]
        ds = src - mu_s[..., None, :]
        dd = dst - mu_d[..., None, :]
        sigma = psum(((wn * dd)[..., :, None] * ds[..., None, :]).sum(-3), *group)
    u, _, vt = torch.linalg.svd(sigma)
    det = torch.linalg.det(u @ vt)
    fix = torch.ones(sigma.shape[:-2] + (3,), dtype=sigma.dtype, device=sigma.device)
    fix[..., 2] = torch.sign(det)
    r = u @ (fix[..., :, None] * vt)
    t = mu_d - (r @ mu_s[..., None])[..., 0]
    degenerate = wtot <= 1e-12
    eye = torch.eye(3, dtype=src.dtype, device=src.device).expand_as(r)
    r = torch.where(degenerate[..., None, None], eye, r)
    t = torch.where(degenerate[..., None], torch.zeros_like(t), t)
    return _rigid(r, t)


def gauss_newton_pose_step(src: torch.Tensor, dst: torch.Tensor, m_dir: torch.Tensor,
                           m_kind: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
    """One Gauss-Newton rigid update of a hybrid point-to-plane objective,
    batched over leading dims.

    Minimises sum_i w_i |M_i (src_i + dx - dst_i)|^2 over the se(3) update
    dx = (omega, t) linearised at identity (apply it to the already
    transformed ``src``): M = n n^T for a surface corr (``m_kind`` False,
    n = ``m_dir``), M = I - t t^T for an edge corr (t = ``m_dir``).  The 6x6
    normal equations get Levenberg damping 1e-6 * trace / 6 and are solved
    with ``torch.linalg.solve_ex`` (no host sync); the rotation comes from
    Rodrigues' formula with the axis guarded at angle 1e-12.

    src, dst, m_dir: [..., N, 3]; m_kind: [..., N] bool; w: [..., N].
    Returns [..., 4, 4], the small update as a rigid pose.  ``group``: as in
    ``weighted_kabsch``; the normal equations are sums over points, summed
    over the shards in one collective.
    """
    def project(v):  # v [..., N, 3] -> M v
        along = (v * m_dir).sum(-1, keepdim=True) * m_dir
        return torch.where(m_kind[..., None], v - along, along)

    px, py, pz = src.unbind(-1)
    zeros = torch.zeros_like(px)
    ones = torch.ones_like(px)
    # the six columns of J = [-[p]x | I], each [..., N, 3]
    cols = [torch.stack(c, dim=-1) for c in (
        (zeros, -pz, py), (pz, zeros, -px), (-py, px, zeros),
        (ones, zeros, zeros), (zeros, ones, zeros), (zeros, zeros, ones))]
    mcols = torch.stack([project(c) for c in cols], dim=-3)  # [..., 6, N, 3]
    md = project(src - dst)
    mw = mcols * w[..., None, :, None]
    a = torch.einsum("...ind,...jnd->...ij", mw, mcols)
    b = -torch.einsum("...ind,...nd->...i", mw, md)
    if sharded(group):
        ab = psum(torch.cat([a.flatten(-2), b], dim=-1), *group)
        a, b = ab[..., :36].unflatten(-1, (6, 6)), ab[..., 36:]
    eye6 = torch.eye(6, dtype=a.dtype, device=a.device)
    tr = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)
    a = a + (1e-6 * tr / 6.0)[..., None, None] * eye6
    x = torch.linalg.solve_ex(a, b[..., None])[0][..., 0]
    omega, trans = x[..., :3], x[..., 3:]

    angle = torch.linalg.vector_norm(omega, dim=-1)
    axis = omega / torch.clamp(angle, min=1e-12)[..., None]
    ax, ay, az = axis.unbind(-1)
    z = torch.zeros_like(ax)
    k = torch.stack([torch.stack([z, -az, ay], -1), torch.stack([az, z, -ax], -1),
                     torch.stack([-ay, ax, z], -1)], -2)
    eye3 = torch.eye(3, dtype=src.dtype, device=src.device)
    r = (eye3 + torch.sin(angle)[..., None, None] * k
         + (1.0 - torch.cos(angle))[..., None, None] * (k @ k))
    return _rigid(r, trans)


def transform_points(t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] to [..., N, 3]."""
    return pts @ t[..., :3, :3].transpose(-1, -2) + t[..., None, :3, 3]


def invert_rigid(t: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid [..., 4, 4] (R^T, -R^T t)."""
    rt = t[..., :3, :3].transpose(-1, -2)
    return _rigid(rt, -(rt @ t[..., :3, 3:4])[..., 0])


def rotation_angle(r: torch.Tensor) -> torch.Tensor:
    """Rotation angle (radians) of [..., 3, 3] rotation matrices."""
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))


def pose_delta(t_a: torch.Tensor, t_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(translation delta, rotation delta radians) between two rigid poses.

    The composition is a float32 matmul at full precision: arccos((trace-1)/2)
    near identity turns a 1e-3 trace error into a phantom ~1.5 degree delta.
    """
    d = invert_rigid(t_a) @ t_b
    return torch.linalg.vector_norm(d[..., :3, 3], dim=-1), rotation_angle(d[..., :3, :3])
