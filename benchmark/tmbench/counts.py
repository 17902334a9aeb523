"""Operations and bytes of the ranking kernels B1 and B2, and the H100's
peaks: the roofline's yardstick.

A frozen copy of ``chip_smoke.py``'s counts (its B1 phase and
``_check_exact``) with the pair arithmetic of
``search/score_kernel.exact_pair_d2`` that B2's count needs.  The counts are
the work the inputs need, whatever implements it: B1 sweeps each eligible
point against its own kind's real representatives (7 fp32 instructions per
evaluation; 20 per (pose, eligible point) for the operand, 3 per pose); B2
sweeps the own kind's columns for every eligible pair and the other kind's
only for pairs within the gate, all of them with ``negative`` (5 per
evaluation, 17 per pair, 3 per pose).  Bytes: each input read once, each
output written once.
"""

from __future__ import annotations

import torch

# H100 SXM published peaks (NVIDIA data sheet, 700 W): 67 TFLOP/s fp32 outside
# the tensor cores, i.e. 3.35e13 fp32 instructions/s counting an FMA as one,
# and 3.35 TB/s of HBM3
FP32_INSTR_PER_S = 3.35e13
HBM_BYTES_PER_S = 3.35e12

_PLAIN_REP_CHUNK = 16
_PLAIN_MAX_ELEMS = 1 << 21


def bound_s(instr: float, nbytes: float) -> float:
    """Least time on the card: fp32 instructions at their peak rate or bytes at
    the memory rate, whichever is longer."""
    return max(instr / FP32_INSTR_PER_S, nbytes / HBM_BYTES_PER_S)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def b1_work(groups, poses, block, n_edge: int, n_reps: int) -> tuple[float, float]:
    """(fp32 instructions, bytes) of one B1 launch: groups [G, 8, K], poses
    [G, Hg, 16], the 4-D representative block with its edge and real
    representative counts."""
    n_poses = poses.shape[1]
    el = groups[:, 4] > 0.5
    n_el_e = (el & (groups[:, 3] > 0.5)).sum(1).double()
    n_el = el.sum(1).double()
    evals = float((n_el_e * n_edge + (n_el - n_el_e) * (n_reps - n_edge)).sum()) * n_poses
    pairs = float(n_el.sum()) * n_poses
    instr = 7.0 * evals + 20.0 * pairs + 3.0 * groups.shape[0] * n_poses
    return instr, float(_nbytes(groups, poses, block) + 4 * groups.shape[0] * n_poses)


def fma32(a, b, c):
    """float32 fused multiply-add, exact through float64."""
    return (a.double() * b.double() + c.double()).float()


def _block_min(a: list, block: torch.Tensor) -> torch.Tensor:
    emin = None
    for r0 in range(0, block.shape[1], _PLAIN_REP_CHUNK):
        m = block[:, r0:r0 + _PLAIN_REP_CHUNK]
        e = a[0][..., None] * m[0]
        e = (a[1][..., None].double() * m[1].double() + e).float()
        e = (a[2][..., None].double() * m[2].double() + e).float()
        e = (e + m[3]).amin(-1)
        emin = e if emin is None else torch.minimum(emin, e)
    return emin


def exact_pair_d2(groups, poses, md_edge, md_surf):
    """Every (eligible point, pose) pair's own-kind and other-kind squared
    distance (poses centre-shifted).  Returns (group index [M], point index
    [M], own [M, Hg], other [M, Hg])."""
    gi, ki = (groups[:, 4] > 0.5).nonzero(as_tuple=True)
    pts = groups[gi, :, ki]
    own, other = [], []
    mc = max(1, _PLAIN_MAX_ELEMS // max(poses.shape[1] * _PLAIN_REP_CHUNK, 1))
    for s in range(0, pts.shape[0], mc):
        p, gs = pts[s:s + mc], gi[s:s + mc]
        q = [poses[gs, :, i] for i in range(12)]
        px, py, pz = p[:, 0, None], p[:, 1, None], p[:, 2, None]
        tp = [fma32(q[3 * i + 2], pz, fma32(q[3 * i], px, q[3 * i + 1] * py)) + q[9 + i]
              for i in range(3)]
        tp2 = fma32(tp[2], tp[2], fma32(tp[0], tp[0], tp[1] * tp[1]))
        a = [-2.0 * t for t in tp]
        d2_e, d2_s = tp2 + _block_min(a, md_edge), tp2 + _block_min(a, md_surf)
        kind = (p[:, 3, None] > 0.5).expand_as(tp2)
        own.append(torch.where(kind, d2_e, d2_s))
        other.append(torch.where(kind, d2_s, d2_e))
    empty = poses.new_zeros((0, poses.shape[1]))
    return (gi, ki, torch.cat(own) if own else empty, torch.cat(other) if other else empty)


def b2_work(groups, poses, md_edge, md_surf, center, t2: float,
            negative: bool) -> tuple[float, float]:
    """(fp32 instructions, bytes) of one B2 (count mode) launch: groups
    [G, 8, K], uncentred poses [G, Hg, 16], the compact edge and surface
    blocks cut to their model points, the model centre, the gate t2."""
    shifted = poses.clone()
    shifted[..., 9:12] -= center
    n_poses = poses.shape[1]
    ne, ns = md_edge.shape[1], md_surf.shape[1]
    gi, ki, d_own, _ = exact_pair_d2(groups, shifted, md_edge, md_surf)
    edge = (groups[gi, 3, ki] > 0.5)[:, None]
    own_cols = torch.where(edge, ne, ns).double()
    other_cols = torch.where(edge, ns, ne).double()
    gate = d_own <= t2
    surv = torch.ones_like(gate) if negative else gate
    pairs = float(gate.numel())
    evals_own = float(own_cols.sum()) * n_poses
    evals_other = float((other_cols * surv).sum())
    instr = 5.0 * (evals_own + evals_other) + 17.0 * pairs + 3.0 * groups.shape[0] * n_poses
    nbytes = _nbytes(groups, poses) + 16 * (ne + ns) + 8 * groups.shape[0] * n_poses
    return instr, float(nbytes)
