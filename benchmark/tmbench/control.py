"""The control: the reference put in the program's place and computed in
TF32, the precision below the configurations' float32 with TF32 off (the
step that would tempt a later change: letting float32 products run on the
tensor cores).

Given the program's answers to a request, the control answers it again from
the scan and the model points: each pose rounded to TF32, the claims made by
the voxel-table rule (the nearest model point to the sample point of each
point's cell, within the claim gate, edge with edge and face with face,
first match first) and the orientation score, every operand rounded to
TF32's 10-bit mantissa and every sum in float32.  The reference must find
these answers wrong (``readings.py`` and ``tests/test_bench_reference.py``).
The reference cannot search, so the control keeps the program's poses and
matches.
"""

from __future__ import annotations

import numpy as np
import torch

from tmbench import reference


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits, to nearest even)."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class ControlModel(reference.ModelRef):
    def __init__(self, arrays, dist_thres: float, device):
        rounded = [tf32(torch.as_tensor(np.asarray(a))).numpy() for a in arrays]
        super().__init__(rounded, dist_thres, device, dtype=torch.float32)


def _claims(cm: ControlModel, s_xyz, raw_edge, taken, transform, device):
    t4 = tf32(torch.as_tensor(np.asarray(transform, np.float32), device=device))
    r, t = t4[:3, :3], t4[:3, 3]
    q = tf32(s_xyz - t) @ tf32(r)
    v = q * cm.scale + cm.offset
    cand = torch.nonzero((((v > -1.0) & (v < cm.extents + 1.0)).all(-1)) & ~taken)[:, 0]
    cell = torch.floor(v[cand])
    inside = ((cell >= 0) & (cell <= cm.extents - 1)).all(-1)
    c = tf32((cell - cm.offset) / cm.scale)
    j = torch.cat([torch.cdist(c[s:s + 8192], cm.xyz).argmin(1)
                   for s in range(0, c.shape[0], 8192)] or [cand.new_zeros(0)])
    d = torch.linalg.vector_norm(q[cand] - cm.xyz[j], dim=-1)
    ok = inside & (d <= cm.gate) & (cm.is_edge[j] == raw_edge[cand])
    return cand[ok], j[ok], t4


def answer(cms: list, scan, program_answer: list, device) -> list:
    """The control's answer to the request the program answered."""
    s_xyz = tf32(torch.as_tensor(scan.xyz, device=device))
    s_nrm = tf32(torch.as_tensor(scan.normal, device=device))
    s_tan = tf32(torch.as_tensor(scan.tangent, device=device))
    raw_edge = torch.linalg.vector_norm(torch.as_tensor(scan.tangent, device=device),
                                        dim=-1) > 0.7
    taken = torch.zeros(s_xyz.shape[0], dtype=torch.bool, device=device)
    out = []
    for cm, matches in zip(cms, program_answer):
        mine = []
        for m in matches:
            sc, mc, t4 = _claims(cm, s_xyz, raw_edge, taken, m["transform"], device)
            taken[sc] = True
            s_ref = torch.where(cm.is_edge[mc][:, None], s_tan[sc], s_nrm[sc])
            score = float(((s_ref @ tf32(t4[:3, :3])) * cm.ref[mc]).sum(-1).abs().sum())
            mine.append({"transform": t4.cpu().numpy(), "scene_corrs": sc.cpu().numpy(),
                         "model_corrs": mc.cpu().numpy(), "signed_score": score / cm.n_all})
        out.append(mine)
    return out
