"""The plain reference that decides ``correct``.

It re-derives, from the configuration's model points, the scan's points and
each returned pose alone, what a match must hold, in float64 PyTorch on the
card after the window (or on the CPU in the tests).  It imports nothing of
the program and takes nothing the program made: the model's resolution, its
voxel grid and the correspondence gate are worked out again here.

Per checked request:

* the pose of every planted instance: the best match of its model by the
  box-symmetry-aware error (``synthetic.sym_pose_error``), against the
  configuration's contract, 1 mm / 0.5 deg (``pose_mm``, ``pose_deg``); an
  instance without any match of its model counts in ``missed``, a match that
  is no instance's best in ``extra``;
* every claimed correspondence (scene point i, model point j) at the
  returned pose: i a real scan point inside the model's voxel grid, j the
  model point nearest to the sample point of i's voxel (the voxel table's
  rule, worked out again here from the model points), the posed distance
  within the claim gate (2 x dist_thres x resolution), and j an edge point
  only where i has a tangent; and every unclaimed scan point without a
  tangent whose table entry is a face point within the gate counted as
  missed.  ``corr_err`` is the worst match's count of both faults over its
  claims;
* ``claimed_twice``: scan points claimed by two matches, or twice by one;
* ``score_gap``: each match's signed score against the orientation score of
  its claimed pairs over the model's point count, relative.
"""

from __future__ import annotations

import numpy as np
import torch

from tmbench.synthetic import sym_pose_error

# float32 rounding of a point transformed at up to ~10 m, with room
GATE_EPS = 1e-5
# the voxel table's nearest point is found in float32 from voxel centres
TABLE_EPS = 1e-4
# voxel coordinates within which float32 may put a point in either cell
CELL_EPS = 1e-3
_MAX_LUT_VOXELS = 134_217_728
_MARGIN = 5
_EXACT = "donot_use_mm_for_euclid_dist"


def voxel_grid(lower, upper, res: float, margin: int = _MARGIN):
    """Voxel extents and the world -> voxel scale and offset of a model
    (the reference's impl/model.hpp:41-65: voxels of half the resolution,
    ``margin`` voxels around the bounding box, an isotropic shrink above
    2^27 voxels), in float64."""
    rng = upper - lower
    ext = np.minimum(np.maximum(rng / (0.5 * max(res, 1e-30)), 1.0), 1e9)
    for _ in range(40):
        if float(np.prod(ext + 2.0 * margin)) <= _MAX_LUT_VOXELS:
            break
        shrinkable = ext > 1.0
        f = (float(np.prod(ext + 2.0 * margin)) / _MAX_LUT_VOXELS) ** (
            1.0 / max(int(np.sum(shrinkable)), 1))
        ext = np.where(shrinkable, np.maximum(ext / f, 1.0), ext)
    extents = np.floor(ext + 2.0 * margin)
    scale = np.where(rng < 1e-5, 1.0, ext / np.maximum(rng, 1e-12))
    offset = scale * (-lower) + margin - 0.5
    return extents, scale, offset


class ModelRef:
    """What the reference derives from one model's points."""

    def __init__(self, arrays, dist_thres: float, device, dtype=torch.float64):
        xyz, nrm, tan = (torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
                         for a in arrays)
        self.xyz = xyz
        self.is_edge = torch.linalg.vector_norm(tan, dim=-1) > 0.7
        self.ref = torch.where(self.is_edge[:, None], tan, nrm)
        d = torch.cdist(xyz, xyz, compute_mode=_EXACT)
        d.fill_diagonal_(float("inf"))
        self.res = float(d.min(1).values.mean())
        self.n_all = xyz.shape[0]
        x64 = np.asarray(arrays[0], np.float64)
        lower, upper = x64.min(0), x64.max(0)
        extents, scale, offset = voxel_grid(lower, upper, self.res)
        self.extents = torch.as_tensor(extents, dtype=dtype, device=device)
        self.scale = torch.as_tensor(scale, dtype=dtype, device=device)
        self.offset = torch.as_tensor(offset, dtype=dtype, device=device)
        self.gate = 2.0 * dist_thres * self.res

    def nearest_dist(self, c: torch.Tensor, block: int = 8192) -> torch.Tensor:
        """Distance from each point of ``c`` to its nearest model point."""
        out = [torch.cdist(c[s:s + block], self.xyz, compute_mode=_EXACT).min(1).values
               for s in range(0, c.shape[0], block)]
        return torch.cat(out) if out else c.new_zeros(0)

    def table_face_within(self, c: torch.Tensor, q: torch.Tensor, gate: float,
                          block: int = 8192) -> torch.Tensor:
        """Whether every model point that may be the table's entry for sample
        points ``c`` (within ``TABLE_EPS`` of the nearest) is a face point
        within ``gate`` of ``q``."""
        out = []
        for s in range(0, c.shape[0], block):
            dc = torch.cdist(c[s:s + block], self.xyz, compute_mode=_EXACT)
            may = dc <= dc.min(1, keepdim=True).values + TABLE_EPS
            dq = torch.cdist(q[s:s + block], self.xyz, compute_mode=_EXACT)
            fine = ~self.is_edge[None] & (dq <= gate)
            out.append(~(may & ~fine).any(1))
        return torch.cat(out) if out else c.new_zeros(0, dtype=torch.bool)


def _posed(transform, device):
    t = torch.as_tensor(np.asarray(transform, np.float64), device=device)
    return t[:3, :3], t[:3, 3]


def _cells(mref: ModelRef, v: torch.Tensor):
    """The voxel table's cell of each point at voxel coordinates ``v``,
    taken on both sides of a cell boundary within ``CELL_EPS`` (float32
    places a point there either way): [(cell [n, 3], in the grid [n],
    sample point [n, 3])] for the low and the high reading.  The table holds
    the nearest model point to each cell's sample point, the point at the
    cell's integer voxel coordinates."""
    out = []
    for cell in (torch.floor(v - CELL_EPS), torch.floor(v + CELL_EPS)):
        inside = ((cell >= 0) & (cell <= mref.extents - 1)).all(-1)
        out.append((inside, (cell - mref.offset) / mref.scale))
    return out


def _corr_faults(mref: ModelRef, scan: dict, claimed_any, match, device):
    """(faulty claimed pairs, must-claim points left unclaimed, claims,
    orientation score of the claimed pairs) of one match."""
    s_xyz, raw_edge = scan["xyz"], scan["raw_edge"]
    n = s_xyz.shape[0]
    r, t = _posed(match["transform"], device)
    sc = torch.as_tensor(np.asarray(match["scene_corrs"], np.int64), device=device)
    mc = torch.as_tensor(np.asarray(match["model_corrs"], np.int64), device=device)
    if sc.shape != mc.shape:
        return max(sc.numel(), mc.numel()), 0, max(sc.numel(), 1), 0.0
    in_range = (sc >= 0) & (sc < n) & (mc >= 0) & (mc < mref.n_all)
    bad = int((~in_range).sum())
    sc, mc = sc[in_range], mc[in_range]
    q_all = (s_xyz - t) @ r  # scene -> model frame: R^T (s - t)
    v_all = q_all * mref.scale + mref.offset
    # claimed pairs: j is the table's entry of i's cell, within the gate, and
    # an edge point only for a scene point with a tangent
    q, m = q_all[sc], mref.xyz[mc]
    table_ok = torch.zeros(sc.shape, dtype=torch.bool, device=device)
    for inside, c in _cells(mref, v_all[sc]):
        d_min = mref.nearest_dist(c)
        table_ok |= inside & (torch.linalg.vector_norm(c - m, dim=-1) <= d_min + TABLE_EPS)
    gate_ok = torch.linalg.vector_norm(q - m, dim=-1) <= mref.gate + GATE_EPS
    kind_ok = ~(mref.is_edge[mc] & ~raw_edge[sc])
    bad += int((~(table_ok & gate_ok & kind_ok)).sum())
    # unclaimed points without a tangent that the gate must claim: in the grid
    # and every entry the table may hold for them a face point within the gate
    near = ((v_all > -1.0) & (v_all < mref.extents + 1.0)).all(-1) & ~raw_edge & ~claimed_any
    cand = torch.nonzero(near)[:, 0]
    must = torch.ones(cand.shape, dtype=torch.bool, device=device)
    for inside, c in _cells(mref, v_all[cand]):
        must &= inside & mref.table_face_within(c, q_all[cand], mref.gate - GATE_EPS)
    missed = int(must.sum())
    # orientation score: the scene point's reference vector of the kind it
    # was paired as (tangent with an edge point, normal otherwise), rotated
    # into the model frame, against the model point's
    score = 0.0
    if sc.numel():
        s_ref = torch.where(mref.is_edge[mc][:, None], scan["tangent"][sc], scan["normal"][sc])
        score = float(((s_ref @ r) * mref.ref[mc]).sum(-1).abs().sum())
    return bad, missed, int(sc.numel()), score


def check_request(mrefs: list, scan, answer: list, device) -> dict:
    """Readings of one request.  ``answer``: one list of matches per model,
    each match a dict of ``transform`` [4, 4], ``scene_corrs``,
    ``model_corrs`` and ``signed_score``."""
    st = {k: torch.as_tensor(getattr(scan, k), dtype=torch.float64, device=device)
          for k in ("xyz", "normal", "tangent")}
    st["raw_edge"] = torch.linalg.vector_norm(st["tangent"], dim=-1) > 0.7
    s_xyz = st["xyz"]
    n = s_xyz.shape[0]
    out = {"pose_mm": 0.0, "pose_deg": 0.0, "missed": 0, "extra": 0, "claimed_twice": 0,
           "corr_err": 0.0, "score_gap": 0.0}
    allc = np.concatenate([np.asarray(m["scene_corrs"], np.int64) for ms in answer for m in ms]
                          or [np.zeros(0, np.int64)])
    allc_ok = allc[(allc >= 0) & (allc < n)]
    out["claimed_twice"] = int(allc_ok.size - np.unique(allc_ok).size)
    claimed_any = torch.zeros(n, dtype=torch.bool, device=device)
    claimed_any[torch.as_tensor(allc_ok, device=device)] = True
    for mi, matches in enumerate(answer):
        mref = mrefs[mi]
        for m in matches:
            bad, missed, n_claims, score = _corr_faults(mref, st, claimed_any, m, device)
            out["corr_err"] = max(out["corr_err"], (bad + missed) / max(n_claims, 1))
            ref_score = score / mref.n_all
            gap = abs(float(m["signed_score"]) - ref_score) / max(abs(ref_score), 1e-12)
            out["score_gap"] = max(out["score_gap"], gap)
    best_of = set()
    for mi, t_gt in scan.truths:
        matches = answer[mi] if mi < len(answer) else []
        if not matches:
            out["missed"] += 1
            continue
        errs = [sym_pose_error(m["transform"], t_gt) for m in matches]
        k = min(range(len(errs)), key=lambda i: errs[i][0] + 0.01 * errs[i][1])
        best_of.add((mi, k))
        out["pose_mm"] = max(out["pose_mm"], errs[k][0] * 1e3)
        out["pose_deg"] = max(out["pose_deg"], errs[k][1])
    out["extra"] = sum(len(ms) for ms in answer) - len(best_of)
    return out


WORST = ("pose_mm", "pose_deg", "corr_err", "score_gap")


def combine(readings: list) -> dict:
    """Readings of a run: the worst over its checked requests, or the sum
    for the counts."""
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0), v) if k in WORST else out.get(k, 0) + v
    return out


def judge(readings: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, value, limit)]): every reading at or under its
    limit; a reading without a limit, or a limit without a reading, fails."""
    rows, ok = [], True
    for name in sorted(set(readings) | set(limits)):
        v, lim = readings.get(name), limits.get(name)
        rows.append((name, v, lim))
        if v is None or lim is None or not (v <= lim):
            ok = False
    return ok, rows
