"""The check that decides ``correct``, driven through a whole run on the CPU
at a tiny size: the program's answers pass, and the run comes out not
correct with the timed path broken underneath it (a pose moved, an answer
altered where the program produces it, correspondences dropped, a point
claimed twice, half of the requests left unanswered) and with the control
(the reference in TF32) in the program's place.  The limits are the
``box-matcher.fog500k`` cell's own; the tiny cell is ``conftest.py``'s."""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "benchmark"))
sys.path.insert(1, str(ROOT))

from tmbench import cell as bc, control, reference, synthetic, traffic  # noqa: E402

CELL = "tiny-box.tiny6k"  # conftest.py's
SEED = 2**31 + 77


def _run(root, factory, seconds=0.5, trace=False):
    result, rows, notes = bc.run_cell(root, CELL, SEED, seconds, trace, time.perf_counter(),
                                      device="cpu", system_factory=factory)
    return result


class Faulty:
    """The program with its answers altered by ``fault(k, answer)``."""

    def __init__(self, program, fault):
        self.program, self.fault, self.k = program, fault, 0

    def __call__(self, *args):
        return self

    def request(self, scan, search_seed):
        answer, stats = self.program.request(scan, search_seed)
        self.k += 1
        return self.fault(self.k, copy.deepcopy(answer)), stats


def _moved(k, answer):
    t = answer[0][0]["transform"].astype(np.float64)
    t[:3, :3] = t[:3, :3] @ synthetic.rotation_matrix([0.3, 0.5, 1.0], np.radians(0.3))
    answer[0][0]["transform"] = t.astype(np.float32)
    return answer


def _dropped(k, answer):
    m = answer[0][0]
    keep = np.arange(m["scene_corrs"].size) % 8 != 3
    m["scene_corrs"], m["model_corrs"] = m["scene_corrs"][keep], m["model_corrs"][keep]
    return answer


def _twice(k, answer):
    m = answer[0][0]
    m["scene_corrs"] = np.concatenate([m["scene_corrs"], m["scene_corrs"][:1]])
    m["model_corrs"] = np.concatenate([m["model_corrs"], m["model_corrs"][:1]])
    return answer


def _half_unanswered(k, answer):
    return [[]] if k % 2 else answer


def test_program_is_correct(tiny_root, program):
    result = _run(tiny_root, lambda *a: program)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) >= {"scenes_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", [_moved, _dropped, _twice, _half_unanswered],
                         ids=["pose_moved", "corrs_dropped", "point_claimed_twice",
                              "half_unanswered"])
def test_fault_is_not_correct(tiny_root, program, fault):
    result = _run(tiny_root, Faulty(program, fault), seconds=4.0)
    assert result["attempted"] >= 2
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("where", ["score", "pose"])
def test_answer_altered_where_produced(tiny_root, program, monkeypatch, where):
    from triplet_match_tpu_torch.search import driver

    if where == "score":
        norm = driver.normalize_score
        monkeypatch.setattr(driver, "normalize_score", lambda m, s: norm(m, s) * 1.001)
    else:
        inv = driver.invert_rigid

        def shifted(t):
            out = inv(t).clone()
            out[..., 0, 3] += 2e-3
            return out

        monkeypatch.setattr(driver, "invert_rigid", shifted)
    result = _run(tiny_root, lambda *a: program)
    assert not result["correct"], result["checks"]


def test_control_is_not_correct(tiny_root, program):
    c = bc.prepare(tiny_root, CELL, "cpu", lambda *a: program)
    req = traffic.Requests(SEED, len(c.pool))
    answers = {k: program.request(c.pool[req.slot(k)], req.search_seed(k))[0]
               for k in range(2)}
    cms = [control.ControlModel(a, c.config["find"]["dist_thres"], "cpu") for a in c.models]
    sound = bc.check(c, req, answers)
    ctl = bc.check(c, req, answers, lambda scan, a: control.answer(cms, scan, a, "cpu"))
    assert reference.judge(sound, c.limits)[0], sound
    assert not reference.judge(ctl, c.limits)[0], ctl
    assert ctl["corr_err"] > c.limits["corr_err"] and ctl["score_gap"] > c.limits["score_gap"]


def test_traced_run_reports_the_layers(tiny_root, program):
    result = _run(tiny_root, lambda *a: program, trace=True)
    assert {"hypotheses_per_scene", "hyp_ms_per_round", "fin_ms_per_round",
            "syncs_per_scene"} <= set(result["metrics"])
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.14159265])
    got = control.tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 + 2**-10
    assert got[2] == 1.0  # a tie goes to the even mantissa
    assert got[3] == 1.0 + 2**-9
    assert abs(float(got[4]) + 3.14159265) < 3.14159265 * 2**-11
