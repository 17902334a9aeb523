"""The lattice cell's own files: the frozen lattice generator against the
port's, the control (the reference in TF32) in the program's place on a
small lattice cell run on the CPU, and the ``b2_ms_per_scene`` reader on a
hand-made trace."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "benchmark"))
sys.path.insert(1, str(ROOT))

from tmbench import by_name, cell as bc, control, reference, traffic  # noqa: E402
from tmbench.system import System  # noqa: E402
from triplet_match_tpu_torch.io import synthetic as port  # noqa: E402

torch.set_num_threads(2)
CELL = "lattice-matcher.fog131k"
SMALL_CELL = "small-lattice.tiny16k"
SEED = 2**31 + 151


@pytest.mark.parametrize("spec", [
    {"cells": 4, "n_edge": 20000, "size": 1.0, "graded": True, "seed": 0},
    {"cells": 3, "n_edge": 5000, "size": 1.4, "graded": False, "seed": 7},
])
def test_lattice_model_is_the_ports(spec):
    mine = by_name.load(ROOT, "models", "lattice").make(spec)
    theirs = port.make_lattice_model(cells=spec["cells"], n_edge=spec["n_edge"],
                                     size=spec["size"], seed=spec["seed"],
                                     graded=spec["graded"])
    for a, b in zip(mine, theirs, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_the_cells_configuration_is_the_recall_lattice():
    _, _, config, mix, limits = bc.find_cell(ROOT, CELL)
    assert config["models"] == [{"kind": "lattice", "cells": 4, "n_edge": 20000, "size": 1.0,
                                 "graded": True, "seed": 0}]
    assert mix["scene_seeds"] == list(range(10)) and mix["n_points"] == 131072
    # the box cells' limits but for pose_mm, set between the lattice's sound and TF32 readings
    box = json.loads((ROOT / "benchmark/limits/box-matcher.fog500k.json").read_text())
    assert limits == box | {"pose_mm": 0.4}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A checkout with one more cell: the lattice cell's configuration at
    1,200 points (16 a beam) in 16,384-point recall scans, searched with a
    small policy, held to the lattice cell's limits."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    conf = json.loads((ROOT / "benchmark/configs/lattice-matcher.json").read_text())
    conf["name"] = "small-lattice"
    conf["models"][0]["n_edge"] = 1200
    conf["policy"].update(curvature_k=10, num_first_samples=64, num_second_samples=16,
                          score_neighbors=256, max_rounds=2, adaptive_second_samples=False,
                          fine_full_rescore_ratio=0.0)
    (root / "benchmark/configs/small-lattice.json").write_text(json.dumps(conf))
    (root / "benchmark/traffic/tiny16k.json").write_text(json.dumps(
        {"scene": "recall", "n_points": 16384, "scene_seeds": [0, 1], "warm_scene_seeds": [0],
         "check_requests": 2}))
    shutil.copy(ROOT / f"benchmark/limits/{CELL}.json",
                root / f"benchmark/limits/{SMALL_CELL}.json")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "small-lattice", "source": "test", "reduced": [],
                                "file": "benchmark/configs/small-lattice.json", "why": "test"})
    manifest["workloads"].append({"name": SMALL_CELL, "config": "small-lattice",
                                  "traffic": "tiny16k", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def test_control_is_not_correct_on_the_lattice(small_root):
    c = bc.prepare(small_root, SMALL_CELL, "cpu")
    orbit = c.system.server._model.compiled.orbit.numpy()
    deg = np.degrees(np.arccos(np.clip((np.trace(orbit[:, :3, :3], axis1=1, axis2=2) - 1) / 2,
                                       -1, 1)))
    assert deg[0] == 0 and int((np.abs(deg - 120) < 1).sum()) == 2  # the turns about (1, 1, 1)
    req = traffic.Requests(SEED, len(c.pool))
    answers = {k: c.system.request(c.pool[req.slot(k)], req.search_seed(k))[0]
               for k in range(2)}
    cms = [control.ControlModel(a, c.config["find"]["dist_thres"], "cpu") for a in c.models]
    sound = bc.check(c, req, answers)
    ctl = bc.check(c, req, answers, lambda scan, a: control.answer(cms, scan, a, "cpu"))
    assert reference.judge(sound, c.limits)[0], sound
    assert not reference.judge(ctl, c.limits)[0], ctl


class _Run:
    def __init__(self, trace):
        self.trace = trace


def test_b2_ms_per_scene_reads_a_hand_made_trace():
    read = by_name.load(ROOT, "metrics", "b2_ms_per_scene").read
    trace = {"kernel_s": {"B1": [0.5], "B2": [0.004, 0.006, 0.002]},
             "range_n": {"bench.request": 2}}
    assert read(_Run(trace)) == pytest.approx(6.0)
    assert read(_Run(None)) is None
    assert read(_Run({"kernel_s": {"B2": []}, "range_n": {"bench.request": 2}})) is None
    assert read(_Run({"kernel_s": {"B2": [0.1]}, "range_n": {"bench.request": 0}})) is None
