"""A checkout with one more cell, small enough to run whole on the CPU: a
960-point box in 6000-point recall scans, searched with a small policy, held
to ``box-matcher.fog500k``'s limits; and the program's serving object for
it, built once."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "benchmark"))
sys.path.insert(1, str(ROOT))

from tmbench import cell as bc, traffic  # noqa: E402
from tmbench.system import System  # noqa: E402

torch.set_num_threads(2)
TINY_CELL = "tiny-box.tiny6k"


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    conf = json.loads((ROOT / "benchmark/configs/box-matcher.json").read_text())
    conf["name"] = "tiny-box"
    conf["models"][0].update(n_edge=240, n_face=720)
    conf["policy"] = dict(num_first_samples=16, num_second_samples=8, query_cap=8,
                          score_neighbors=256, finalists=2, max_rounds=2,
                          adaptive_second_samples=False)
    (root / "benchmark/configs/tiny-box.json").write_text(json.dumps(conf))
    (root / "benchmark/traffic/tiny6k.json").write_text(json.dumps(
        {"scene": "recall", "n_points": 6000, "scene_seeds": [0, 1], "warm_scene_seeds": [0],
         "check_requests": 4}))
    shutil.copy(ROOT / "benchmark/limits/box-matcher.fog500k.json",
                root / f"benchmark/limits/{TINY_CELL}.json")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-box", "source": "test", "reduced": [],
                                "file": "benchmark/configs/tiny-box.json", "why": "test"})
    manifest["workloads"].append({"name": TINY_CELL, "config": "tiny-box",
                                  "traffic": "tiny6k", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


@pytest.fixture(scope="session")
def program(tiny_root):
    _, _, config, _, _ = bc.find_cell(tiny_root, TINY_CELL)
    return System(tiny_root, config, traffic.model_arrays(tiny_root, config), "cpu")
