"""BENCHMARK.json's form (keys, names, units, lengths), and the harness
finding every file of a cell by name, a file-only addition included."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "benchmark"))

from tmbench import cell as bc, traffic  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MANIFEST["paths"])


def test_names_units_and_lines():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = []
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"]) and w["config"] in names
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}) == len(cells)
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for m in MANIFEST[kind]:
            allowed = {"name", "unit", "better", "source", "workloads"}
            allowed |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            assert set(m) <= allowed
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
            assert set(m.get("workloads", [])) <= set(cells)
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert _line(m["layer"])
            if m["name"].endswith("_roofline"):
                assert m["unit"] == "%"
            metrics.append(m["name"])
    assert len(set(metrics)) == len(metrics)
    assert "setup_s" in metrics


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_exist(cell):
    _, entry, config, mix, limits = bc.find_cell(ROOT, cell)
    assert config["name"] == entry["config"] and mix["scene_seeds"] and limits
    assert set(mix["warm_scene_seeds"]) <= set(mix["scene_seeds"])
    kinds = [("scenes", mix["scene"]), ("serve", config["serve"])]
    kinds += [("models", m["kind"]) for m in config["models"]]
    for folder, kind in kinds:
        assert (ROOT / "benchmark" / folder / f"{kind}.py").is_file(), (folder, kind)
    for kind in ("end_to_end", "per_layer"):
        for m in bc.metrics_of(MANIFEST, cell, kind):
            assert callable(bc.reader(ROOT, m["name"]))


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_reports_setup_a_metric_and_each_moved_metric(cell):
    e2e = {m["name"] for m in bc.metrics_of(MANIFEST, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = bc.metrics_of(MANIFEST, cell, "per_layer")
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], m["moves"], cell)


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


VARIED_SCENE = '''"""Recall scans whose size is drawn per scan from the mix's range."""

import numpy as np

from tmbench import synthetic
from tmbench.traffic import Scan


def make(mix, models, scene_seed):
    lo, hi = mix["size_range"]
    n = int(round(mix["n_points"] * np.random.default_rng(scene_seed).uniform(lo, hi)))
    x, nrm, t, t_gt = synthetic.recall_scene_arrays(n, scene_seed, models[0])
    return Scan(scene_seed, x, nrm, t, [(0, t_gt)])
'''


def test_file_only_addition_is_picked_up(tmp_path):
    """A new scene kind whose scans draw their sizes, a mix of it, its limits
    and a manifest entry make a new cell: no file the harness already had
    changes, and the pool holds scans of the drawn sizes."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path)
    manifest = json.loads(json.dumps(MANIFEST))
    (tmp_path / "benchmark/scenes/varied.py").write_text(VARIED_SCENE)
    (tmp_path / "benchmark/traffic/vary6k.json").write_text(json.dumps(
        {"scene": "varied", "n_points": 6000, "size_range": [0.65, 1.35],
         "scene_seeds": [10, 11, 12, 13], "warm_scene_seeds": [10], "check_requests": 4}))
    (tmp_path / "benchmark/limits/box-matcher.vary6k.json").write_text(json.dumps(
        {"pose_mm": 1.0, "pose_deg": 0.5}))
    manifest["workloads"].append({"name": "box-matcher.vary6k", "config": "box-matcher",
                                  "traffic": "vary6k", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    _, entry, config, mix, limits = bc.find_cell(tmp_path, "box-matcher.vary6k")
    assert entry["traffic"] == "vary6k" and mix["scene"] == "varied"
    assert config["name"] == "box-matcher" and limits["pose_mm"] == 1.0
    names = {m["name"] for m in bc.metrics_of(manifest, "box-matcher.vary6k", "end_to_end")}
    assert {"scenes_per_s", "peak_mib", "setup_s"} <= names
    models = traffic.model_arrays(tmp_path, config)
    pool = traffic.make_pool(tmp_path, mix, models)
    sizes = [scan.xyz.shape[0] for scan in pool]
    assert [scan.scene_seed for scan in pool] == [10, 11, 12, 13]
    assert len(set(sizes)) == 4 and all(3900 <= n <= 8100 for n in sizes), sizes
    assert all(scan.truths[0][1].shape == (4, 4) for scan in pool)
    after = _digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


def test_unknown_kind_is_named():
    with pytest.raises(ValueError, match="no scenes file"):
        traffic.make_pool(ROOT, {"scene": "no_such_kind", "scene_seeds": [0]}, [])
