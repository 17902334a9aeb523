"""The JAX guard compares whole top-level module names, both ways, and
withholds the result of a run that loaded a forbidden module after its
window."""

from __future__ import annotations

import importlib.util
import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "benchmark"))

from tmbench import cell as bc, guard  # noqa: E402

CELL = "tiny-box.tiny6k"  # conftest.py's
LATE = "triplet_match_tpu.loaded_after_the_window"


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib", "jaxlib.xla_client", "flax",
                                  "flax.linen", "triplet_match_tpu", "triplet_match_tpu.api"])
def test_forbidden(name):
    assert guard.forbidden_modules([name, "numpy"]) == [name]


@pytest.mark.parametrize("name", ["triplet_match_tpu_torch", "triplet_match_tpu_torch.api",
                                  "jaxtyping", "numpy.jax", "torch", "tmbench.guard"])
def test_allowed(name):
    assert guard.forbidden_modules([name]) == []


def test_check_exits_and_names_the_module(capsys):
    clean = {"torch": None, "triplet_match_tpu_torch.api": None}
    guard.check(clean)
    with pytest.raises(SystemExit) as exc:
        guard.check(dict(clean, **{"triplet_match_tpu.fake": None}))
    assert exc.value.code != 0
    assert "triplet_match_tpu.fake" in capsys.readouterr().err


def test_result_withheld_when_loaded_after_the_window(tiny_root, program, tmp_path, capsys):
    """A metric reader, which runs after the window's last check, loads a
    module of the JAX package: the run's checks inside pass, and ``run.py``
    exits with code 3 and prints no result."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    (root / "benchmark/metrics/late_import.py").write_text(
        "import sys\nimport types\n\n\ndef read(run):\n"
        f"    sys.modules[{LATE!r}] = types.ModuleType({LATE!r})\n    return 1.0\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["end_to_end"].append({"name": "late_import", "unit": "s", "better": "lower",
                                   "bound": 0.25, "source": "host_clock", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    spec = importlib.util.spec_from_file_location("bench_run", ROOT / "benchmark/run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    assert not guard.forbidden_modules(sys.modules)
    try:
        result, rows, notes = bc.run_cell(root, CELL, 2**31 + 5, 0.5, False,
                                          time.perf_counter(), device="cpu",
                                          system_factory=lambda *a: program,
                                          guard=guard.check)
        assert "late_import" in result["metrics"] and LATE in sys.modules
        capsys.readouterr()
        with pytest.raises(SystemExit) as exc:
            run.emit(result, rows, notes)
        assert exc.value.code == 3
        out = capsys.readouterr()
        assert out.out == "" and LATE in out.err
    finally:
        sys.modules.pop(LATE, None)
