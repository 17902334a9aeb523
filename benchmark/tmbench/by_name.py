"""The parts of a cell found by name: one file per name in a folder per kind
under the harness's folder (``metrics/<metric>.py``, ``models/<kind>.py``,
``scenes/<kind>.py``, ``serve/<kind>.py``), so that a new metric, model,
scene or serving kind is a new file."""

from __future__ import annotations

import importlib.util
from pathlib import Path

BENCH = "benchmark"  # the harness's folder under a checkout's root


def load(root: Path, folder: str, name: str):
    """The module ``<root>/benchmark/<folder>/<name>.py``."""
    path = Path(root) / BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {folder} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"tmbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
