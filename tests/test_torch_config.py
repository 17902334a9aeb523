"""The PyTorch port's config copy and its jax-free import graph."""

import dataclasses
import subprocess
import sys
from pathlib import Path

from triplet_match_tpu import config as jcfg
from triplet_match_tpu_torch import config as tcfg

REPO = Path(__file__).resolve().parent.parent


# the port's own fields, with their defaults: each leaves the JAX package's behaviour
PORT_ONLY = {"SearchPolicy": {"exact_lut": False, "resolve_symmetry": False}}


def test_config_defaults_equal_reference():
    for name in ("SampleParams", "DiscretizationParams", "SearchPolicy"):
        ref = dataclasses.asdict(getattr(jcfg, name)())
        port = dataclasses.asdict(getattr(tcfg, name)())
        own = PORT_ONLY.get(name, {})
        assert {k: port.pop(k) for k in own} == own, name
        assert port == ref, name
    assert tcfg.DEFAULT_POLICY == tcfg.SearchPolicy()
    assert tcfg.DEFAULT_POLICY.exact_lut is False
    assert tcfg.DEFAULT_POLICY.resolve_symmetry is False


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in jax."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "triplet_match_tpu_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m.startswith('triplet_match_tpu.') or m == 'triplet_match_tpu')\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert any(m.endswith("search.driver") for m in modules)
    assert any(m.endswith("kernels.build") for m in modules)


def test_port_sources_import_no_jax():
    """No source of the port, nor any of its root scripts (chip_smoke.py,
    sass_mix.py, protocol_torch.py), has an import of jax or
    of the JAX package (a static scan, which also covers imports inside
    functions that the import test above never runs)."""
    import re

    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax\b|triplet_match_tpu(?!_torch)\b)",
                         re.MULTILINE)
    scripts = [REPO / s for s in ("chip_smoke.py", "sass_mix.py", "protocol_torch.py")]
    sources = sorted((REPO / "triplet_match_tpu_torch").rglob("*.py")) + scripts
    bad = [f"{p.relative_to(REPO)}: {m.group(0).strip()}" for p in sources
           for m in pattern.finditer(p.read_text())]
    assert not bad, bad
    assert len(sources) > 20
