"""The JAX guard: the run must load neither JAX nor the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "triplet_match_tpu")


def forbidden_modules(names) -> list:
    """Module names whose top-level name (the part before the first dot),
    compared whole, is forbidden: ``triplet_match_tpu_torch`` passes,
    ``triplet_match_tpu.api`` does not."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check(modules=None) -> None:
    """Exit with code 3, naming what was found on standard error, if this
    process (or ``modules``, a mapping like ``sys.modules``) has loaded a
    forbidden module."""
    found = forbidden_modules(list(sys.modules if modules is None else modules))
    if found:
        print(f"jax guard: the run loaded {found}", file=sys.stderr, flush=True)
        raise SystemExit(3)
