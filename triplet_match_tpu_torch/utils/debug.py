"""Debug dump helpers (counterpart of ``triplet_match_tpu.utils.debug``).

Mirrors the reference's debug tooling: the ``to_grayscale_image`` PGM matrix
dump (include/impl/debug.hpp:8-33), ``pdebug`` / ``println``
(include/common:91-102), and the feature-histogram dump the model writes to
/tmp/out0.dat (impl/model.hpp:151-164), here an explicit, opt-in API.  The
files are byte for byte the JAX package's.
"""

from __future__ import annotations

import os
import sys

import numpy as np

DEBUG = bool(int(os.environ.get("TM_DEBUG", "0")))


def pdebug(fmt: str, *args):
    if DEBUG:
        print("[D] " + (fmt.format(*args) if args else fmt), file=sys.stderr)


def println(fmt: str, *args):
    print(fmt.format(*args) if args else fmt)


def to_grayscale_image(path: str, matrix) -> None:
    """Write a matrix (array or tensor) as a binary PGM, min-max normalized
    (impl/debug.hpp:8-33)."""
    if hasattr(matrix, "detach"):
        matrix = matrix.detach().cpu().numpy()
    m = np.asarray(matrix, np.float64)
    lo, hi = float(np.nanmin(m)), float(np.nanmax(m))
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    img = ((m - lo) * scale).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


def feature_histograms(model, path: str | None = None):
    """Histogram the first two discrete-feature dims of a compiled model's
    pair table (the reference dumps these to /tmp/out0.dat,
    impl/model.hpp:151-164).  Returns (hist_d0, hist_a1); writes the
    two-line space-separated format when ``path`` is given."""
    keys = model.keys[: int(model.pair_count)].cpu().numpy().astype(np.int64)
    h0 = np.bincount(keys >> 20)
    h1 = np.bincount((keys >> 10) & 0x3FF)
    if path:
        with open(path, "w") as f:
            f.write(" ".join(str(int(v)) for v in h0) + "\n")
            f.write(" ".join(str(int(v)) for v in h1) + "\n")
    return h0, h1
