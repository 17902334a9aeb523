"""Build and load the package's CUDA kernels.

Each kernel is a ``csrc/*.cu`` file with a plain ``extern "C"`` launcher,
compiled by ``nvcc`` into a shared library at first use and loaded with
``ctypes``.  Libraries land in ``triplet_match_tpu_torch/_build/`` under a
name keyed by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads at once.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}  # seconds each library took to compile in this process


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists; return its path."""
    src = _SRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return lib


def load_coarse_rank() -> ctypes.CDLL:
    """The coarse-ranker library (``csrc/coarse_rank.cu``), built on first use."""
    lib = _LOADED.get("coarse_rank")
    if lib is None:
        lib = ctypes.CDLL(str(build("coarse_rank")))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.coarse_rank_launch.argtypes = [p, p, p, p, i, i, i, i, f, f, f, f, f, p]
        lib.coarse_rank_launch.restype = ctypes.c_int
        lib.coarse_rank_error_string.argtypes = [i]
        lib.coarse_rank_error_string.restype = ctypes.c_char_p
        _LOADED["coarse_rank"] = lib
    return lib
