"""Build and load the package's CUDA kernels.

Each kernel is a ``csrc/*.cu`` file with a plain ``extern "C"`` launcher
(``<name>_launch``, returning the launch's ``cudaError_t``), compiled by
``nvcc`` into a shared library at first use and loaded with ``ctypes``.  Two
kernels may share device code through a ``csrc/*.cuh`` header.  Libraries
land in ``triplet_match_tpu_torch/_build/`` under a name keyed by a hash of
the source, the headers and the flags, so an edited source or header rebuilds
and an unchanged one loads at once.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}  # seconds each library took to compile in this process
BUILD_LOG: dict[str, str] = {}  # nvcc's output of each compile in this process


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str, ptxas_info: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists; return its path.

    ``ptxas_info`` adds ``-Xptxas -v`` (registers, shared memory, spills, kept
    in ``BUILD_LOG``); it does not change the library, so not its name.
    """
    src = _SRC / f"{name}.cu"
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(_SRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    verbose = ("-Xptxas", "-v") if ptxas_info else ()
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *verbose, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    BUILD_LOG[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return lib


def _load(name: str, argtypes: list) -> ctypes.CDLL:
    """Build (first use) and load ``csrc/<name>.cu``; bind ``<name>_launch``
    (returns a cudaError_t as int) and ``<name>_error_string``."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = argtypes
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# B1 and B4: groups, poses, block, out, g, hg, k, ld, n_edge, n_reps, the
# centre (3), t2, off, t2s, w_inf, w_str, cross, stream
_COARSE_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _I, _P]


def load_coarse_rank() -> ctypes.CDLL:
    """The coarse-ranker library (``csrc/coarse_rank.cu``), built on first use."""
    return _load("coarse_rank", _COARSE_ARGS)


def load_exact_rank() -> ctypes.CDLL:
    """The exact-ranker library (``csrc/exact_rank.cu``), built on first use."""
    # groups, poses, me, ne, ld_e, ms, ns, ld_s, score, count, g, hg, k, npt,
    # the centre (3), t2, inv2t, weighted, negative, stream
    return _load("exact_rank", [_P, _P, _P, _I, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _F, _F,
                                _F, _F, _F, _I, _I, _P])


def load_full_rank() -> ctypes.CDLL:
    """The orientation-weighted ranker library (``csrc/full_rank.cu``), built on first use."""
    # as exact_rank, with re, ld_re, rs, ld_rs after the blocks and eps after inv2t
    return _load("full_rank", [_P, _P, _P, _I, _I, _P, _I, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                               _I, _F, _F, _F, _F, _F, _F, _I, _I, _P])


def load_coarse_linear_rank() -> ctypes.CDLL:
    """The linearised coarse-ranker library (``csrc/coarse_linear_rank.cu``), built on first use."""
    return _load("coarse_linear_rank", _COARSE_ARGS)


# every kernel source with its loader: the TPU kernels B1, B2, B3 and B4, in order
SOURCES = {"coarse_rank": load_coarse_rank, "exact_rank": load_exact_rank,
           "full_rank": load_full_rank, "coarse_linear_rank": load_coarse_linear_rank}


def build_all(ptxas_info: bool = False) -> None:
    """Compile every kernel source (one ``nvcc`` each, started together) and
    load each library; ``ptxas_info`` as in ``build``."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(lambda name: build(name, ptxas_info=ptxas_info), SOURCES))
    for load in SOURCES.values():
        load()


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
