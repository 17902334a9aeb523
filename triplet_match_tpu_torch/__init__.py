"""triplet_match_tpu_torch — the PyTorch / CUDA port of ``triplet_match_tpu``.

The JAX package beside it is the reference; this package mirrors its module
layout and function names so that each counterpart is easy to find, and
imports ``torch`` and never ``jax``.  The main path is a single-device
``find_all`` of one model in one scene:

    from triplet_match_tpu_torch.core.cloud import PointCloud
    from triplet_match_tpu_torch.index.model import compile_model
    from triplet_match_tpu_torch.search.driver import find_all

Hand-written CUDA kernels live under ``csrc/`` and are built at first use by
``kernels/build.py``.
"""

__version__ = "0.1.0"
