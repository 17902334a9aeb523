"""triplet_match_tpu_torch — the PyTorch / CUDA port of ``triplet_match_tpu``.

The JAX package beside it is the reference; this package mirrors its module
layout and function names so that each counterpart is easy to find, and
imports ``torch`` and never ``jax``.  The main path is a single-device
``find_all`` of one model in one scene, through the object API

    from triplet_match_tpu_torch.api import Matcher, Model, Scene

the ``tm-match-torch`` CLI (``cli/match.py``), or the functions beneath them
(``index.model.compile_model``, ``search.driver.find_all``).

Hand-written CUDA kernels live under ``csrc/`` and are built at first use by
``kernels/build.py``.
"""

__version__ = "0.1.0"
