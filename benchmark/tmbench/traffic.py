"""The one general traffic generator: models from a configuration's file,
scans from a traffic mix's file, and the order and search seeds of the
requests from ``--seed``.

A configuration lists its models, each with a ``kind`` whose generator is
``models/<kind>.py`` (``make(spec)`` -> (xyz, normal, tangent)).  A mix
names the kind of scan, whose generator is ``scenes/<kind>.py``
(``make(mix, models, scene_seed)`` -> ``Scan``), the parameters it reads,
and the scene seeds of its pool.  Every ``--seed`` serves the same pool, in
an order and with search seeds drawn from it: the fog switch and the
scoring width depend on the scan alone, so a pool drawn from ``--seed``
would change the route mix, and with it the work, from seed to seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tmbench import by_name


@dataclasses.dataclass
class Scan:
    """One scan of the pool: host arrays and the ground truth, one [4, 4]
    model -> scene pose per planted instance, with the index of its model."""

    scene_seed: int
    xyz: np.ndarray
    normal: np.ndarray
    tangent: np.ndarray
    truths: list  # [(model index, t_gt [4, 4])]


def model_arrays(root, config: dict) -> list:
    """(xyz, normal, tangent) of every model of a configuration."""
    return [by_name.load(root, "models", m["kind"]).make(m) for m in config["models"]]


def make_pool(root, mix: dict, models: list) -> list:
    """The mix's scans, one per scene seed, in the mix's order."""
    scene = by_name.load(root, "scenes", mix["scene"])
    return [scene.make(mix, models, s) for s in mix["scene_seeds"]]


def _stream(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), tag]))


class Requests:
    """The closed loop's requests under one ``--seed``: request ``k`` serves
    pool slot ``order[k % P]`` with search seed ``search_seed(k)``.  The same
    seed gives the same requests."""

    def __init__(self, seed: int, pool_size: int):
        self.seed = int(seed)
        self.order = _stream(seed, 1).permutation(pool_size)

    def slot(self, k: int) -> int:
        return int(self.order[k % len(self.order)])

    def search_seed(self, k: int) -> int:
        return int(np.random.SeedSequence([self.seed, 2, k]).generate_state(1)[0])

    def warm_seed(self, i: int) -> int:
        """Search seed of the warm-up's request for pool slot ``i``."""
        return int(np.random.SeedSequence([self.seed, 4, i]).generate_state(1)[0])

    def check_sample(self, n_done: int, n_check: int) -> list:
        """The requests the reference checks: ``n_check`` of the ``n_done``
        answered, drawn from the seed (all of them when there are fewer)."""
        if n_done <= n_check:
            return list(range(n_done))
        return sorted(int(i) for i in _stream(self.seed, 3).choice(n_done, n_check,
                                                                    replace=False))
