"""Scene kind ``recall``: the recall protocol's scan, one instance of the
configuration's first model at a random pose with 1 mm noise, then touching
fog patches up to the mix's ``n_points`` (``synthetic.recall_scene_arrays``)."""

from tmbench import synthetic
from tmbench.traffic import Scan


def make(mix: dict, models: list, scene_seed: int) -> Scan:
    x, n, t, t_gt = synthetic.recall_scene_arrays(mix["n_points"], scene_seed, models[0])
    return Scan(scene_seed, x, n, t, [(0, t_gt)])
