"""Serving kind ``matcher``: the configuration's one model in one
``api.Matcher``, the way a station serves a single part."""

from triplet_match_tpu_torch import api
from triplet_match_tpu_torch.search import driver


def build(models: list, policy, config: dict):
    if len(models) != 1:
        raise ValueError(f"serve 'matcher' takes one model, not {len(models)}")
    return api.Matcher(models[0], policy=policy)


def match(server, cloud, sample, seed: int, find: dict) -> tuple[list, list]:
    """(one list of matches per model, the program's counters per model)."""
    res = server.match(cloud, sample_params=sample, seed=seed, **find)
    return [list(res)], [dict(driver.LAST_SEARCH_STATS)]
