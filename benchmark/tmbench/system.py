"""The system under test: ``triplet_match_tpu_torch`` served as its users
serve it, by the configuration's serving kind (``serve/<kind>.py``: ``build``
the server from the compiled models, ``match`` one scan), with each request
handed over as host arrays.

This module and the serving kinds are the benchmark's only importers of the
program.  Besides the serving objects they read the program's counters
(``search.driver.LAST_SEARCH_STATS``) and, in a traced run, record the
inputs of the ranking kernels' launches by wrapping
``search.score_kernel.score_groups_coarse`` (B1) and ``score_groups_exact``
(B2 in count mode) from outside.
"""

from __future__ import annotations

import numpy as np
import torch

from tmbench import by_name


def _match_dict(m) -> dict:
    return {"transform": np.asarray(m.transform), "scene_corrs": np.asarray(m.scene_corrs),
            "model_corrs": np.asarray(m.model_corrs), "signed_score": float(m.signed_score)}


def _route(st: dict) -> str:
    """The route a search took, by the program's counters: the fog-density
    route or the standard one, and the second-sample count it ran."""
    kind = "fog" if st.get("fine_rescore_full") else "standard"
    return f"{kind}, {st.get('num_second_samples_effective')} second samples"


class System:
    def __init__(self, root, config: dict, model_arrays: list, device):
        from triplet_match_tpu_torch import api, config as cfg
        from triplet_match_tpu_torch.core.cloud import PointCloud

        self._cloud = PointCloud
        self.device = torch.device(device)
        disc = cfg.DiscretizationParams(**config.get("discretization", {}))
        policy = cfg.SearchPolicy(**config.get("policy", {}))
        self.sample = cfg.SampleParams(**config.get("sample_params", {}))
        self.find = dict(config["find"])
        models = [api.Model(PointCloud.from_arrays(*a, device=self.device), disc, policy)
                  .init(self.sample) for a in model_arrays]
        self.serve = by_name.load(root, "serve", config["serve"])
        self.server = self.serve.build(models, policy, config)

    def request(self, scan, search_seed: int) -> tuple[list, dict]:
        """One request: upload the scan, search it, return (one list of match
        dicts per model, the program's counters for it)."""
        with torch.profiler.record_function("bench.request"):
            with torch.profiler.record_function("bench.upload"):
                cloud = self._cloud.from_arrays(scan.xyz, scan.normal, scan.tangent,
                                                device=self.device)
            res, per = self.serve.match(self.server, cloud, self.sample, search_seed,
                                        self.find)
        answer = [[_match_dict(m) for m in ms] for ms in res]
        stats = {"hypotheses": sum(int(s.get("hypotheses_scored", 0)) for s in per),
                 "rounds": sum(int(s.get("rounds", 0)) for s in per),
                 "route": " + ".join(_route(s) for s in per)}
        return answer, stats


class KernelRecorder:
    """Holds the inputs of the first ``limit`` launches of B1 and of B2 made
    while ``active``: references only, no copy and no device work, so the
    window's device time stays the program's.  Counted after the window."""

    def __init__(self, limit: int = 4):
        from triplet_match_tpu_torch.search import score_kernel as sk

        self.sk = sk
        self.limit = limit
        self.active = False
        self.b1: list = []
        self.b2: list = []
        self._orig = (sk.score_groups_coarse, sk.score_groups_exact)
        coarse, exact = self._orig

        def coarse_rec(mpack, groups, poses, *a, block="coarse", **kw):
            if self.active and len(self.b1) < self.limit and groups.is_cuda:
                i = 0 if block == "coarse" else 1
                md = mpack.md_coarse if i == 0 else mpack.md_fine
                self.b1.append((groups, poses, md, mpack.n_edge_reps[i], mpack.n_reps[i]))
            return coarse(mpack, groups, poses, *a, block=block, **kw)

        def exact_rec(mpack, groups, poses, dist_thres2, *, mode="count", **kw):
            if (self.active and mode == "count" and len(self.b2) < self.limit
                    and groups.is_cuda):
                me, ms = sk.exact_blocks(mpack)
                self.b2.append((groups, poses, me, ms, mpack.center,
                                float(np.float32(dist_thres2)),
                                bool(kw.get("negative_scores", False))))
            return exact(mpack, groups, poses, dist_thres2, mode=mode, **kw)

        sk.score_groups_coarse, sk.score_groups_exact = coarse_rec, exact_rec

    def close(self):
        self.sk.score_groups_coarse, self.sk.score_groups_exact = self._orig
        self.active = False
