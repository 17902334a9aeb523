"""Time find_all on a recall fixture with the PyTorch package of one source
tree, so that two trees can be compared on the same card.

    python3 ab_find_all.py [--tree DIR] [--points 131072] [--warm 5]

Imports ``triplet_match_tpu_torch`` from DIR (default: this checkout),
compiles the recall box model, builds the touching-fog recall scene (seed 0)
on the card, prepares it, and runs find_all with the recall-protocol
settings: one first call, ``--warm`` timed warm calls (host clock around work
that ends in a synchronize), then one warm call under torch.profiler, with
chip_smoke.py's report.  The last line of standard output is one JSON object:
the tree, the card, the warm seconds and the profiled call's numbers.

Compare two trees in alternating processes on one machine (A B B A ...): the
card's speed and the host's load vary from one machine session to the next.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

from chip_smoke import _profile, _smi  # this checkout's report, whatever tree is measured


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--points", type=int, default=131072)
    ap.add_argument("--warm", type=int, default=5)
    args = ap.parse_args()
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("ab_find_all: this run needs a CUDA card", file=sys.stderr)
        return 2
    from triplet_match_tpu_torch import config as cfg
    from triplet_match_tpu_torch.core.cloud import PointCloud
    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.index.model import compile_model
    from triplet_match_tpu_torch.io.synthetic import recall_box_model, recall_scene
    from triplet_match_tpu_torch.search import driver

    import triplet_match_tpu_torch

    if not triplet_match_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {triplet_match_tpu_torch.__file__}, not from {tree}")
    dev = torch.device("cuda", 0)
    smi = _smi()
    disc = cfg.DiscretizationParams()
    sample = cfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
    policy = cfg.SearchPolicy()
    xyz, nrm, tan = recall_box_model()
    model = compile_model(PointCloud.from_arrays(xyz, nrm, tan, device=dev), disc, sample, policy)
    scene, _ = recall_scene(args.points, seed=0, device=dev)
    with strict_fp32():
        prep = driver.prepare_scene(scene, policy)
    kw = dict(dist_thres=3.0, model_match_factor=0.5, sample_params=sample, discretization=disc,
              policy=policy, max_icp_iterations=10, seed=5)

    def call():
        return driver.find_all(model, scene, prep=prep, **kw)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    matches = call()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    warm = []
    for _ in range(args.warm):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    prof = _profile(f"ab {Path(tree).name}", call, smi)
    print(smi, flush=True)
    print(json.dumps({"tree": tree, "points": args.points, "card": smi, "matches": len(matches),
                      "first_s": first, "warm_s": warm, "warm_median_s": statistics.median(warm),
                      "profile": prof}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
