"""The reference's fixture protocols, run with the PyTorch port on one CUDA card.

    python3 protocol_torch.py recall --model box|low-edge|lattice --points N \\
        [--seeds 10] [--settings coarse:8:32:4,exact:8:16:1]
    python3 protocol_torch.py scaling [--sizes 2097152,4194304,6291456,8388608]

``recall`` is ``scripts/recall_study.py``: the model family's compiled
model, ``--seeds`` touching-fog scenes of ``--points`` points (seeds 0 ...),
and for each setting ``<coarse|exact>:<stride>:<keep_frac>[:<fine_stride>]``
one ``find_all`` per scene (the scene prepared inside the search, as there),
with ``dist_thres=3.0``, ``model_match_factor=0.5``, ``SampleParams(0.3,
0.95)``, ``max_icp_iterations=10``, ``seed=5``.  ``scaling`` is
``scripts/scaling_study.py``: the box model, the recall scenes of seeds 1 and
2 at each size, ``prepare_scene`` and ``find_all`` timed apart.

Each setting and each size runs in a process of its own, so that one row's
out-of-memory error cannot hide another's result; the kernels are built
before any of them starts.  Each row is one JSON line: found / total (seeds
whose first match lies within 1 mm / 0.5 deg; ``matched``: seeds with any
match), each seed's pose error by ``sym_delta`` (mm, degrees), whether the
fog switch fired, ``num_second_samples_effective``, ``join_overflow_max``,
the ranking kernels' launches, the search seconds of the first call in the
process and of the later ones, ``torch.cuda.max_memory_allocated`` of each
search (reset before it), the chunks of each ``radius_sample`` call, the
reference row it is held to (``evidence_r5/``) and the card's
``nvidia-smi`` name and power limit.  A row whose process fails prints
``{"FAILED": <exit code>}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


REPO = Path(__file__).resolve().parent
# the reference rows (JAX on a TPU, round 5): recall by (model, points), then scaling
RECALL_REFERENCE = {("box", 131072): "evidence_r5/recall131k_final_r5.jsonl",
                    ("box", 500000): "evidence_r5/recall500k_final_r5.jsonl",
                    ("low-edge", 500000): "evidence_r5/recall_lowedge_final_r5.jsonl",
                    ("lattice", 131072): "evidence_r5/recall_lattice_r5.jsonl"}
SCALING_REFERENCE = "evidence_r5/scaling_final_r5.jsonl"
FIND = dict(dist_thres=3.0, model_match_factor=0.5, max_icp_iterations=10, seed=5)


def _reference(path: str, match) -> dict | None:
    """The first JSON row of ``path`` (in this checkout) for which ``match``
    holds, with its file name; None without the file."""
    p = REPO / path
    if not p.exists():
        return None
    for line in p.read_text().splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            if match(row):
                row.pop("per_seed", None)
                return {"file": path, **row}
    return None


def _setup():
    """The card, its nvidia-smi line and the recall protocol's parameters."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("protocol_torch: torch.cuda.is_available() is False; this run needs a "
                         "CUDA card")
    from triplet_match_tpu_torch import config as cfg
    from triplet_match_tpu_torch.kernels.build import card_line

    sample = cfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
    return (torch.device("cuda", 0), card_line(), cfg.DiscretizationParams(), sample,
            cfg.SearchPolicy())


def _compile(arrays, disc, sample, policy, dev):
    import torch

    from triplet_match_tpu_torch.core.cloud import PointCloud
    from triplet_match_tpu_torch.index.model import compile_model

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = compile_model(PointCloud.from_arrays(*arrays, device=dev), disc, sample, policy)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def _search(run, t_gt) -> dict:
    """One timed search (``run()`` returns the matches) with the peak memory
    reset before it and every launch count zeroed; its record."""
    import torch

    from triplet_match_tpu_torch.io.synthetic import sym_delta
    from triplet_match_tpu_torch.search import driver, score_kernel as sk

    for c in sk.LAUNCH_COUNTERS.values():
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    matches = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    stats = driver.LAST_SEARCH_STATS
    rec = {"search_s": secs, "matches": len(matches), "mm": None, "deg": None,
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "fog": bool(stats.get("fine_rescore_full")),
           "ball_population_q95": stats.get("ball_population_q95"),
           "num_second_samples_effective": stats.get("num_second_samples_effective"),
           "join_overflow_max": stats.get("join_overflow_max"),
           "rounds": stats.get("rounds"),
           "launches": {b: c.launches for b, c in sk.LAUNCH_COUNTERS.items()}}
    if matches:
        dt, dr = sym_delta(matches[0].transform, t_gt)
        rec["mm"], rec["deg"] = dt * 1000.0, dr
    return rec


def _summary(recs: list) -> dict:
    """found (a first match within 1 mm / 0.5 deg), worst errors, the route
    and the times and peaks over a row's searches."""
    ok = [r for r in recs if r["mm"] is not None and r["mm"] < 1.0 and r["deg"] < 0.5]
    hit = [r for r in recs if r["mm"] is not None]
    secs = [r["search_s"] for r in recs]
    return {"found": len(ok), "matched": len(hit), "total": len(recs),
            "max_translation_mm": max((r["mm"] for r in hit), default=None),
            "max_rotation_deg": max((r["deg"] for r in hit), default=None),
            "fog_fired": sum(r["fog"] for r in recs),
            "num_second_samples_effective": sorted({r["num_second_samples_effective"]
                                                    for r in recs}),
            "join_overflow_max": max(r["join_overflow_max"] for r in recs),
            "launches": {b: sum(r["launches"][b] for r in recs) for b in recs[0]["launches"]},
            "search_s_first": secs[0],
            "search_s_warm_median": statistics.median(secs[1:]) if len(secs) > 1 else None,
            "peak_mib_max": max(r["peak_mib"] for r in recs)}


def _chunks(n: int, policy) -> int:
    from triplet_match_tpu_torch.ops.knn import radius_chunk_cols

    return -(-n // radius_chunk_cols(n, min(policy.num_first_samples, 256)))


def recall_one(args) -> None:
    """One setting of the recall protocol in this process."""
    dev, smi, disc, sample, base = _setup()
    from triplet_match_tpu_torch.io.synthetic import model_arrays, recall_scene
    from triplet_match_tpu_torch.search import driver

    kind, stride, keep, *fine = args.settings.split(":")
    policy = dataclasses.replace(base, two_phase_stride=int(stride),
                                 two_phase_keep_frac=int(keep),
                                 two_phase_coarse_model=(kind == "coarse"),
                                 two_phase_fine_stride=int(fine[0]) if fine else 1)
    arrays = model_arrays(args.model)
    model, compile_s = _compile(arrays, disc, sample, base, dev)
    recs = []
    for seed in range(args.seeds):
        scene, t_gt = recall_scene(args.points, seed, arrays=arrays, device=dev)
        rec = _search(lambda: driver.find_all(model, scene, sample_params=sample,
                                              discretization=disc, policy=policy, **FIND), t_gt)
        recs.append({"seed": seed, **rec})
        del scene
    setting = f"{kind}:{stride}:{keep}:{fine[0] if fine else 1}"
    ref = RECALL_REFERENCE.get((args.model, args.points))
    print(json.dumps({
        "protocol": "recall", "model": args.model, "points": args.points, "setting": setting,
        **_summary(recs), "compile_model_s": compile_s, "lut": list(model.lut.shape),
        "radius_sample_chunks": _chunks(args.points, policy), "per_seed": recs,
        "reference": ref and _reference(ref, lambda r: r["setting"].split()[0] == setting),
        "card": smi}), flush=True)


def scaling_one(n_pts: int) -> None:
    """One size of the scaling protocol in this process."""
    import torch

    dev, smi, disc, sample, policy = _setup()
    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.io.synthetic import model_arrays, recall_scene
    from triplet_match_tpu_torch.search import driver

    model, compile_s = _compile(model_arrays("box"), disc, sample, policy, dev)
    recs = []
    for seed in (1, 2):
        scene, t_gt = recall_scene(n_pts, seed, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with strict_fp32():
            prep = driver.prepare_scene(scene, policy)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        rec = _search(lambda: driver.find_all(model, scene, sample_params=sample,
                                              discretization=disc, policy=policy, prep=prep,
                                              **FIND), t_gt)
        recs.append({"seed": seed, "prepare_s": prep_s, **rec})
        del scene, prep
    print(json.dumps({
        "protocol": "scaling", "scene_points": n_pts, **_summary(recs),
        "prepare_s_first": recs[0]["prepare_s"], "prepare_s_steady": recs[1]["prepare_s"],
        "search_s_steady": recs[1]["search_s"], "compile_model_s": compile_s,
        "radius_sample_chunks": _chunks(n_pts, policy), "per_seed": recs,
        "reference": _reference(SCALING_REFERENCE, lambda r: r["scene_points"] == n_pts),
        "card": smi}), flush=True)


def _isolated(argv: list[str], failed: dict) -> None:
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()), *argv])
    if res.returncode != 0:
        print(json.dumps({**failed, "FAILED": res.returncode}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="protocol", required=True)
    rc = sub.add_parser("recall")
    rc.add_argument("--model", choices=["box", "low-edge", "lattice"], default="box")
    rc.add_argument("--points", type=int, default=131072)
    rc.add_argument("--seeds", type=int, default=10)
    rc.add_argument("--settings", default="coarse:8:32:4,exact:8:16:1")
    rc.add_argument("--no-isolate", action="store_true", help="run one setting in this process")
    sc = sub.add_parser("scaling")
    sc.add_argument("--sizes", default="2097152,4194304,6291456,8388608")
    sc.add_argument("--one", type=int, default=None, help="run one size in this process")
    args = ap.parse_args()

    if args.protocol == "recall" and args.no_isolate:
        recall_one(args)
        return 0
    if args.protocol == "scaling" and args.one is not None:
        scaling_one(args.one)
        return 0
    _setup()
    from triplet_match_tpu_torch.kernels.build import build_all

    build_all()  # on disk for the rows' processes, before any timed call
    if args.protocol == "recall":
        for s in args.settings.split(","):
            _isolated(["recall", "--no-isolate", "--model", args.model, "--points",
                       str(args.points), "--seeds", str(args.seeds), "--settings", s.strip()],
                      {"protocol": "recall", "model": args.model, "points": args.points,
                       "setting": s.strip()})
    else:
        for s in args.sizes.split(","):
            _isolated(["scaling", "--one", s.strip()],
                      {"protocol": "scaling", "scene_points": int(s)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
