"""The reference's fixture protocols, run with the PyTorch port on one CUDA card.

    python3 protocol_torch.py recall --model box|low-edge|lattice --points N \\
        [--seeds 10] [--settings coarse:8:32:4,exact:8:16:1]
    python3 protocol_torch.py scaling [--sizes 2097152,4194304,6291456,8388608]
    python3 protocol_torch.py baseline [--configs 1,2,3,4,5,6] [--search-seeds 5]
    python3 protocol_torch.py mesh --ranks 4 [--runs 2x2@500000:0,1x4@2097152:1,4@500000:0]

``recall`` is ``scripts/recall_study.py``: the model family's compiled
model, ``--seeds`` touching-fog scenes of ``--points`` points (seeds 0 ...),
and for each setting ``<coarse|exact>:<stride>:<keep_frac>[:<fine_stride>]``
one ``find_all`` per scene (the scene prepared inside the search, as there),
with ``dist_thres=3.0``, ``model_match_factor=0.5``, ``SampleParams(0.3,
0.95)``, ``max_icp_iterations=10``, ``seed=5``.  ``scaling`` is
``scripts/scaling_study.py``: the box model, the recall scenes of seeds 1 and
2 at each size, ``prepare_scene`` and ``find_all`` timed apart.
``baseline`` is ``scripts/run_baseline_configs.py`` at the configs' stated
sizes (no ``--small``): 1 plane detection in 10k points, 2 cylinder
detection in 12k, 3 one box in 100k points of fog patches, 4 the same in
500k with 15 ICP iterations, 5 two box models in 1M through
``find_all_multi`` with raycast verification from five origins
(``min_cast_score=None``), 6 two instances of one box in 131072.  The
scenes are ``io.synthetic.baseline_*_arrays`` (the script's, bit for bit),
searched with the script's settings, ``prepare_scene`` timed apart (config
5 hands its prep to ``find_all_multi``), then searched once more (warm),
once for each of ``--search-seeds`` (the script's search seed is 5).  Each
pose error is taken against the nearest of the box's four symmetric ground
truths (``sym_axis``: 0 the identity, 1-3 a half turn about x, y, z).

Each setting, size and config runs in a process of its own, so that one row's
out-of-memory error cannot hide another's result; the kernels are built
before any of them starts.  Each row is one JSON line: found / total (seeds
whose first match lies within 1 mm / 0.5 deg; ``matched``: seeds with any
match), each seed's pose error by ``sym_delta`` (mm, degrees), whether the
fog switch fired, ``num_second_samples_effective``, ``join_overflow_max``,
the ranking kernels' launches, the search seconds of the first call in the
process and of the later ones, ``torch.cuda.max_memory_allocated`` of each
search (reset before it), the chunks of each ``radius_sample`` call, the
reference row it is held to (``evidence_r5/``) and the card's
``nvidia-smi`` name and power limit.  A baseline row carries the same
search record, its outcome (``found``: the acceptance condition of the
config) and its reference row (``evidence_r4/configs.jsonl``,
``evidence_r5/config4_r5.jsonl`` / ``config5_r5.jsonl``); config 5 prints
one row per model, plus one stats row per model with ``raycast_s`` and the
cone cull's survivors per origin.  A row whose process fails prints
``{"FAILED": <exit code>}``.

``mesh`` runs the box model's recall scenes under multi-rank meshes on a
node with one card per rank: it starts ``--ranks`` processes with
``torch.distributed.run`` (NCCL), and for each run ``<shape>@<points>:<seed>``
(shape ``dp x sp``, ``dcn x dp x sp`` or ``n`` for the 1-axis mesh) every
rank searches the scene under the mesh twice (first, warm), rank 0 searches
it alone on its card as well, and rank 0 profiles one more warm mesh call.
Its row: found and pose error, the gap to the single device's pose and
whether every integer outcome (matches, rounds, accepts, hypotheses) is the
single device's (one chunk) or twice / n times its hypotheses (several
chunks), whether every rank returned the same matches, each rank's peak
memory and launches, the collectives' count and host ms (the "collective"
ranges) and the NCCL kernels' device ms in rank 0's profiled call, the
seconds, the backend and the card.
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


BASELINE_REFERENCE = {1: ("evidence_r4/configs.jsonl", "1_plane_10k"),
                      2: ("evidence_r4/configs.jsonl", "2_cylinder"),
                      3: ("evidence_r4/configs.jsonl", "3_rigid_100k"),
                      4: ("evidence_r5/config4_r5.jsonl", "4_icp_500k"),
                      5: ("evidence_r5/config5_r5.jsonl", "5_raycast_1m"),
                      6: ("evidence_r4/configs.jsonl", "6_two_instances_131k")}


def _ref_row(config: int, name: str) -> dict | None:
    return _reference(BASELINE_REFERENCE[config][0], lambda r: r.get("config") == name)


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def primitive_row(config: int, dev) -> dict:
    """BASELINE config 1 (plane in 10k points) or 2 (cylinder in 12k) on
    ``dev``: detection with the script's hypothesis counts and thresholds
    (the draws come from a torch generator, not the script's threefry key),
    first call and warm; the outcome against the config's acceptance
    condition (``found``: plane recall >= 0.99 and clutter rate <= 0.01;
    radius within 1 mm of 0.35 m and recall >= 0.99)."""
    import torch

    from triplet_match_tpu_torch.core.cloud import PointCloud
    from triplet_match_tpu_torch.io.synthetic import baseline_cylinder_arrays, baseline_plane_arrays
    from triplet_match_tpu_torch.primitives.detect import detect_cylinder, detect_plane

    xyz, nrm, n_true = baseline_plane_arrays() if config == 1 else baseline_cylinder_arrays()
    cloud = PointCloud.from_arrays(xyz, nrm, device=dev)

    def run():
        gen = torch.Generator().manual_seed(config - 1)
        if config == 1:
            return detect_plane(cloud, generator=gen, num_hypotheses=256, threshold=0.01)
        return detect_cylinder(cloud, generator=gen, num_hypotheses=512, threshold=0.015)

    torch.cuda.reset_peak_memory_stats()
    det, secs = _timed(run)
    _, warm = _timed(run)
    inl = det.inliers.cpu().numpy()
    row = {"protocol": "baseline", "config": config, "points": int(cloud.capacity),
           "seconds": secs, "seconds_warm": warm,
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
    if config == 1:
        recall, clutter = float(inl[:n_true].mean()), float(inl[n_true:].mean())
        row.update(name="1_plane_10k", plane_recall=recall, clutter_rate=clutter,
                   found=recall >= 0.99 and clutter <= 0.01)
    else:
        radius = float(det.state.radius)
        recall = float(inl[:n_true].mean())
        row.update(name="2_cylinder", radius=radius, radius_err=abs(radius - 0.35),
                   recall=recall, found=abs(radius - 0.35) <= 1e-3 and recall >= 0.99)
    return row


def baseline_primitive(config: int) -> None:
    """BASELINE config 1 or 2 on the card, one JSON line (``primitive_row``)."""
    dev, smi, *_ = _setup()
    row = primitive_row(config, dev)
    _emit({**row, "reference": _ref_row(config, row["name"]), "card": smi})


def _within(match, t_gt) -> tuple[float, float, int]:
    """(mm, degrees, k) against the nearest of the box's symmetric ground
    truths (k = 0: the identity; 1-3: pi about x, y, z)."""
    from triplet_match_tpu_torch.io.synthetic import sym_pose_error

    dt, dr, k = sym_pose_error(match.transform, t_gt)
    return dt * 1000.0, dr, k


def baseline_match(config: int, search_seeds=(5,)) -> None:
    """BASELINE config 3, 4, 5 or 6: compile and prepare once, then for each
    search seed (the script's is 5) search first and warm on the card, each
    timed; one row per seed, the matches against the config's acceptance
    condition."""
    dev, smi, disc, sample, policy = _setup()
    from triplet_match_tpu_torch.core.cloud import PointCloud
    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.io.synthetic import (
        baseline_match_arrays,
        baseline_two_instances_arrays,
    )
    from triplet_match_tpu_torch.search import driver

    if config == 6:
        model_arrs, scene_arrs, t_gts = baseline_two_instances_arrays(131072)
        model_arrs, name = [model_arrs], "6_two_instances_131k"
    else:
        n_clutter = {3: 100_000 - 2400, 4: 500_000 - 2400, 5: 1_000_000 - 4800}[config]
        model_arrs, scene_arrs, t_gts = baseline_match_arrays(n_clutter, two_models=config == 5)
        name = {3: "3_rigid_100k", 4: "4_icp_500k", 5: "5_raycast_1m"}[config]
    models, compile_s = [], 0.0
    for arrs in model_arrs:
        m, secs = _compile(arrs, disc, sample, policy, dev)
        models.append(m)
        compile_s += secs
    scene = PointCloud.from_arrays(*scene_arrs, device=dev)

    def prepare():
        with strict_fp32():
            return driver.prepare_scene(scene, policy)

    prep, prepare_s = _timed(prepare)
    kw = dict(sample_params=sample, discretization=disc, policy=policy, prep=prep,
              max_icp_iterations=15 if config == 4 else 10, dist_thres=3.0,
              model_match_factor=0.5)
    for seed in search_seeds:
        _baseline_rows(config, name, models, scene, t_gts, compile_s, prepare_s,
                       {**kw, "seed": seed}, smi)


def _baseline_rows(config, name, models, scene, t_gts, compile_s, prepare_s, kw, smi) -> None:
    """One search seed of a BASELINE match config: the search first and warm,
    then its rows."""
    import torch

    from triplet_match_tpu_torch.io.synthetic import BASELINE_ORIGINS
    from triplet_match_tpu_torch.search import driver, score_kernel as sk

    if config == 5:
        def search():
            return driver.find_all_multi(models, scene, raycast_origins=BASELINE_ORIGINS,
                                         min_cast_score=None, **kw)
    else:
        def search():
            return [driver.find_all(models[0], scene, **kw)]

    runs = []
    for _ in range(2):  # first call with this seed, then warm
        for c in sk.LAUNCH_COUNTERS.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        results, secs = _timed(search)
        per_model = ([dict(s) for s in driver.LAST_MULTI_SEARCH_STATS] if config == 5
                     else [dict(driver.LAST_SEARCH_STATS)])
        runs.append((results, secs, torch.cuda.max_memory_allocated() / 2**20,
                     {b: c.launches for b, c in sk.LAUNCH_COUNTERS.items()}, per_model))
    (results, secs, peak, launches, per_model), (_, warm, peak_warm, _, _) = runs
    common = {"protocol": "baseline", "config": config, "search_seed": kw["seed"],
              "scene_points": int(scene.capacity), "compile_s": compile_s,
              "prepare_s": prepare_s, "search_s": secs, "search_s_warm": warm,
              "peak_mib": peak, "peak_mib_warm": peak_warm, "launches": launches}
    if config == 5:
        for i, st in enumerate(per_model):
            surv = st.get("cast_survivors", [])
            k = len(BASELINE_ORIGINS)
            _emit({"protocol": "baseline", "config": 5, "search_seed": kw["seed"],
                   "name": f"{name}_stats{chr(65 + i)}",
                   **{key: st.get(key) for key in (
                       "search_s", "raycast_s", "rounds", "phases", "finalists", "accepted",
                       "hypotheses_scored", "num_second_samples_effective",
                       "fine_rescore_full", "rank_edges_only", "join_subset_capacity",
                       "join_overflow_max", "round_ms_avg", "ball_population_q95",
                       "coarse_kernel_launches", "exact_kernel_launches",
                       "full_kernel_launches", "coarse_linear_kernel_launches")},
                   "survivors_per_origin": [surv[j:j + k] for j in range(0, len(surv), k)],
                   "reference": _ref_row(5, f"{name}_stats{chr(65 + i)}"), "card": smi})
        for i, (matches, st) in enumerate(zip(results, per_model)):
            row = {**common, "name": f"{name}_model{chr(65 + i)}", "matches": len(matches),
                   "fog": bool(st.get("fine_rescore_full")), "cast_score": None,
                   "translation_mm": None, "rotation_deg": None, "sym_axis": None}
            if matches:
                (row["translation_mm"], row["rotation_deg"],
                 row["sym_axis"]) = _within(matches[0], t_gts[i])
                row["cast_score"] = matches[0].cast_score
            row["found"] = (len(matches) == 1 and row["translation_mm"] < 1.0
                            and row["rotation_deg"] < 0.5)
            _emit({**row, "reference": _ref_row(5, row["name"]), "card": smi})
        return
    matches, st = results[0], per_model[0]
    row = {**common, "name": name, "matches": len(matches),
           "fog": bool(st.get("fine_rescore_full")),
           "ball_population_q95": st.get("ball_population_q95"),
           "num_second_samples_effective": st.get("num_second_samples_effective"),
           "join_overflow_max": st.get("join_overflow_max"), "rounds": st.get("rounds")}
    if config == 6:  # each match to its nearest unclaimed instance, as the script pairs them
        used, deltas = set(), []
        for m in matches:
            cands = [(_within(m, tg), i) for i, tg in enumerate(t_gts) if i not in used]
            if not cands:
                break
            (dt, dr, k), i = min(cands, key=lambda c: c[0][0])
            used.add(i)
            deltas.append((dt, dr, k))
        row.update(per_instance=deltas, corrs=[len(m.scene_corrs) for m in matches],
                   worst_translation_mm=max((d[0] for d in deltas), default=None),
                   worst_rotation_deg=max((d[1] for d in deltas), default=None),
                   found=len(matches) == 2 and all(d[0] < 1.0 and d[1] < 0.5 for d in deltas))
    else:
        dt, dr, k = _within(matches[0], t_gts[0]) if matches else (None, None, None)
        row.update(translation_mm=dt, rotation_deg=dr, sym_axis=k,
                   found=len(matches) == 1 and dt < 1.0 and dr < 0.5)
    _emit({**row, "reference": _ref_row(config, name), "card": smi})


def _mesh_shape(text: str) -> dict:
    dims = [int(x) for x in text.split("x")]
    names = {1: ("chips",), 2: ("dp", "sp"), 3: ("dcn", "dp", "sp")}[len(dims)]
    return dict(zip(names, dims))


def mesh_ranks(runs: str) -> None:
    """This rank's part of the mesh protocol (under torch.distributed.run)."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from triplet_match_tpu_torch.core.transforms import pose_delta
    from triplet_match_tpu_torch.io.synthetic import model_arrays, recall_scene, sym_delta
    from triplet_match_tpu_torch.parallel import distributed as pdist
    from triplet_match_tpu_torch.parallel.mesh import COLLECTIVE
    from triplet_match_tpu_torch.search import driver, score_kernel as sk

    pdist.initialize()
    dev = torch.device("cuda", torch.cuda.current_device())
    _, smi, disc, sample, policy = _setup()
    rank, world = dist.get_rank(), dist.get_world_size()
    model, _ = _compile(model_arrays("box"), disc, sample, policy, dev)
    kw = dict(sample_params=sample, discretization=disc, policy=policy, **FIND)

    def so3(t):
        t = torch.as_tensor(t, dtype=torch.float64).clone()
        u, _, vt = torch.linalg.svd(t[:3, :3])
        t[:3, :3] = u @ vt
        return t

    for run in runs.split(","):
        shape_text, rest = run.split("@")
        points, seed = (int(x) for x in rest.split(":"))
        shape = _mesh_shape(shape_text)
        scene, t_gt = recall_scene(points, seed, device=dev)
        mesh = pdist.make_global_mesh(shape)
        got: dict = {}

        def search(mesh_or_none, key):
            got[key] = driver.find_all(model, scene, mesh=mesh_or_none, **kw)
            return got[key]

        recs = []
        for call in range(2):
            dist.barrier()
            recs.append(_search(lambda: search(mesh, "mesh"), t_gt))
            if call == 0:
                stats, matches = dict(driver.LAST_SEARCH_STATS), got["mesh"]
        mine = {"rank": rank, "peak_mib": recs[0]["peak_mib"], "launches": recs[0]["launches"],
                "transforms": [m.transform.tolist() for m in matches]}
        row = None
        if rank == 0:
            single = [_search(lambda: search(None, "single"), t_gt) for _ in range(2)]
            ref_stats, ref = dict(driver.LAST_SEARCH_STATS), got["single"]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                driver.find_all(model, scene, mesh=mesh, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            ev = prof.events()
            coll = [e for e in ev if e.name == COLLECTIVE and e.device_type == DeviceType.CPU]
            nccl = [e for e in ev if e.device_type == DeviceType.CUDA and "nccl" in e.name.lower()]
            gaps = [pose_delta(so3(a.transform), so3(b.transform))
                    for a, b in zip(matches, ref)]
            chunks = world // shape.get("sp", 1)
            row = {"protocol": "mesh", "mesh": shape, "ranks": world,
                   "backend": dist.get_backend(), "scene_points": points, "seed": seed,
                   "found": bool(recs[0]["mm"] is not None and recs[0]["mm"] < 1.0
                                 and recs[0]["deg"] < 0.5),
                   "mm": recs[0]["mm"], "deg": recs[0]["deg"], "matches": len(matches),
                   "single_matches": len(ref),
                   "gap_mm": max((float(g[0]) * 1e3 for g in gaps), default=None),
                   "gap_deg": max((float(g[1]) * 57.29577951308232 for g in gaps),
                                  default=None),
                   "hypotheses_per_round": stats["hypotheses_scored"] / stats["rounds"],
                   "single_hypotheses_per_round": (ref_stats["hypotheses_scored"]
                                                   / ref_stats["rounds"]),
                   "chunks": chunks,
                   "same_outcome_as_single": (chunks == 1 and len(matches) == len(ref) and all(
                       stats[k] == ref_stats[k] for k in ("rounds", "accepted",
                                                          "hypotheses_scored"))),
                   "fog": recs[0]["fog"], "join_overflow_max": recs[0]["join_overflow_max"],
                   "search_s_first": recs[0]["search_s"], "search_s_warm": recs[1]["search_s"],
                   "single_search_s": [r["search_s"] for r in single],
                   "profiled_wall_ms": wall * 1e3, "collectives": len(coll),
                   "collective_host_ms": sum(e.cpu_time_total for e in coll) / 1e3,
                   "nccl_device_ms": sum(e.time_range.elapsed_us() for e in nccl) / 1e3,
                   "shard": points // shape.get("sp", 1), "card": smi}
        else:
            driver.find_all(model, scene, mesh=mesh, **kw)  # rank 0's profiled call
            torch.cuda.synchronize()
        every = [None] * world
        dist.all_gather_object(every, mine)
        if rank == 0:
            row["same_matches_on_every_rank"] = all(r["transforms"] == mine["transforms"]
                                                    for r in every)
            row["peak_mib_per_rank"] = [r["peak_mib"] for r in every]
            row["launches_per_rank"] = [r["launches"] for r in every]
            print(json.dumps(row), flush=True)
        del scene
    dist.destroy_process_group()


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
    bl = sub.add_parser("baseline")
    bl.add_argument("--configs", default="1,2,3,4,5,6")
    bl.add_argument("--one", type=int, default=None, help="run one config in this process")
    bl.add_argument("--search-seeds", default="5",
                    help="the searches' seeds of configs 3-6, one row each (the script's: 5)")
    ms = sub.add_parser("mesh")
    ms.add_argument("--ranks", type=int, default=4, help="processes (one card each)")
    ms.add_argument("--runs", default="2x2@500000:0,1x4@2097152:1,4@500000:0",
                    help="<shape>@<points>:<seed>, comma-separated; shape dp x sp, "
                         "dcn x dp x sp, or n (1-axis)")
    ms.add_argument("--rank-main", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.protocol == "mesh" and args.rank_main:
        mesh_ranks(args.runs)
        return 0

    if args.protocol == "recall" and args.no_isolate:
        recall_one(args)
        return 0
    if args.protocol == "scaling" and args.one is not None:
        scaling_one(args.one)
        return 0
    if args.protocol == "baseline" and args.one is not None:
        if args.one in (1, 2):
            baseline_primitive(args.one)
        else:
            baseline_match(args.one, [int(x) for x in args.search_seeds.split(",")])
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
    elif args.protocol == "mesh":
        res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                              "--nproc-per-node", str(args.ranks), str(Path(__file__).resolve()),
                              "mesh", "--rank-main", "--runs", args.runs])
        if res.returncode != 0:
            print(json.dumps({"protocol": "mesh", "FAILED": res.returncode}), flush=True)
    elif args.protocol == "scaling":
        for s in args.sizes.split(","):
            _isolated(["scaling", "--one", s.strip()],
                      {"protocol": "scaling", "scene_points": int(s)})
    else:
        for c in args.configs.split(","):
            _isolated(["baseline", "--one", c.strip(), "--search-seeds", args.search_seeds],
                      {"protocol": "baseline", "config": int(c)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
