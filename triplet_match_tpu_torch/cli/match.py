"""CLI: find rigid instances of a model cloud inside a scene cloud, on the
PyTorch port (counterpart of ``triplet_match_tpu.cli.match``, ``tm-match``).

    tm-match-torch model.pcd scene.pcd \\
        [--dist-thres 3.0] [--model-match-factor 0.4] [--seed 13] \\
        [--distance-steps 20] [--angle-step-deg 10] \\
        [--min-diameter-factor 0.3] [--max-diameter-factor 0.95] \\
        [--max-icp 10] [--save-model model.npz] [--out matches.json] [--cpu] \
        [--dp N] [--sp N] [--dcn N] [--host-devices N]

(or ``python -m triplet_match_tpu_torch.cli.match ...``).  The search runs on
the CUDA card, or with ``--cpu`` on the CPU.  Exit code 0 with matches, 2
without, 1 when the ranks cannot form the requested mesh.  The JSON result
goes to stdout or ``--out``, progress to stderr; under several ranks rank 0
alone writes them.

Multi-device, with the JAX CLI's meaning: ``--dp`` runs one RANSAC chunk per
rank with a finalist join, ``--sp`` also shards every scene array (the
capacity is padded to a multiple), ``--dcn`` adds an outer axis with a
hierarchical join.  The ranks come from ``torchrun`` (one per card, NCCL;
the CLI initialises from its environment), or, with ``--host-devices N``,
the CLI starts N ranks on this machine itself (``parallel.distributed.
run_local``: NCCL when each has a card of its own, gloo when they share one
card or run on the CPU).

The demo app's discretization {0.05 distance fraction, 10 deg}
(apps/triplet_match.cpp:17-20) maps to --distance-steps 20 --angle-step-deg 10.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from triplet_match_tpu_torch.api import Model, Scene
from triplet_match_tpu_torch.config import DEFAULT_POLICY, DiscretizationParams, SampleParams
from triplet_match_tpu_torch.core.cloud import pad_capacity
from triplet_match_tpu_torch.io.pcd import read_pcd
from triplet_match_tpu_torch.utils.progress import ProgressBar
from triplet_match_tpu_torch.utils.trace import device_trace

POLICY = DEFAULT_POLICY  # the search policy (the JAX CLI's too: it has no policy flags)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tm-match-torch",
        description="Rigid model-in-scene point cloud matching (PyTorch / CUDA).",
    )
    p.add_argument("model_pcd", help="model point cloud (.pcd) or compiled model (.npz)")
    p.add_argument("scene_pcd", help="scene point cloud (.pcd)")
    p.add_argument("--dist-thres", type=float, default=3.0,
                   help="correspondence threshold in multiples of model resolution")
    p.add_argument("--model-match-factor", type=float, default=0.4)
    p.add_argument("--early-out-factor", type=float, default=0.9)
    p.add_argument("--max-icp", type=int, default=10)
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--distance-steps", type=int, default=20)
    p.add_argument("--angle-step-deg", type=float, default=10.0)
    p.add_argument("--min-diameter-factor", type=float, default=0.3)
    p.add_argument("--max-diameter-factor", type=float, default=0.95)
    p.add_argument("--force-up", action="store_true")
    p.add_argument("--estimate-tangents", action="store_true",
                   help="derive edge tangents geometrically (normal x pc_max_dir) "
                        "for clouds that lack tangent fields")
    p.add_argument("--save-model", help="serialize the compiled model index (.npz)")
    p.add_argument("--out", help="write matches as JSON")
    p.add_argument("--profile-dir", help="write a torch.profiler Chrome trace of the search")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel mesh axis: each of N ranks RANSACs its own hypothesis "
                        "chunk (parallel/search.py)")
    p.add_argument("--sp", type=int, default=1,
                   help="scene-sharding mesh axis: scene arrays split across N ranks "
                        "(parallel/search2d.py); the scene capacity is padded to a multiple")
    p.add_argument("--dcn", type=int, default=1,
                   help="outer mesh axis with a hierarchical finalist join")
    p.add_argument("--host-devices", type=int,
                   help="run the search on N ranks of this machine (spawned processes)")
    p.add_argument("--quiet", action="store_true")
    return p


def _build_mesh(args, device_type: str):
    """The mesh the flags ask for, over the ranks of the process group (None
    for one rank without mesh flags)."""
    from torch.distributed import get_world_size, is_initialized

    from triplet_match_tpu_torch.parallel import mesh as pmesh
    from triplet_match_tpu_torch.parallel import search2d

    n = args.dcn * args.dp * args.sp
    world = get_world_size() if is_initialized() else 1
    if n == 1 and world == 1:
        return None
    if world > n:
        raise ValueError(f"the mesh flags ask for {n} ranks, the process group has {world}")
    if args.dcn > 1:
        return search2d.make_mesh_3d(args.dcn, args.dp, args.sp, device_type=device_type)
    if args.sp > 1:
        return search2d.make_mesh_2d(args.dp, args.sp, device_type=device_type)
    return pmesh.make_mesh(args.dp, device_type=device_type)


def _rank_main(argv, policy) -> int:
    """``main`` on one rank of a ``--host-devices`` run, under the spawning
    process's search policy."""
    global POLICY
    POLICY = policy
    return main(argv)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device_type = "cpu" if args.cpu else "cuda"
    if args.host_devices and args.host_devices > 1:
        from triplet_match_tpu_torch.parallel.distributed import run_local

        rest = list(sys.argv[1:] if argv is None else argv)
        i = rest.index("--host-devices")
        del rest[i:i + 2]
        return run_local(_rank_main, args.host_devices, None, rest, POLICY,
                         device_type=device_type)
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        from triplet_match_tpu_torch.parallel.distributed import initialize

        initialize(device_type=device_type)  # torchrun
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    log = ((lambda *a: None) if args.quiet or not rank0
           else (lambda *a: print(*a, file=sys.stderr)))
    try:
        mesh = _build_mesh(args, device_type)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if mesh is not None:
        log(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over {mesh.size()} ranks, "
            f"backend {dist.get_backend()}")

    device = torch.device("cpu" if args.cpu else "cuda")
    disc = DiscretizationParams(distance_step_count=args.distance_steps,
                                angle_step=math.radians(args.angle_step_deg))
    sample = SampleParams(min_diameter_factor=args.min_diameter_factor,
                          max_diameter_factor=args.max_diameter_factor, force_up=args.force_up)

    def maybe_estimate(cloud, what):
        if not args.estimate_tangents:
            return cloud
        from triplet_match_tpu_torch.ops.curvature import estimate_edge_tangents

        est = estimate_edge_tangents(cloud, k=30)
        log(f"{what}: estimated tangents for "
            f"{int((torch.linalg.vector_norm(est, dim=-1) > 0.5).sum())} edge points")
        return dataclasses.replace(cloud, tangent=est)

    t0 = time.perf_counter()
    if args.model_pcd.endswith(".npz"):
        model = Model.load(args.model_pcd, disc, POLICY, device=device)
        log(f"loaded compiled model: {args.model_pcd}")
    else:
        model_cloud = maybe_estimate(read_pcd(args.model_pcd, device=device), "model")
        log(f"model: {int(model_cloud.count())} points")
        model = Model(model_cloud, disc, POLICY).init(sample)
    log(f"model ready in {time.perf_counter() - t0:.2f}s: diameter={model.diameter():.4f} "
        f"resolution={model.resolution():.5f} edge_points={model.point_count()} "
        f"pairs={model.pair_count()}")
    if args.save_model and rank0:
        model.save(args.save_model)
        log(f"compiled model saved to {args.save_model}")

    scene_cloud = maybe_estimate(read_pcd(args.scene_pcd, device=device), "scene")
    if args.sp > 1:
        scene_cloud = pad_capacity(scene_cloud, args.sp)
    log(f"scene: {int(scene_cloud.count())} points")
    scene = Scene(scene_cloud, POLICY)

    bar = None if args.quiet or not rank0 else ProgressBar(prefix="search ")
    t1 = time.perf_counter()
    tracer = (device_trace(args.profile_dir) if args.profile_dir and rank0
              else contextlib.nullcontext())
    with tracer:
        matches = scene.find_all_parallel(
            model, dist_thres=args.dist_thres, model_match_factor=args.model_match_factor,
            early_out_factor=args.early_out_factor, sample_params=sample,
            max_icp_iterations=args.max_icp, seed=args.seed, mesh=mesh,
            progress=bar.poll if bar else None)
    if args.profile_dir:
        log(f"device trace written to {args.profile_dir}")
    dt = time.perf_counter() - t1
    if bar:
        bar.finish()

    st = scene.statistics
    log(f"search: {len(matches)} match(es) in {dt:.2f}s ({st.rounds} rounds, "
        f"{st.hypotheses_scored} hypotheses, rejection_rate={st.rejection_rate:.3f})")
    out = []
    for i, m in enumerate(matches):
        out.append({"transform": np.asarray(m.transform).tolist(),
                    "scene_corr_count": int(len(m.scene_corrs)),
                    "signed_score": m.signed_score})
        log(f"match {i}: corrs={len(m.scene_corrs)} score={m.signed_score:.4f}")
        log(np.array_str(np.asarray(m.transform), precision=5, suppress_small=True))

    payload = json.dumps({"matches": out, "elapsed_sec": dt}, indent=2)
    if rank0 and args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
    elif rank0:
        print(payload)
    return 0 if matches else 2


if __name__ == "__main__":
    sys.exit(main())
