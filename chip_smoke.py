"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device  — a CUDA card is required; there is no CPU fallback.
2. build   — compile csrc/coarse_rank.cu from this checkout (nvcc, sm_90a).
3. kernel  — the coarse ranker (TPU kernel B1) against its plain PyTorch
             version on the card, at both shapes of the main path (phase 1
             and phase 2 of the two-phase screen), on real neighbourhoods of
             the fixture scene with near-true and junk poses.  Integer counts
             must agree exactly, except points whose float64 4-D distance
             lies within 1e-5 * gate of the gate; the fractional tiebreak
             within K float32 ulps.  Kernel and plain times by CUDA events.
4. main    — compile the 2400-point box model, build the 131072-point
             touching-fog recall scene (seed 0), prepare it, and run
             find_all with the recall-protocol settings twice (first and
             warm call).  The first match must sit within 1 mm / 0.5 deg of
             ground truth (box-symmetry aware), the kernel must have been
             launched by the search, and the fog switch must stay off.
5. profile — one more warm find_all on the prepared scene under
             torch.profiler: device busy share of the call, the device
             kernels that take most time, host launches, stream syncs and
             device-to-host copies, and the host time of each round's
             "hypothesize" and "finalize" ranges.

The last two lines of standard output are one JSON object per kernel of the
path and then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _log(msg: str) -> None:
    print(msg, flush=True)


def _cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def _profile(fn, smi: str) -> None:
    """Run ``fn`` once under torch.profiler and print where its time went."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ranges = ("hypothesize", "finalize")
    events = prof.events()
    # a record_function range also shows on the device's timeline, spanning
    # every kernel it enqueued: only kernels and copies count as busy
    dev = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in ranges]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in dev)
    by_name: dict = {}
    for e in dev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    launches = sum(1 for e in host if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    syncs = [e for e in host if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize")]
    d2h = sum(1 for e in dev if "DtoH" in e.name)
    range_ms = {r: [e.time_range.elapsed_us() / 1e3 for e in host if e.name == r] for r in ranges}
    share = f"{100.0 * busy_us / wall_us:.1f} %" if dev else "not measured (no device events)"
    _log(f"[profile] warm find_all (scene prepared) under torch.profiler: wall "
         f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms ({share}) | host kernel "
         f"launches {launches}, stream syncs {len(syncs)} "
         f"({sum(e.time_range.elapsed_us() for e in syncs) / 1e3:.3f} ms), device-to-host "
         f"copies {d2h} | {smi}")
    for r, ms in range_ms.items():
        _log(f"[profile] range {r}: host ms per round {[round(m, 3) for m in ms]}")
    for n, (cnt, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        _log(f"[profile] device {us / 1e3:9.3f} ms {100.0 * us / max(busy_us, 1e-9):5.1f} % "
             f"x{cnt:<5d} {n[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 2
    import numpy as np

    from triplet_match_tpu_torch import config as cfg
    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.index.model import compile_model
    from triplet_match_tpu_torch.io.synthetic import recall_box_model, recall_scene, sym_delta
    from triplet_match_tpu_torch.kernels import build as kbuild
    from triplet_match_tpu_torch.ops.knn import radius_sample
    from triplet_match_tpu_torch.search import driver, score_kernel as sk
    from triplet_match_tpu_torch.search.sampling import hash_uniform
    from triplet_match_tpu_torch.core.cloud import PointCloud

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    _log(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # --- build --------------------------------------------------------------
    t0 = time.perf_counter()
    kbuild.load_coarse_rank()
    _log(f"[build] coarse_rank.cu: {time.perf_counter() - t0:.2f} s "
         f"(nvcc {kbuild.BUILD_SECONDS.get('coarse_rank', 0.0):.2f} s) | {smi}")

    # --- fixture --------------------------------------------------------------
    disc = cfg.DiscretizationParams()
    sample = cfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
    policy = cfg.SearchPolicy()
    xyz, nrm, tan = recall_box_model()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = compile_model(PointCloud.from_arrays(xyz, nrm, tan, device=dev), disc, sample, policy)
    torch.cuda.synchronize()
    t_compile = time.perf_counter() - t0
    scene, t_gt = recall_scene(131072, seed=0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with strict_fp32():
        prep = driver.prepare_scene(scene, policy)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    _log(f"[fixture] model lut {tuple(model.lut.shape)} n_edge {int(model.n_edge)} pairs "
         f"{int(model.pair_count)} | scene {scene.capacity} pts, {int(prep.n_edge)} edges")

    # --- kernel vs plain at the main path's shapes ----------------------------
    mpack = sk.pack_model_cached(model, coarse_points=policy.coarse_model_points,
                                 fine_points=policy.fine_model_points)
    gen = torch.Generator().manual_seed(1)
    # phase 1 ranks every hypothesis of a first point: the adaptive policy's
    # second samples times the pair candidates of each
    eff_policy, _ = driver.adaptive_policy(prep, model, policy)
    g, ks = policy.num_first_samples, policy.score_neighbors
    hg = eff_policy.num_second_samples * eff_policy.query_cap
    edge_idx = torch.nonzero(prep.tangent_mask)[:, 0]
    firsts = edge_idx[torch.randint(0, edge_idx.numel(), (g,), generator=gen).to(dev)]
    gidx = torch.arange(scene.capacity, device=dev)
    with strict_fp32():
        nbr_idx, nbr_ok = radius_sample(scene.xyz[firsts], scene.xyz, scene.valid,
                                        float(model.diameter), ks,
                                        hash_uniform((123, 456), gidx))
        groups = sk.pack_groups(prep.cloud, prep.tangent_mask,
                                torch.zeros(scene.capacity, dtype=torch.bool, device=dev),
                                nbr_idx, nbr_ok)
        t_inv = torch.linalg.inv(torch.as_tensor(t_gt)).to(dev)
        ts = t_inv.expand(g, hg, 4, 4).clone()
        noise = torch.randn((g, hg, 3), generator=gen).to(dev)
        ts[:, : hg // 2, :3, 3] += 0.004 * noise[:, : hg // 2]
        ts[:, hg // 2:, :3, 3] += 0.5 * noise[:, hg // 2:]
        rows = sk.poses_to_rows(ts)
    thres = np.float32(3.0) * np.float32(float(model.resolution))
    t2 = float(thres * thres)
    kernels = []
    keep = sk.two_phase_keep(hg, policy.two_phase_keep_frac, policy.two_phase_pose_tile)
    phases = (("phase1", policy.two_phase_stride, "coarse", hg, False),
              ("phase2", policy.two_phase_fine_stride, "fine", keep, policy.two_phase_fine_strict))
    for phase, stride, block_name, n_poses, strict in phases:
        grp = groups[:, :, ::stride].contiguous()
        lo = (hg - n_poses) // 2  # half near-true poses, half junk
        pr = rows[:, lo:lo + n_poses].contiguous()
        shifted = pr.clone()
        shifted[..., 9:12] -= mpack.center
        block = mpack.md_coarse if block_name == "coarse" else mpack.md_fine
        slack = mpack.coarse_slack if block_name == "coarse" else mpack.fine_slack
        t2c = sk._inflate(t2, slack)
        k = grp.shape[2]
        frac = sk._f32(1.0 / (k + 1))
        w_inf, w_str = (frac, 1.0) if strict else (1.0, frac)

        def kernel():
            return sk.score_groups_coarse(mpack, grp, pr, t2c, t2, block=block_name,
                                          strict_primary=strict)

        def plain():
            return sk.score_groups_coarse_plain(grp, shifted, block, t2c, mpack.kind_off, t2,
                                                w_inf, w_str)

        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        err, n_near = sk.check_coarse_parity(got, ref, grp, shifted, block, t2c, mpack.kind_off,
                                             t2, strict)
        ms = _cuda_ms(kernel, 20)
        plain_ms = _cuda_ms(plain, 2)
        _log(f"[kernel] B1 {phase}: groups {tuple(grp.shape)} poses {tuple(pr.shape)} block "
             f"{tuple(block.shape)} | kernel {ms:.4f} ms, plain {plain_ms:.2f} ms | "
             f"max |kernel-plain| {err:.3g}, near-gate poses {n_near} | hits mean "
             f"{float(got.mean()):.3f} max {float(got.max()):.3f} | {smi}")
        kernels.append({"phase": phase, "ms": ms, "plain_ms": plain_ms, "max_abs_err": err})

    # --- main path ------------------------------------------------------------
    kw = dict(dist_thres=3.0, model_match_factor=0.5, sample_params=sample, discretization=disc,
              policy=policy, max_icp_iterations=10, seed=5)
    torch.cuda.reset_peak_memory_stats()
    sk.COARSE_RANK.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    matches = driver.find_all(model, scene, **kw)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = sk.COARSE_RANK.launches
    stats = dict(driver.LAST_SEARCH_STATS)
    t0 = time.perf_counter()
    matches2 = driver.find_all(model, scene, **kw)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not matches or not matches2:
        raise AssertionError(f"find_all found nothing (stats {stats})")
    dt, dr = sym_delta(matches[0].transform, t_gt)
    dt2, dr2 = sym_delta(matches2[0].transform, t_gt)
    _log(f"[main] compile_model {t_compile:.3f} s | prepare_scene {t_prep:.3f} s | find_all first "
         f"{t_first:.3f} s, warm {t_warm:.3f} s | rounds {stats['rounds']} hypotheses "
         f"{stats['hypotheses_scored']} | matches {len(matches)} | first match "
         f"{dt * 1000:.4f} mm / {dr:.4f} deg (warm {dt2 * 1000:.4f} mm / {dr2:.4f} deg) | "
         f"kernel launches {launches} | peak {peak / 2**20:.1f} MiB | {smi}")
    _log(f"[main] stats {json.dumps(stats)}")
    if not (dt < 1e-3 and dr < 0.5):
        raise AssertionError(f"pose error {dt * 1000:.4f} mm / {dr:.4f} deg beyond 1 mm / 0.5 deg")
    if stats["num_second_samples_effective"] != eff_policy.num_second_samples:
        raise AssertionError("the kernel check ran at other shapes than the search: "
                             f"{eff_policy.num_second_samples} second samples vs "
                             f"{stats['num_second_samples_effective']}")
    if launches <= 0 or stats.get("coarse_kernel_launches", 0) <= 0:
        raise AssertionError("the search did not launch the coarse kernel")
    if stats["fine_rescore_full"]:
        raise AssertionError("the fog-density switch fired")

    # --- profile --------------------------------------------------------------
    _profile(lambda: driver.find_all(model, scene, prep=prep, **kw), smi)

    line = {"kernels": [{
        "name": "coarse_rank (B1, two-phase coarse 4-D hit-count ranker)",
        "route": "cuda",
        "source": "triplet_match_tpu_torch/csrc/coarse_rank.cu",
        "replaces": "triplet_match_tpu/search/score_pallas.py:625",
        "launches": launches,
        "max_abs_err": max(k["max_abs_err"] for k in kernels),
        "ms": kernels[0]["ms"],
        "plain_ms": kernels[0]["plain_ms"],
        "phases": kernels,
    }]}
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
