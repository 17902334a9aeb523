"""Smoke run of the PyTorch port's main paths on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device   — a CUDA card is required; there is no CPU fallback.
2. build    — compile every csrc/*.cu of kernels.build.SOURCES (the ranking
              kernels, nearest_grid.cu, join_score.cu and join_fit.cu) from this checkout
              (one nvcc each, started together, sm_90a).
3. B1, B4, B3 — on real neighbourhoods of the 131k fixture scene with
              near-true and junk poses, at the shapes of the standard-density
              path: the coarse ranker (TPU kernel B1) and the linearised
              coarse ranker (B4) against their plain PyTorch versions at
              phase 1 and phase 2 of the two-phase screen, B4 also against
              B1; the orientation-weighted ranker (B3) against its plain
              version at the full-mode phase 2.  Integer counts must agree
              exactly, except points whose float64 distance lies within
              1e-5 * gate of a gate (B4 against B1: within
              score_kernel.linear_band), and B1 and B4 must agree with their
              plain versions with no such excuse; coarse tiebreaks within K
              float32 ulps, B3 scores within 1e-5 relative.  One wrapper
              call of any of the four must run exactly one device kernel
              (a CUDA graph captured from it).  B1's and B4's bounds count
              own-kind evaluations (what their kernels sweep) and each
              pose's operand arithmetic, with the all-representative count
              printed beside, and their lines carry the ptxas registers and
              spills.
3b. C18    — B1 and B4 at gates above the squared kind offset, where the
              launcher sets the kernels' cross-kind sweep, at the 131k phase-2
              shapes: a block without edge representatives (a model without
              edge points) at the gate off^2 + t2, and the poses moved 100
              kind offsets away at the median distance of the pairs whose
              nearest representative is of the other kind; each kernel
              against its plain version with no near-gate excuse, on data
              with pairs that hit only through the other kind.
4. main131  — compile the 2400-point box model, build the 131072-point
              touching-fog recall scene (seed 0), prepare it, and run
              find_all with the recall-protocol settings twice (first and
              warm call).  The first match must sit within 1 mm / 0.5 deg of
              ground truth (box-symmetry aware), B1 must have been launched by
              the search, and the fog switch must stay off.
5. profile131 — one more warm find_all on the prepared 131k scene under
              torch.profiler: device busy share, the device kernels that take
              most time, host launches, stream syncs and device-to-host
              copies, and the host time of each round's "hypothesize" and
              "finalize" ranges.
6. main131full — api.Matcher(api.Model(...).init(sample), ranking_mode="full")
              .match on the 131k scene, first and warm: within the contract,
              B1 and B3 launched, B2 not, the fog switch off.
7. main131lin — api.Matcher with two_phase_coarse_linear=True on the 131k
              scene: within the contract, B4 launched, B1 not.
8. cli      — the box model and the 131k scene written as binary .pcd files
              (io.pcd.write_pcd) into a temporary directory of this checkout;
              cli.match.main with the recall-protocol flags and --save-model,
              then again on the saved .npz: both exit 0 with the same
              transform, within the contract.
9. B2, B3   — the exact ranker (TPU kernel B2) against its plain version at
              the fog route's shapes on the 500k fixture (seed 0): phase 1
              (strided groups, every hypothesis) and phase 2 (full-K groups,
              the kept poses), and the single-phase route with the weighted
              and negative epilogue; B3 against its plain version at the fog
              full-mode phase 2 and the same single-phase route; kernel and
              plain version on the same full-shape inputs.  Counts must agree
              exactly except near-gate points (reported); scores within 1e-5
              relative.  B2's and B3's lines give the recounted bound (own-
              kind columns for every eligible pair, other-kind columns only
              for those within the gate, all with `negative`, B3's second
              pass; from the plain version's distances) beside the
              both-blocks bound (both blocks for every pair), the share of pairs within the gate and
              the share of warps a warp vote would leave sweeping.
10. main500 — the 500000-point recall scene (seed 0): find_all first and warm.
              The fog switch must fire, the search must launch B2 and not
              B1, the subset join must not overflow, and the first match
              must sit within 1 mm / 0.5 deg of ground truth.
11. profile500 — one warm 500k find_all under torch.profiler, as phase 5.
12. main500full — api.Scene(scene, ranking_mode="full").find_all_parallel on
              the 500k scene: the fog switch fires, B2 (phase 1) and B3
              (phase 2) launched, B1 not, no join overflow, within the
              contract.
13. radius131, radius500 (run after the fixtures of phases 3 and 9) — the
              column-chunked ops.knn.radius_sample against one call whose
              chunk covers the whole row, on one round's real queries and
              priorities (the scoring neighbourhood and the second-point
              pool, at the adaptive and fog policies' k): indices and masks
              equal bit for bit; chunks per call and both times printed.
14. main2m  — the 2097152-point recall scene, seed 1 (bench.py --dense and
              scripts/scaling_study.py): B2 against its plain version at the
              fog route's phase 1 and phase 2 shapes there (Hg = 4096 poses
              per group), as phase 9 does at 500k; find_all first and warm,
              within the contract, the fog switch fired, B2 launched and B1
              not, no join overflow; the effective Hg and the peak memory
              printed.
15. jfa     — the LUT of the box model of tests/test_model_index.py built by
              jump flood (ops/jfa.py) against its brute LUT by that test's
              distance rule (no index negative, >= 95 % equal, excess
              distance in (-1e-5, half a voxel diagonal)); the same numbers
              printed for the recall box model; then compile_model of the graded
              20000-point lattice model, whose grid takes the jump-flood
              route, and again with ``exact_lut``: one launch of
              csrc/nearest_grid.cu against knn.nearest_grid_plain on the
              512^3 grid (distances within 1e-6, >= 99.9 % of indices
              equal; its seconds and bound printed); B2 against its plain
              version at the fog route's phase 1
              and phase 2 shapes on its 131k recall scene (seed 0), with the
              lattice's all-edge pack (an empty surface block); find_all on
              that scene, first and warm, within the contract, the fog switch
              fired, B2 launched and B1, B3, B4 not, no join overflow.
15b. latticecell — the lattice cell's path: api.Model.init of the lattice
              with exact_lut and resolve_symmetry (the exact 512^3 table, the
              orbit's detection through the join), then api.Matcher.match on
              the 131k lattice scene, first and warm: within the contract, B2
              launched and B1, B3, B4 not, an exact-lookup pass and an orbit
              step ([A, K] poses) among the join's passes.
15c. join   — each pass shape of the join that main500 and latticecell ran
              (their first calls' own inputs: the shared 500k scan, the
              [16, 65536] subsets, the 512^3 exact table, the orbit step):
              csrc/join_score.cu timed as a CUDA graph of 20 wrapper calls
              (device time; eager calls time the host's enqueue, printed
              beside), the plain pass, the device ops of one call, and the
              bound (compulsory bytes at 3.35 TB/s).
15d. fit    — each fit shape of the join that main500 and latticecell ran
              (Model.init's symmetry detection included; relaxed Kabsch, the
              polish's orientation-weighted Kabsch on edges and Gauss-Newton
              at the floor, on their first calls' own inputs):
              csrc/join_fit.cu timed as in 15c, the wrapper's eager enqueue,
              the plain float32 fit, the device ops of one call, the bound
              (compulsory bytes), and the worst gap to the float64 fit beside
              the plain fit's.
16. multi1m — BASELINE config 5 at full size through api.MultiMatcher: box
              models A and B (2400 points each) planted in 1M points of fog
              patches, raycast-verified from five origins (min_cast_score
              None), first call and warm: each model's first match within
              1 mm / 0.5 deg, the fog switch fired and B2 alone launched for
              both, every cast score in (0, 1], the pruned cast equal to the
              brute one bit for bit on each model's first match from the
              first origin; search and raycast seconds, cone survivors per
              origin and the peak memory printed.
17. prim    — BASELINE configs 1 and 2 at full size: plane detection in 10k
              points (recall >= 0.99, clutter rate <= 0.01) and cylinder
              detection in 12k (radius within 1 mm, recall >= 0.99).
18. mesh11  (after main131lin, and after main500full) — a process group of one
              NCCL rank in this process and a ("dp", "sp") mesh of shape
              (1, 1): find_all(mesh=) on the 131k and 500k fixtures with
              main131's / main500's settings and seed, first and warm.  Against
              the single-device search: as many matches, the same rounds,
              accepts and hypotheses, the same kernel launches (B1 at 131k;
              B2 and not B1 at 500k, the fog switch fired), each pose within
              1e-3 mm / 1e-3 deg; the claimed points' symmetric difference
              printed.  The 1-axis make_mesh(1) at 131k likewise.
19. lut131  (after mesh11 131k) — find_all with scorer="jnp" (the voxel-LUT
              scorer) on the 131k scene, first and warm: within the contract,
              none of B1-B4 launched, the fog switch off; seconds beside
              main131's.
20. symmetry (after lut131) — detect_self_symmetries of the recall box model:
              the identity first, 2-4 elements, each other one a half turn
              about a box axis within 0.1 (tests/test_symmetry.py's rule).
21. clidist (after cli, on its files) — `python -m torch.distributed.run
              --standalone --nproc-per-node 2 -m triplet_match_tpu_torch.cli
              .match ... --sp 2`: two gloo ranks sharing the card, exit 0,
              rank 0's transform within the contract and within 1e-3 mm of the
              single-rank CLI run.
22. mesh12  (after prim) — two gloo ranks sharing the card
              (parallel.distributed.run_local), a (1, 2) mesh (the scene in
              halves), at 500k (seed 0) and 2M (seed 1): round 0's first
              samples and accepts equal the single-device round's, as many
              matches as main500 / main2m with each pose within the sharded
              float-reduction tolerance (SHARDED_POSE_TOL: 0.1 mm / 0.01 deg,
              the CPU parity tests'), identical matches on both ranks, the fog switch
              fired, B2 launched on both ranks and B1 not, no join overflow;
              per-rank peak memory and shard size, rank 0's first and warm
              seconds, and the collectives' share of rank 0's warm 500k call
              (torch.profiler, the "collective" ranges).
23. mesh22, mesh212 (after mesh12) — four gloo ranks on the card, (2, 2) and
              (2, 1, 2) meshes at 500k: identical matches on every rank, the
              first within 1 mm / 0.5 deg, the fog switch fired, B2 on every
              rank and B1 not; hypotheses per round against the single
              device's, per-rank peak memory and rank 0's seconds.

Every main path runs with all six launch counts (B1-B4, JS, the join's
csrc/join_score.cu, and JF, its csrc/join_fit.cu) set to 0 just before its
first call and read just after it.  In that first call, and in the first call
of multi1m, of every mesh rank, of the symmetry detections, every pass of the
join on the card is held to the plain pass (``_JoinAudit``: count, ok and
model_idx bit for bit, the score within float32 reassociation), and JS must
equal the passes that launched and the search's
``join_score_kernel_launches``; every pose fit on the card, the mesh ranks'
scene-sharded ones included, is held to the plain fit in float64 (no farther
from it than the float32 plain fit, plus 1e-6 rad and 1e-6 x the scene's, or
the shard's, extent), and JF must equal the fits audited and the search's
``join_fit_kernel_launches``.  Kernel and plain
times are CUDA-event means over warm launches.  Every timing line carries the nvidia-smi name and
power limit.  The last two lines of standard output are one JSON object
listing the kernels of the paths and then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): 67 TFLOP/s fp32 outside the
# tensor cores, i.e. 3.35e13 fp32 instructions/s counting an FMA as one, and
# 3.35 TB/s of HBM3
FP32_INSTR_PER_S = 3.35e13
HBM_BYTES_PER_S = 3.35e12


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


def _graph_ms(fn, reps: int) -> float:
    """Device ms of one call of ``fn``: a CUDA graph of ``reps`` calls,
    replayed five times between CUDA events, so that the host's enqueue
    stays out."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph.reset()
    return start.elapsed_time(end) / (5 * reps)


def _device_ops(fn) -> list:
    """The device work one call of ``fn`` enqueues: the kernel, copy and memset
    nodes of a CUDA graph captured from the call, read through the driver
    API (cuGraphGetNodes, cuGraphNodeGetType).  Exact, unlike a profiler
    capture, which came back without device records now and then."""
    import ctypes

    import torch

    fn()  # warm: the kernels are built and loaded outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    drv = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if drv.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    if drv.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = {0: "kernel", 1: "memcpy", 2: "memset"}  # CUgraphNodeType
    ops = []
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        if drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        if t.value in kinds:
            ops.append(kinds[t.value])
    graph.reset()
    return ops


def _bound(instr: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) on the card and what sets it: fp32 instructions at the
    issue peak or bytes at the memory rate."""
    t_ops, t_bytes = instr / FP32_INSTR_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


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


def _profile(tag: str, fn, smi: str) -> dict:
    """Run ``fn`` once under torch.profiler, print where its time went and
    return the headline numbers."""
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
    _log(f"[{tag}] warm find_all (scene prepared) under torch.profiler: wall "
         f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms ({share}) | host kernel "
         f"launches {launches}, stream syncs {len(syncs)} "
         f"({sum(e.time_range.elapsed_us() for e in syncs) / 1e3:.3f} ms), device-to-host "
         f"copies {d2h} | {smi}")
    for r, ms in range_ms.items():
        _log(f"[{tag}] range {r}: host ms per round {[round(m, 3) for m in ms]} | {smi}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    # the top kernels, and the port's own (rank_kernel) wherever they rank
    for n, (cnt, us) in [kv for i, kv in enumerate(ranked) if i < 12 or "rank_kernel" in kv[0]]:
        _log(f"[{tag}] device {us / 1e3:9.3f} ms {100.0 * us / max(busy_us, 1e-9):5.1f} % "
             f"x{cnt:<5d} {n[:110]} | {smi}")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3, "launches": launches,
            "syncs": len(syncs), "range_ms": range_ms}


def build_kernels(smi: str) -> dict:
    """Compile the kernels of this checkout (one nvcc per source, started
    together), load them, print each build's seconds and ptxas register
    lines, and return those lines by source."""
    from triplet_match_tpu_torch.kernels import build as kbuild

    t0 = time.perf_counter()
    kbuild.build_all(ptxas_info=True)
    ptxas = {k: " | ".join(ln.strip() for ln in kbuild.BUILD_LOG.get(k, "").splitlines()
                           if "registers" in ln or "spill" in ln) or "not built in this process"
             for k in kbuild.SOURCES}
    for k in kbuild.SOURCES:
        _log(f"[build] {k}.cu: nvcc {kbuild.BUILD_SECONDS.get(k, 0.0):.2f} s | {ptxas[k]} | {smi}")
    _log(f"[build] {len(kbuild.SOURCES)} kernels {time.perf_counter() - t0:.2f} s wall (one nvcc "
         f"each, in parallel) | {smi}")
    return ptxas


def _check_poses(dev, prep, model, t_gt, policy, gen, tag_seed):
    """Neighbourhood groups of ``num_first_samples`` random scene edge points
    (K = score_neighbors, ranking eligibility of ``policy``) and [G, Hg]
    poses, half near the true pose and half junk, at the adaptive policy's
    Hg = second samples x pair candidates."""
    import torch

    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.ops.knn import radius_sample
    from triplet_match_tpu_torch.search import driver, score_kernel as sk
    from triplet_match_tpu_torch.search.sampling import hash_uniform

    scene = prep.cloud
    g, ks = policy.num_first_samples, policy.score_neighbors
    hg = policy.num_second_samples * policy.query_cap
    edge_idx = torch.nonzero(prep.tangent_mask)[:, 0]
    firsts = edge_idx[torch.randint(0, edge_idx.numel(), (g,), generator=gen).to(dev)]
    gidx = torch.arange(scene.capacity, device=dev)
    with strict_fp32():
        nbr_idx, nbr_ok = radius_sample(scene.xyz[firsts], scene.xyz, scene.valid,
                                        float(model.diameter), ks,
                                        hash_uniform((123, tag_seed), gidx))
        groups = sk.pack_groups(scene, prep.tangent_mask,
                                torch.zeros(scene.capacity, dtype=torch.bool, device=dev),
                                nbr_idx, nbr_ok, samples_on_all=driver._rank_on_all(policy))
        t_inv = torch.linalg.inv(torch.as_tensor(t_gt)).to(dev)
        ts = t_inv.expand(g, hg, 4, 4).clone()
        noise = torch.randn((g, hg, 3), generator=gen).to(dev)
        ts[:, : hg // 2, :3, 3] += 0.004 * noise[:, : hg // 2]
        ts[:, hg // 2:, :3, 3] += 0.5 * noise[:, hg // 2:]
        rows = sk.poses_to_rows(ts)
    return groups, rows


def _launch_counters(sk) -> dict:
    """The launch counters by short name: the ranking kernels B1-B4, JS, the
    join's scoring pass (csrc/join_score.cu), and JF, its pose fit
    (csrc/join_fit.cu)."""
    from triplet_match_tpu_torch.refine import icp
    from triplet_match_tpu_torch.search import score

    return {**sk.LAUNCH_COUNTERS, "JS": score.JOIN_SCORE, "JF": icp.JOIN_FIT}


def _main_path(tag, sk, driver, search, t_gt, smi, audit=None):
    """``search()`` twice (first, warm) with every launch count zeroed just
    before the first call, and the first call's join passes held to the
    plain pass (``audit``, a ``_JoinAudit``; a fresh one if None); returns
    (stats, the first call's launches by kernel, its matches)."""
    import torch

    from triplet_match_tpu_torch.io.synthetic import sym_delta

    torch.cuda.reset_peak_memory_stats()
    for c in _launch_counters(sk).values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with audit or _JoinAudit() as aud:
        matches = search()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = {b: c.launches for b, c in _launch_counters(sk).items()}
    stats = dict(driver.LAST_SEARCH_STATS)
    aud.check(tag, launches["JS"], stats.get("join_score_kernel_launches"), smi,
              launches["JF"], stats.get("join_fit_kernel_launches"))
    t0 = time.perf_counter()
    matches2 = search()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not matches or not matches2:
        raise AssertionError(f"[{tag}] the search found nothing (stats {stats})")
    dt, dr = sym_delta(matches[0].transform, t_gt)
    dt2, dr2 = sym_delta(matches2[0].transform, t_gt)
    _log(f"[{tag}] search first {t_first:.3f} s (join audited), warm {t_warm:.3f} s | rounds "
         f"{stats['rounds']} hypotheses {stats['hypotheses_scored']} | matches {len(matches)} | "
         f"first match {dt * 1000:.4f} mm / {dr:.4f} deg (warm {dt2 * 1000:.4f} mm / "
         f"{dr2:.4f} deg) | launches {launches} | peak {peak / 2**20:.1f} MiB | {smi}")
    _log(f"[{tag}] stats {json.dumps(stats)} | {smi}")
    if not (dt < 1e-3 and dr < 0.5):
        raise AssertionError(f"[{tag}] pose error {dt * 1000:.4f} mm / {dr:.4f} deg beyond "
                             "1 mm / 0.5 deg")
    stats["search_first_s"], stats["search_warm_s"] = t_first, t_warm
    return stats, launches, matches


def _expect_launches(tag, launches, stats, launched, idle):
    """Fail unless every kernel of ``launched`` ran in the path and none of
    ``idle`` did, by the counters and by the search's own statistics."""
    keys = {"B1": "coarse_kernel_launches", "B2": "exact_kernel_launches",
            "B3": "full_kernel_launches", "B4": "coarse_linear_kernel_launches"}
    for b in launched:
        if launches[b] <= 0 or stats.get(keys[b], 0) <= 0:
            raise AssertionError(f"[{tag}] the search did not launch {b}: {launches}")
    for b in idle:
        if launches[b] != 0 or stats.get(keys[b], 0) != 0:
            raise AssertionError(f"[{tag}] the search launched {b}: {launches}")


_EPS32 = 2.0 ** -23  # float32's machine epsilon


class _JoinAudit:
    """Inside ``with``: every pass of the join on the card (``finish_find``'s
    ``search.score._score_points_cuda``, one launch of csrc/join_score.cu)
    is run again through the plain pass, ``_score_points`` on the same CUDA
    tensors as ``finish_find`` called it before the kernel, and held to it:
    count, ok and model_idx bit for bit, the score within float32
    reassociation of its terms (tests/test_torch_kernels_cuda.py's rule).
    Every pose fit on the card (``refine.icp._fit_cuda``, one call of
    csrc/join_fit.cu) is held to the plain fit evaluated in float64 on the
    same inputs, under the same mesh group: no farther from it than the
    float32 plain fit, plus 1e-6 rad and 1e-6 x the scene's (or the shard's)
    extent (``refine.fit_check.fit_excess``, the card tests' rule).  The kernels' outputs go on to the search, so the search is
    the one the counters count.  Calls are recorded by shape (the poses'
    leading dims, the scene's, the lookup or fit mode, the flags); with
    ``keep``, each shape's first inputs too, for ``_join_time`` and
    ``_fit_time``.  A mismatch is recorded, not raised, so that a search
    under a mesh runs to its end on every rank; ``check`` raises."""

    def __init__(self, keep: bool = False):
        self.keep, self.calls, self.launching = keep, 0, 0
        self.shapes: dict = {}  # key -> {"calls", "max_abs_err", "args"}
        self.fits: dict = {}  # key -> {"calls", "gap", "plain_gap", "args"}
        self.fit_calls = 0
        self.bad: list = []

    def __enter__(self):
        from triplet_match_tpu_torch.refine import icp
        from triplet_match_tpu_torch.search import score

        self._mod, self._orig = score, score._score_points_cuda
        score._score_points_cuda = self._pass
        self._icp, self._orig_fit = icp, icp._fit_cuda
        icp._fit_cuda = self._fit
        return self

    def __exit__(self, *exc):
        self._mod._score_points_cuda = self._orig
        self._icp._fit_cuda = self._orig_fit
        return False

    def _fit(self, model, scene, tm, t, corrs, group=None, **mode):
        from triplet_match_tpu_torch.parallel.mesh import sharded
        from triplet_match_tpu_torch.refine.fit_check import fit_excess

        out = self._orig_fit(model, scene, tm, t, corrs, group=group, **mode)
        key = (f"fit poses {list(t.shape[:-2])} scene {list(scene.xyz.shape[:-1])} "
               f"{' '.join(k for k, v in sorted(mode.items()) if v) or 'relaxed'}"
               f"{' sharded' if sharded(group) else ''}")
        rec = self.fits.get(key)
        if rec is None:
            rec = self.fits[key] = {"calls": 0, "gap": [0.0, 0.0], "plain_gap": [0.0, 0.0],
                                    "args": None}
            if self.keep and not sharded(group):  # the search goes on from these poses
                rec["args"] = (model, scene, tm, t.clone(),
                               type(corrs)(*(c.clone() for c in corrs)), mode)
        rec["calls"] += 1
        self.fit_calls += 1
        over_t, over_r, gaps, plain_gaps = fit_excess(model, scene, tm, t, corrs, out,
                                                       group=group, **mode)
        for i in range(2):
            rec["gap"][i] = max(rec["gap"][i], float(gaps[i].max()))
            rec["plain_gap"][i] = max(rec["plain_gap"][i], float(plain_gaps[i].max()))
        if float(over_t.max()) > 0.0 or float(over_r.max()) > 0.0:
            self.bad.append(f"{key}: the fit beyond its bound by {float(over_t.max()):.3g} / "
                            f"{float(over_r.max()):.3g} rad")
        return out

    def _pass(self, model, scene, tm, consumed, ts, dist, exact, weighted, negative, on_all,
              count_only):
        import math

        import torch

        args = (model, scene, tm, consumed, ts, dist, exact, weighted, negative, on_all,
                count_only)
        out = self._orig(*args)
        lead, n = tuple(ts.shape[:-2]), scene.xyz.shape[-2]
        key = (f"poses {list(lead)} scene {list(scene.xyz.shape[:-1])} "
               f"{'exact' if exact else 'one-read'}"
               f"{' per-pose-gate' if isinstance(dist, torch.Tensor) else ''}"
               f"{'' if on_all else ' tangent-test'}{' weighted' if weighted else ''}"
               f"{' negative' if negative else ''}{' count-only' if count_only else ''}")
        rec = self.shapes.get(key)
        if rec is None:
            rec = self.shapes[key] = {"calls": 0, "max_abs_err": 0.0, "args": None}
            if self.keep:  # the claims change as the search goes on: keep this call's
                rec["args"] = (model, scene, tm, consumed.clone(), ts.clone(),
                               dist.clone() if isinstance(dist, torch.Tensor) else dist,
                               exact, weighted, negative, on_all, count_only)
        rec["calls"] += 1
        self.calls += 1
        if math.prod(lead) == 0 or n == 0:
            return out
        self.launching += 1
        thres = torch.as_tensor(dist, dtype=torch.float32, device=ts.device) * model.resolution
        if thres.dim():
            thres = thres[..., None]
        kw = dict(exact=exact, weighted_distance=weighted, samples_on_all=on_all)
        want = self._mod._score_points(model, scene, tm, consumed, ts, None, None, thres,
                                       negative_scores=negative, **kw)
        pos = (self._mod._score_points(model, scene, tm, consumed, ts, None, None, thres,
                                       negative_scores=False, **kw)[0] if negative else want[0])
        # every term is at most 1 in magnitude; their magnitudes sum to 2 pos - score
        diff = (out[0].double() - want[0].double()).abs()
        mag = (2.0 * pos.double() - want[0].double()).abs()
        same = torch.equal(out[1], want[1]) and (count_only or (
            torch.equal(out[2], want[2]) and torch.equal(out[3], want[3])))
        rec["max_abs_err"] = max(rec["max_abs_err"], float(diff.max()))
        if not same or float((diff - 64 * _EPS32 * mag).max()) > 1e-6:
            self.bad.append(f"{key}: count/ok/model_idx equal {same}, score gap "
                            f"{float(diff.max()):.3g}")
        return out

    def fit_shapes(self) -> dict:
        """Calls, the kernel's worst gap to the float64 fit (m, rad) and the
        float32 plain fit's, by fit shape."""
        return {k: (v["calls"], [float(f"{g:.3g}") for g in v["gap"]],
                    [float(f"{g:.3g}") for g in v["plain_gap"]]) for k, v in self.fits.items()}

    def check(self, tag, launched, published, smi, fit_launched=None, fit_published=None):
        """Fail unless every pass matched the plain one, every fit kept its
        bound, and the join's launches (the counter's ``launched``, the
        search's ``published`` statistic where it has one; ``fit_launched``
        and ``fit_published`` of the fit kernel) equal the passes that
        launched and the fits audited."""
        shapes = {k: (v["calls"], float(f"{v['max_abs_err']:.3g}")) for k, v in self.shapes.items()}
        _log(f"[{tag}] join audit: {self.calls} finish_find passes on the card ({self.launching} "
             f"launching), each held to the plain pass; JS launches {launched}, published "
             f"{published} | calls and worst score gap by shape {shapes} | {smi}")
        _log(f"[{tag}] fit audit: {self.fit_calls} fits on the card, each held to the "
             f"float64 fit; JF launches {fit_launched}, published {fit_published} | calls, "
             f"the kernel's worst gap to the float64 fit (m, rad) and the float32 plain "
             f"fit's, by shape {self.fit_shapes()} | {smi}")
        if self.bad:
            raise AssertionError(f"[{tag}] the join's kernels differ from the plain ones: "
                                 f"{self.bad[:4]}")
        if not (launched == self.launching > 0
                and published in (None, launched)):
            raise AssertionError(f"[{tag}] join_score launches {launched}, published "
                                 f"{published}, passes that launch {self.launching}")
        if fit_launched is not None and not (
                fit_launched == self.fit_calls > 0 and fit_published in (None, fit_launched)):
            raise AssertionError(f"[{tag}] join_fit launches {fit_launched}, published "
                                 f"{fit_published}, fits audited {self.fit_calls}")


def _join_time(tag, args, calls, max_abs_err, smi, reps: int = 20) -> dict:
    """One kept join pass (``_JoinAudit``) timed on the card.  The kernel's
    ms a pass: a CUDA graph of ``reps`` wrapper calls replayed, timed by CUDA
    events, so that the host's enqueue stays out (about 0.1 ms a call, some
    ten times the kernels' own time: CUDA events around eager calls read
    that, and are printed beside).  The plain pass by CUDA events over eager
    calls.  The bound counts the compulsory bytes at the memory rate: the
    scene's positions and flags once per scene batch, the poses, the model's
    positions once, the reference direction of as many scene points per
    batch as its best pose counts, and the outputs; and about 40 fp32
    instructions a pair (112 with the exact lookup)."""
    import math

    import torch

    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.search import score

    model, scene, tm, consumed, ts, dist, exact, weighted, negative, on_all, count_only = args
    fn = lambda: score._score_points_cuda(*args)  # noqa: E731
    thres = torch.as_tensor(dist, dtype=torch.float32, device=ts.device) * model.resolution
    if thres.dim():
        thres = thres[..., None]

    def plain():
        return score._score_points(model, scene, tm, consumed, ts, None, None, thres,
                                   exact=exact, weighted_distance=weighted,
                                   negative_scores=negative, samples_on_all=on_all)

    ops = _device_ops(fn)
    ms = _graph_ms(fn, reps)
    eager_ms = _cuda_ms(fn, reps)
    with strict_fp32():
        plain_ms = _cuda_ms(plain, 5)
    count = fn()[1]
    inp = score._join_inputs(scene, tm, consumed, ts, dist)
    n_poses, n = math.prod(inp.lead), inp.valid.shape[-1]
    scoring = int(count.reshape(-1, inp.batches).max(0).values.sum())
    nbytes = (_nbytes(inp.xyz, inp.valid, inp.tangent_mask, inp.consumed, inp.poses,
                      model.cloud.xyz) + 12 * scoring
              + n_poses * (n * (0 if count_only else 9) + 12))
    bound_ms, bound_by = _bound((112 if exact else 40) * n_poses * n, nbytes)
    _log(f"[join] {tag}: {calls} passes | kernel {ms:.4f} ms a pass (graph of {reps}; device "
         f"ops a call {ops}), eager {eager_ms:.4f} ms a call (the host's enqueue), plain "
         f"{plain_ms:.3f} ms | bound {bound_ms:.4f} ms ({bound_by}; {nbytes} bytes), "
         f"{100 * bound_ms / ms:.1f} % of it | {smi}")
    return {"phase": tag, "calls": calls, "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "max_abs_err": max_abs_err, "kernels_per_call": ops.count("kernel")}


def _fit_time(tag, rec, smi, reps: int = 20) -> dict:
    """One kept pose fit (``_JoinAudit``) timed on the card: the kernel's ms
    a fit as a CUDA graph of ``reps`` wrapper calls (device time), the
    wrapper's eager ms a call (CUDA events around eager calls: the host's
    enqueue), the plain float32 fit's ms (eager, CUDA events).  The bound
    counts the compulsory bytes at the memory rate: the corrs' flags, and
    per corr its model index, scene point and model point, the directions
    where the mode reads them (orientation weight: the mask and the scene's
    tangent or normal; orientation weight or Gauss-Newton: the model's
    tangent, and its normal only for a corr whose tangent is no edge's,
    |tangent| <= 0.7, as the kernel reads it), the mask under edges_only;
    the poses and the outputs."""
    import math

    import torch

    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.refine import icp

    model, scene, tm, t, corrs, mode = rec["args"]
    fn = lambda: icp._fit_cuda(model, scene, tm, t, corrs, **mode)  # noqa: E731
    ops = _device_ops(fn)
    ms = _graph_ms(fn, reps)
    eager_ms = _cuda_ms(fn, reps)
    with strict_fp32():
        plain_ms = _cuda_ms(lambda: icp._fit_plain(model, scene, tm, t, corrs, **mode), 5)
    n_poses = math.prod(t.shape[:-2])
    n_corr = int(corrs.valid.sum())
    orient, dirs = mode.get("orientation_weight"), mode.get("orientation_weight") or \
        mode.get("gauss_newton")
    mtan = model.cloud.tangent[corrs.model_idx[corrs.valid]]
    n_surface = int((torch.linalg.vector_norm(mtan, dim=-1) <= 0.7).sum())
    per_corr = 8 + 12 + 12 + (12 if orient else 0) + (12 if dirs else 0) \
        + (1 if mode.get("edges_only") or orient else 0)
    nbytes = (corrs.valid.numel() + per_corr * n_corr + (12 * n_surface if dirs else 0)
              + n_poses * (64 + 64 + 8))
    bound_ms, bound_by = _bound(0.0, nbytes)
    _log(f"[fit] {tag}: {rec['calls']} fits, {n_corr} corrs | kernel {ms:.4f} ms a fit (graph "
         f"of {reps}; device ops a call {ops}), eager {eager_ms:.4f} ms a call (the host's "
         f"enqueue), plain {plain_ms:.3f} ms | bound {bound_ms:.4f} ms ({bound_by}; {nbytes} "
         f"bytes), {100 * bound_ms / ms:.1f} % of it | worst gap to the float64 fit "
         f"{rec['gap'][0]:.3g} m / {rec['gap'][1]:.3g} rad (plain {rec['plain_gap'][0]:.3g} / "
         f"{rec['plain_gap'][1]:.3g}) | {smi}")
    return {"phase": tag, "calls": rec["calls"], "ms": ms, "eager_ms": eager_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "max_abs_err": rec["gap"][0], "max_rot_err": rec["gap"][1],
            "kernels_per_call": ops.count("kernel")}


def _warp_sweep_share(sk, grp, gi, ki, surv, n_poses) -> float:
    """Share of the (block, round, warp) units of B2 / B3's own-kind pass
    (csrc/exact_rank.cuh: points compacted by kind and padded to whole tiles
    of 4, tile index = point tile x npt + pose tile, EXACT_THREADS tiles a
    round; a split last round counted as whole tiles) holding at least one
    eligible pair in which some pair needs the other kind: the warps that
    would still sweep the other-kind block under a warp vote."""
    import torch

    tp, tq = sk.EXACT_TILE
    g = grp.shape[0]
    npt = sk.exact_pose_tiles(g, n_poses, sk._sm_count(grp.device))
    pb = npt * tp
    edge = grp[gi, 3, ki] > 0.5
    # slot of each eligible point within its kind (gi, ki are group-major)
    key = gi * 2 + (~edge).long()
    first = torch.zeros_like(key)
    first[1:] = (key[1:] != key[:-1]).long()
    run = torch.cumsum(first, 0)
    start = torch.zeros(int(run[-1]) + 1, dtype=torch.long, device=key.device)
    start.scatter_reduce_(0, run, torch.arange(key.numel(), device=key.device), "amin",
                          include_self=False)
    rank = torch.arange(key.numel(), device=key.device) - start[run]
    n_edge = torch.zeros(g, dtype=torch.long, device=key.device).index_add_(0, gi, edge.long())
    qt = torch.where(edge, rank // tq, (n_edge[gi] + tq - 1) // tq + rank // tq)  # [M]
    h = torch.arange(n_poses, device=key.device)
    idx = qt[:, None] * npt + ((h % pb) // tp)[None]  # [M, Hg]
    rounds = int(idx.max()) // sk.EXACT_THREADS + 1
    blocks = -(-n_poses // pb)
    warps = sk.EXACT_THREADS // 32
    unit = (((gi[:, None] * blocks + (h // pb)[None]) * rounds + idx // sk.EXACT_THREADS) * warps
            + (idx % sk.EXACT_THREADS) // 32)
    real = torch.unique(unit).numel()
    sweep = torch.unique(unit[surv]).numel()
    return sweep / max(real, 1)


def _check_exact(tag, phase, sk, mpack, grp, pr, t2, weighted, negative, full, smi):
    """B2 (or with ``full`` B3) against its plain version on the same inputs;
    returns the phase record.  Two bounds: the recounted one, the work this
    run's data needs (own-kind columns for every eligible pair, other-kind
    columns for the pairs within the gate or, with ``negative``, for all,
    B3's second pass over the own-kind columns for counted pairs, 5 fp32
    instructions per evaluation; 17 per pair for the operand, 3 per pose for
    t - c), and the both-blocks bound (both blocks for every pair, plus the
    second pass).
    Also the share of pairs within the gate, the share of warps that a warp
    vote would leave sweeping, and the device kernels one wrapper call runs
    (must be 1)."""
    import torch

    shifted = pr.clone()
    shifted[..., 9:12] -= mpack.center
    me, ms_blk = sk.exact_blocks(mpack)
    refs = sk.ref_blocks(mpack)
    inv2t = sk._inv2t(t2)
    mode = "full" if full else "count"

    def kernel():
        return sk.score_groups_exact(mpack, grp, pr, t2, mode=mode, weighted_distance=weighted,
                                     negative_scores=negative)

    def plain():
        if full:
            return sk.score_groups_full_plain(grp, shifted, me, ms_blk, *refs, t2, inv2t,
                                              weighted, negative)
        return sk.score_groups_exact_plain(grp, shifted, me, ms_blk, t2, inv2t, weighted,
                                           negative)

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    err, n_near = sk.check_exact_parity(got, ref, grp, shifted, me, ms_blk, t2)
    kernels = _device_ops(kernel)
    if kernels != ["kernel"]:
        raise AssertionError(f"[{tag}] {phase}: one wrapper call ran {kernels} on the device, "
                             "not one kernel")
    ms = _cuda_ms(kernel, 10)
    plain_ms = _cuda_ms(plain, 1)
    n_poses = pr.shape[1]
    ne, ns = me.shape[1], ms_blk.shape[1]
    gi, ki, d_own, d_other = sk.exact_pair_d2(grp, shifted, me, ms_blk)
    edge = (grp[gi, 3, ki] > 0.5)[:, None]
    own_cols = torch.where(edge, ne, ns).double()
    other_cols = torch.where(edge, ns, ne).double()
    gate = d_own <= t2
    counted = gate & (d_own <= d_other)
    surv = torch.ones_like(gate) if negative else gate
    pairs = float(gate.numel())
    evals_own = float(own_cols.sum()) * n_poses
    evals_other = float((other_cols * surv).sum())
    evals2 = float((own_cols * counted).sum()) if full else 0.0
    instr = (5.0 * (evals_own + evals_other + evals2) + 17.0 * pairs
             + 3.0 * grp.shape[0] * n_poses)
    nbytes = (_nbytes(grp, pr) + (28 if full else 16) * (ne + ns)
              + 8 * grp.shape[0] * n_poses)
    bound_ms, bound_by = _bound(instr, nbytes)
    bound_both_ms, _ = _bound(5.0 * (pairs * (ne + ns) + evals2), nbytes)
    surv_share = float(gate.double().mean()) if gate.numel() else 0.0
    warp_share = _warp_sweep_share(sk, grp, gi, ki, gate, n_poses) if gate.numel() else 0.0
    n_el = (grp[:, 4] > 0.5).sum(1).double()
    _log(f"[{tag}] {phase}: groups {tuple(grp.shape)} poses {tuple(pr.shape)} blocks "
         f"{tuple(me.shape)} + {tuple(ms_blk.shape)} | eligible points per group mean "
         f"{float(n_el.mean()):.2f} max {int(n_el.max())} | kernel {ms:.4f} ms (device kernels "
         f"per wrapper call {len(kernels)}), plain {plain_ms:.2f} ms | recounted bound "
         f"{bound_ms:.4f} ms ({bound_by}; {evals_own:.4g} own-kind + {evals_other:.4g} "
         f"other-kind + {evals2:.4g} second-pass evaluations; {100 * bound_ms / ms:.1f} % of it "
         f"reached), both-blocks bound {bound_both_ms:.4f} ms ({100 * bound_both_ms / ms:.1f} "
         f"%) | pairs "
         f"{pairs:.4g}: within the gate {100 * surv_share:.2f} %, counted "
         f"{100 * float(counted.double().mean()):.2f} %; warps a vote leaves sweeping "
         f"{100 * warp_share:.2f} % | max |score diff| {err:.3g}, near-gate poses {n_near} | "
         f"score mean {float(got[0].mean()):.3f}, count mean {float(got[1].float().mean()):.3f} "
         f"max {int(got[1].max())} | {smi}")
    return {"phase": phase, "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "near_gate_poses": n_near, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_both_blocks_ms": bound_both_ms, "gate_share": surv_share,
            "warp_sweep_share": warp_share, "kernels_per_call": len(kernels)}


def _check_cross_kind(sk, pack, grp, pr, t2, case, smi) -> list:
    """B1 and B4 at a gate above the squared kind offset (ROADMAP C18), where
    the launcher sets the kernels' ``cross`` sweep: ``one_kind_block`` (a
    block without edge representatives, the gate off^2 + t2) or
    ``far_poses`` (the poses moved 100 kind offsets away, the gate the median
    distance of the pairs whose nearest representative is of the other
    kind).  Each kernel against its plain version with no near-gate excuse,
    on data with pairs that hit only through the other kind; returns B1's
    and B4's phase records.  The bound counts every real representative for
    every eligible point (what the cross sweep does)."""
    import torch

    shifted = pr.clone()
    shifted[..., 9:12] -= pack.center
    if case == "far_poses":
        gen = torch.Generator().manual_seed(9)
        d = torch.randn(pr.shape[:2] + (3,), generator=gen).to(pr.device)
        shifted[..., 9:12] = 100.0 * pack.kind_off * d / d.norm(dim=-1, keepdim=True)
        pr = shifted.clone()
        pr[..., 9:12] += pack.center
    own, best = sk.kind_minima(grp, shifted, pack.md_fine, pack.kind_off)
    gate = (pack.kind_off ** 2 + t2 if case == "one_kind_block"
            else float(best[best < own].median()))
    n_cross = int(((best <= gate) & (own > gate)).sum())
    if n_cross == 0 or not sk._cross_kind(1.05 * gate, gate, pack.kind_off):
        raise AssertionError(f"[C18] {case}: the data does not reach the cross-kind path")
    block, n_edge, n_reps, args = sk._coarse_inputs(pack, grp, 1.05 * gate, gate, "fine", False)
    el = grp[:, 4] > 0.5
    pairs = float(el.sum()) * pr.shape[1]
    nbytes = _nbytes(grp, pr, block) + 4 * grp.shape[0] * pr.shape[1]
    records = []
    for tag, kernel, plain, per_pair, per_pose in (
            ("B1", lambda: sk.score_groups_coarse(pack, grp, pr, 1.05 * gate, gate,
                                                  block="fine"),
             lambda: sk.score_groups_coarse_plain(grp, shifted, block, *args), 20.0, 3.0),
            ("B4", lambda: sk.score_groups_coarse_linear(pack, grp, pr, 1.05 * gate, gate,
                                                         block="fine"),
             lambda: sk.score_groups_coarse_linear_plain(grp, sk.coarse_linear_rows(shifted),
                                                         block, *args), 21.0, 15.0)):
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        err, n_near = sk.check_coarse_parity(got, ref, grp, shifted, block, 1.05 * gate,
                                             pack.kind_off, gate, False)
        if n_near:
            raise AssertionError(f"[{tag}] C18 {case}: {n_near} poses differ from the plain "
                                 "version")
        ms = _cuda_ms(kernel, 10)
        plain_ms = _cuda_ms(plain, 1)
        bound_ms, bound_by = _bound(7.0 * pairs * n_reps + per_pair * pairs
                                    + per_pose * grp.shape[0] * pr.shape[1], nbytes)
        _log(f"[{tag}] C18 cross-kind sweep, {case}: groups {tuple(grp.shape)} poses "
             f"{tuple(pr.shape)} block {tuple(block.shape)} ({n_edge} edge + "
             f"{n_reps - n_edge} surface reps), gate {gate:.6g} (kind_off^2 "
             f"{pack.kind_off ** 2:g}), pairs hit only through the other kind {n_cross} | "
             f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
             f"({bound_by}) | max |kernel-plain| {err:.3g}, near-gate poses {n_near} | hits "
             f"mean {float(got.mean()):.3f} | {smi}")
        records.append({"phase": f"C18 {case}", "ms": ms, "plain_ms": plain_ms,
                        "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
                        "cross_kind_pairs": n_cross})
    return records


def _check_multi1m(api, driver, sk, disc, sample, policy, dev, smi) -> dict:
    """BASELINE config 5 at full size through ``api.MultiMatcher``: box
    models A and B (2400 points each) planted in 1M points of fog patches,
    raycast-verified from the config's five origins with
    ``min_cast_score=None``; first call and warm, every launch count zeroed
    before the first.  Each model's first match within 1 mm / 0.5 deg, the
    fog switch fired and B2 (not B1, B3, B4) launched for both, every cast
    score in (0, 1], and on each model's first match the pruned cast from the
    first origin equal to the brute cast bit for bit.  Prints each model's
    search and raycast seconds, the cone cull's survivors per origin, and
    the peak memory.  Returns the first call's launches by kernel."""
    import torch

    from triplet_match_tpu_torch.core.cloud import PointCloud
    from triplet_match_tpu_torch.io.synthetic import (
        BASELINE_ORIGINS,
        baseline_match_arrays,
        sym_delta,
    )
    from triplet_match_tpu_torch.verify.raycast import cast_visibility

    t0 = time.perf_counter()
    model_arrs, scene_arrs, t_gts = baseline_match_arrays(1_000_000 - 4800, two_models=True)
    library = [api.Model(PointCloud.from_arrays(*a, device=dev), disc, policy).init(sample)
               for a in model_arrs]
    scene = PointCloud.from_arrays(*scene_arrs, device=dev)
    mm = api.MultiMatcher(library, policy=policy, raycast_origins=BASELINE_ORIGINS,
                          min_cast_score=None)
    torch.cuda.synchronize()
    _log(f"[multi1m] two box models compiled and the {scene.capacity}-point scene built in "
         f"{time.perf_counter() - t0:.3f} s (serving bucket {mm.bucket_capacity(scene.capacity)}) "
         f"| {smi}")
    kw = dict(dist_thres=3.0, model_match_factor=0.5, sample_params=sample,
              max_icp_iterations=10, seed=5)
    calls = []
    for call in ("first", "warm"):
        for c in _launch_counters(sk).values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _JoinAudit() if call == "first" else contextlib.nullcontext() as audit:
            results = mm.match(scene, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {b: c.launches for b, c in _launch_counters(sk).items()}
        stats = [dict(st) for st in driver.LAST_MULTI_SEARCH_STATS]
        if audit is not None:
            audit.check(f"multi1m {call} call", launches["JS"],
                        sum(st["join_score_kernel_launches"] for st in stats), smi,
                        launches["JF"], sum(st["join_fit_kernel_launches"] for st in stats))
        peak = torch.cuda.max_memory_allocated() / 2**20
        calls.append(launches)
        k = len(BASELINE_ORIGINS)
        for i, (matches, st, t_gt) in enumerate(zip(results, stats, t_gts)):
            model = chr(65 + i)
            if not matches:
                raise AssertionError(f"[multi1m] model {model} found nothing (stats {st})")
            dt, dr = sym_delta(matches[0].transform, t_gt)
            surv = st["cast_survivors"]
            _log(f"[multi1m] {call} call, model {model}: {len(matches)} matches, first "
                 f"{dt * 1000:.4f} mm / {dr:.4f} deg, cast scores "
                 f"{[round(m.cast_score, 5) for m in matches]} | search {st['search_s']:.3f} s, "
                 f"raycast {st['raycast_s']:.3f} s, cone survivors per origin "
                 f"{[surv[j:j + k] for j in range(0, len(surv), k)]} | fog "
                 f"{st['fine_rescore_full']} (q95 {st.get('ball_population_q95')}), Hg "
                 f"{st['num_second_samples_effective']} x {policy.query_cap}, rounds "
                 f"{st['rounds']}, join overflow {st['join_overflow_max']} | {smi}")
            if not (dt < 1e-3 and dr < 0.5):
                raise AssertionError(f"[multi1m] model {model}: {dt * 1000:.4f} mm / {dr:.4f} "
                                     "deg beyond 1 mm / 0.5 deg")
            if not all(0.0 < m.cast_score <= 1.0 for m in matches):
                raise AssertionError(f"[multi1m] model {model}: a cast score outside (0, 1]")
            if not st["fine_rescore_full"]:
                raise AssertionError(f"[multi1m] model {model}: the fog switch did not fire")
            if st["exact_kernel_launches"] <= 0 or any(
                    st[key] for key in ("coarse_kernel_launches", "full_kernel_launches",
                                        "coarse_linear_kernel_launches")):
                raise AssertionError(f"[multi1m] model {model} did not rank through B2 alone: "
                                     f"{st}")
        if launches["B2"] <= 0 or any(launches[b] for b in ("B1", "B3", "B4")):
            raise AssertionError(f"[multi1m] launches {launches}: B2 alone expected")
        _log(f"[multi1m] {call} call{' (join audited)' if audit else ''}: MultiMatcher.match "
             f"{secs:.3f} s | launches {launches} | "
             f"peak {peak:.1f} MiB | statistics {mm.statistics} | {smi}")
    for i, (model, matches) in enumerate(zip(library, results)):
        c = model.compiled
        res = float(c.resolution)
        args = (BASELINE_ORIGINS[0], c.cloud.xyz, c.cloud.valid,
                torch.as_tensor(matches[0].transform), scene.xyz, scene.valid, res, 2.0 * res)
        times = {}
        for prune in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vis = cast_visibility(*args, prune=prune)
            torch.cuda.synchronize()
            times[prune] = (time.perf_counter() - t0, vis)
        if not torch.equal(times[True][1], times[False][1]):
            raise AssertionError(f"[multi1m] model {chr(65 + i)}: the pruned cast differs from "
                                 "the brute one")
        _log(f"[multi1m] model {chr(65 + i)}, origin 0: pruned cast {times[True][0]:.4f} s = "
             f"brute cast {times[False][0]:.4f} s bit for bit ({int(times[True][1].sum())} of "
             f"{int(c.cloud.valid.sum())} points visible) | {smi}")
    return calls[0]


def _check_prim(smi) -> None:
    """BASELINE configs 1 and 2 at full size (``protocol_torch.primitive_row``):
    plane detection in 10k points (recall >= 0.99, clutter rate <= 0.01) and
    cylinder detection in 12k (radius within 1 mm of 0.35 m, recall >= 0.99),
    first call and warm."""
    from protocol_torch import primitive_row

    for config in (1, 2):
        row = primitive_row(config, "cuda")
        what = (f"plane recall {row['plane_recall']:.5f}, clutter rate {row['clutter_rate']:.5f}"
                if config == 1 else f"radius {row['radius']:.6f} (error "
                f"{row['radius_err'] * 1000:.4f} mm), recall {row['recall']:.5f}")
        _log(f"[prim] config {config} ({row['name']}): {row['points']} points | {what} | detect "
             f"first {row['seconds']:.4f} s, warm {row['seconds_warm']:.4f} s | {smi}")
        if not row["found"]:
            raise AssertionError(f"[prim] config {config} misses its outcome: {what}")


def _check_radius(tag, prep, model, policy, gen, smi) -> dict:
    """The chunked ``radius_sample`` against one call whose chunk covers the
    whole row, on the driver's queries and priorities of one round (the
    scoring neighbourhood and the second-point pool): indices and masks must
    be equal bit for bit."""
    import torch

    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.ops import knn
    from triplet_match_tpu_torch.ops.knn import radius_chunk_cols, radius_sample
    from triplet_match_tpu_torch.search.sampling import draw_round, hash_uniform, sample_firsts

    cloud = prep.cloud
    n, b1 = cloud.capacity, policy.num_first_samples
    draws = draw_round(gen, b1, policy.second_pool, cloud.device)
    firsts = sample_firsts(draws.first_words, prep.tangent_mask & cloud.valid, b1)
    q = cloud.xyz[firsts.idx]
    blk = min(b1, 256)
    gidx = torch.arange(n, device=cloud.device)
    chunks = -(-n // radius_chunk_cols(n, blk))
    out = {"chunks": chunks}
    calls = (("neighbourhood", cloud.valid, policy.score_neighbors, draws.nbr_words),
             ("pool", prep.tangent_mask & cloud.valid, policy.second_pool, draws.pool_words))
    with strict_fp32():
        for call, valid, k, words in calls:
            prio = hash_uniform(words, gidx)

            def run(budget=knn._RADIUS_CHUNK_BYTES):
                saved, knn._RADIUS_CHUNK_BYTES = knn._RADIUS_CHUNK_BYTES, budget
                try:
                    return radius_sample(q, cloud.xyz, valid, model.diameter, k, prio, block=blk)
                finally:
                    knn._RADIUS_CHUNK_BYTES = saved

            whole_row = 1 << 62  # a budget whose one chunk covers the whole row
            got, whole = run(), run(whole_row)
            if not (torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])):
                bad = int((got[0] != whole[0]).sum() + (got[1] != whole[1]).sum())
                raise AssertionError(f"[{tag}] {call}: the chunked radius_sample differs from "
                                     f"the whole-row call in {bad} entries")
            ms, whole_ms = _cuda_ms(run, 3), _cuda_ms(lambda: run(whole_row), 3)
            _log(f"[{tag}] {call}: queries {tuple(q.shape)} x {n} points, k {k}, "
                 f"{chunks} column chunks of {radius_chunk_cols(n, blk)} | indices and masks "
                 f"equal to the whole-row call | in the ball {float(got[1].float().mean()):.3f} "
                 f"of the slots | chunked {ms:.3f} ms, whole row {whole_ms:.3f} ms | {smi}")
            out[call] = {"ms": ms, "whole_row_ms": whole_ms, "k": k}
    return out


def _check_jfa(tag, model, smi, rule: bool) -> dict:
    """The jump-flood LUT of ``model`` (compiled through the brute 1-NN)
    against that brute LUT.  With ``rule``, fail unless it keeps the distance
    rule of the JAX package's test: no index negative, at least 95 % of
    voxels equal, and no voxel's point nearer than the true nearest or more
    than half a voxel diagonal farther."""
    import torch

    from triplet_match_tpu_torch.ops.jfa import nearest_point_volume

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lut = nearest_point_volume(model.cloud.xyz, model.cloud.valid, model.to_voxel,
                               extents=model.extents)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    inv = torch.linalg.inv(model.to_voxel.double())
    ex, ey, ez = model.extents
    dev = lut.device
    ijk = torch.stack(torch.meshgrid(*(torch.arange(e, device=dev, dtype=torch.float64)
                                       for e in (ex, ey, ez)), indexing="ij"), -1).reshape(-1, 3)
    centers = ijk @ inv[:3, :3].T + inv[:3, 3]
    xyz = model.cloud.xyz.double()
    d_true = torch.linalg.vector_norm(xyz[model.lut.reshape(-1)] - centers, dim=1)
    d_jfa = torch.linalg.vector_norm(xyz[lut.reshape(-1)] - centers, dim=1)
    excess = d_jfa - d_true
    voxel = float(torch.linalg.vector_norm(torch.diagonal(inv[:3, :3])))
    equal = float((lut == model.lut).double().mean())
    _log(f"[jfa] {tag} grid {model.extents}: jump flood {secs:.3f} s | equal to the brute LUT "
         f"{100 * equal:.2f} % | excess distance min {float(excess.min()):.3g} max "
         f"{float(excess.max()):.4g} = {float(excess.max()) / voxel:.4f} voxel diagonals | {smi}")
    if rule and not (int(lut.min()) >= 0 and equal > 0.95 and float(excess.min()) > -1e-5
                     and float(excess.max()) < 0.5 * voxel):
        raise AssertionError(f"[jfa] {tag}: the jump-flood LUT breaks the distance rule")
    return {"seconds": secs, "equal_share": equal, "excess_max": float(excess.max())}



def _check_exact_lut(arrays, flood_model, disc, sample, policy, dev, smi) -> None:
    """compile_model of ``arrays`` with ``exact_lut``: one launch of
    csrc/nearest_grid.cu, timed, against its plain version
    (``knn.nearest_grid_plain``, the same sample points in blocks on the card):
    every voxel's point as near as the plain one's within 1e-6 (both taken
    again in float64), at least 99.9 % of indices equal (the rest ties within
    float32 rounding).  Prints the kernel's seconds and its bound (3 fp32
    instructions a (voxel, point) pair) beside the jump flood's excess."""
    import dataclasses

    import numpy as np
    import torch

    from triplet_match_tpu_torch.core.cloud import PointCloud
    from triplet_match_tpu_torch.index.model import compile_model
    from triplet_match_tpu_torch.ops import knn

    cloud = PointCloud.from_arrays(*arrays, device=dev)
    knn.NEAREST_GRID.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact = compile_model(cloud, disc, sample, dataclasses.replace(policy, exact_lut=True))
    torch.cuda.synchronize()
    t_compile = time.perf_counter() - t0
    if knn.NEAREST_GRID.launches != 1:
        raise AssertionError(f"[lut] nearest_grid launched {knn.NEAREST_GRID.launches} times")
    m = exact.cloud
    t_kernel = _cuda_ms(lambda: knn.nearest_grid(m.xyz, m.valid, exact.to_voxel,
                                                 exact.extents), 2) / 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = knn.nearest_grid_plain(m.xyz, m.valid, exact.to_voxel, exact.extents)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    inv = torch.linalg.inv(exact.to_voxel.double())
    xyz = m.xyz.double()
    gap = equal = 0.0
    flood_excess = 0.0
    for i0 in range(0, exact.extents[0], 32):  # 32 x-slabs of the grid at a time
        ijk = torch.stack(torch.meshgrid(
            torch.arange(i0, min(i0 + 32, exact.extents[0]), device=dev, dtype=torch.float64),
            *(torch.arange(e, device=dev, dtype=torch.float64) for e in exact.extents[1:]),
            indexing="ij"), -1).reshape(-1, 3)
        c = ijk @ inv[:3, :3].T + inv[:3, 3]
        got, want = exact.lut[i0:i0 + 32].reshape(-1), plain[i0:i0 + 32].reshape(-1)
        d_got = torch.linalg.vector_norm(c - xyz[got], dim=1)
        d_want = torch.linalg.vector_norm(c - xyz[want], dim=1)
        d_flood = torch.linalg.vector_norm(c - xyz[flood_model.lut[i0:i0 + 32].reshape(-1)], dim=1)
        gap = max(gap, float((d_got - d_want).abs().max()))
        flood_excess = max(flood_excess, float((d_flood - d_got).max()))
        equal += float((got == want).double().sum())
    n_vox = int(np.prod(exact.extents))
    equal /= n_vox
    bound = 3.0 * n_vox * int(m.valid.sum()) / FP32_INSTR_PER_S
    _log(f"[lut] exact_lut grid {exact.extents} x {int(m.valid.sum())} points: compile_model "
         f"{t_compile:.3f} s, nearest_grid {t_kernel:.4f} s (bound {bound:.4f} s, "
         f"{100 * bound / t_kernel:.1f} %), plain {t_plain:.3f} s | equal to the plain "
         f"{100 * equal:.4f} %, distance gap {gap:.3g} | the jump flood's worst excess "
         f"{1e3 * flood_excess:.4f} mm | {smi}")
    if not (gap <= 1e-6 and equal >= 0.999):
        raise AssertionError("[lut] the exact LUT kernel differs from its plain version")


def _pose_gap(a, b) -> tuple[float, float]:
    """(mm, deg) between two model -> scene poses, in float64 with each
    rotation projected onto SO(3) (arccos of a float32 trace cannot resolve
    1e-3 deg)."""
    import numpy as np
    import torch

    from triplet_match_tpu_torch.core.transforms import pose_delta

    def so3(t):
        t = torch.as_tensor(np.asarray(t, np.float64)).clone()
        u, _, vt = torch.linalg.svd(t[:3, :3])
        t[:3, :3] = u @ vt
        return t

    dt, dr = pose_delta(so3(a), so3(b))
    return float(dt) * 1e3, float(np.degrees(float(dr)))


def _same_search(tag, matches, ref, stats, ref_stats, launches, ref_launches, smi) -> None:
    """Fail unless a mesh search repeats the single-device one: as many
    matches, the same rounds, finalists, accepts and hypotheses, the same
    kernel launches, each pose within 1e-3 mm / 1e-3 deg; print the claimed
    points' symmetric difference."""
    keys = ("rounds", "phases", "finalists", "accepted", "hypotheses_scored", "fine_rescore_full")
    diff = {k: (stats.get(k), ref_stats.get(k)) for k in keys if stats.get(k) != ref_stats.get(k)}
    if len(matches) != len(ref) or diff or launches != ref_launches:
        raise AssertionError(f"[{tag}] {len(matches)} matches against {len(ref)}, stats {diff}, "
                             f"launches {launches} against {ref_launches}")
    gaps = [_pose_gap(a.transform, b.transform) for a, b in zip(matches, ref)]
    sym = [len(set(a.scene_corrs.tolist()) ^ set(b.scene_corrs.tolist()))
           for a, b in zip(matches, ref)]
    worst = (max(g[0] for g in gaps), max(g[1] for g in gaps))
    _log(f"[{tag}] against the single device: {len(matches)} matches, stats and launches equal, "
         f"pose gap at most {worst[0]:.3g} mm / {worst[1]:.3g} deg, claimed points' symmetric "
         f"difference {sym} | {smi}")
    if not (worst[0] < 1e-3 and worst[1] < 1e-3):
        raise AssertionError(f"[{tag}] pose gap {worst} beyond 1e-3 mm / 1e-3 deg")


def _mesh_rank(spec: dict) -> list:
    """One rank of the multi-rank phases (a spawned process; gloo ranks share
    the card): for each run of ``spec``, the recall scene, ``find_all`` under
    the run's mesh twice (first, warm), and on request a profiled warm call
    (rank 0) and round 0 against the single-device round (rank 0).  Returns
    every rank's records."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from triplet_match_tpu_torch import config as cfg
    from triplet_match_tpu_torch.core.cloud import PointCloud
    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.index.model import compile_model
    from triplet_match_tpu_torch.io.synthetic import recall_box_model, recall_scene
    from triplet_match_tpu_torch.parallel import mesh as pmesh
    from triplet_match_tpu_torch.parallel.search2d import (
        make_mesh_2d,
        make_mesh_3d,
        search_round_2d_prep,
    )
    from triplet_match_tpu_torch.search import driver, score_kernel as sk
    from triplet_match_tpu_torch.search.sampling import draw_round

    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    disc = cfg.DiscretizationParams()
    sample = cfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
    policy = cfg.SearchPolicy()
    kw = dict(spec["kw"], sample_params=sample, discretization=disc, policy=policy)
    model = compile_model(PointCloud.from_arrays(*recall_box_model(), device=dev), disc, sample,
                          policy)
    out = []
    for run in spec["runs"]:
        scene, _ = recall_scene(run["points"], seed=run["seed"], device=dev)
        shape = tuple(run["shape"])
        mesh = make_mesh_2d(*shape) if len(shape) == 2 else make_mesh_3d(*shape)
        for c in _launch_counters(sk).values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        seconds = []
        audit = _JoinAudit()
        for call in range(2):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            with audit if call == 0 else contextlib.nullcontext():
                matches = driver.find_all(model, scene, mesh=mesh, **kw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if call == 0:
                launches = {b: c.launches for b, c in _launch_counters(sk).items()}
                stats = dict(driver.LAST_SEARCH_STATS)
                first = [(m.transform, len(m.scene_corrs)) for m in matches]
        rec = {"name": run["name"], "rank": rank, "shape": shape, "seconds": seconds,
               "launches": launches, "stats": stats, "matches": first,
               "join_audit": {"passes": audit.calls, "launching": audit.launching,
                              "bad": audit.bad,
                              "shapes": {k: (v["calls"], v["max_abs_err"])
                                         for k, v in audit.shapes.items()},
                              "fits": audit.fit_calls, "fit_shapes": audit.fit_shapes()},
               "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
               "shard": scene.capacity // shape[-1]}
        if run.get("profile"):
            dist.barrier()
            if rank == 0:
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    t0 = time.perf_counter()
                    driver.find_all(model, scene, mesh=mesh, **kw)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                coll = [e for e in prof.events() if e.name == pmesh.COLLECTIVE]
                rec["profile"] = {"wall_ms": wall * 1e3, "collectives": len(coll),
                                  "collective_ms": sum(e.cpu_time_total for e in coll) / 1e3}
            else:
                driver.find_all(model, scene, mesh=mesh, **kw)
                torch.cuda.synchronize()
        if run.get("round0"):
            with strict_fp32():
                prep = driver.prepare_scene(scene, policy, mesh=mesh)
                eff, _ = driver.adaptive_policy(prep, model, policy, mesh)
                fog, fprep = driver.fog_policy(eff, prep, model)
                mpack = sk.pack_model_cached(model, coarse_points=fog.coarse_model_points,
                                             fine_points=fog.fine_model_points)
                gen = torch.Generator().manual_seed(spec["kw"]["seed"])
                draws = [draw_round(gen, fog.num_first_samples, fog.second_pool, scene.device)]
                zeros = torch.zeros(fprep.cloud.capacity, dtype=torch.bool, device=scene.device)
                rkw = dict(discretization=disc, sample_params=sample, policy=fog,
                           max_icp_iterations=spec["kw"]["max_icp_iterations"])
                res, _, fp = search_round_2d_prep(
                    mesh, model, fprep, zeros, zeros.clone(), draws, spec["kw"]["dist_thres"],
                    spec["kw"]["model_match_factor"], mpack, **rkw)
                if rank == 0:
                    r1, _, fp1 = driver.search_round(
                        model, fprep, zeros, zeros.clone(), draws[0], spec["kw"]["dist_thres"],
                        spec["kw"]["model_match_factor"], mpack, **rkw)
                    rec["round0"] = {"firsts": int(fp.sum()),
                                     "firsts_equal": bool(torch.equal(fp, fp1)),
                                     "accept_equal": bool(torch.equal(res.accept, r1.accept))}
        out.append(rec)
        del scene, matches
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, out)
    return gathered


# Pose tolerance of a scene-sharded search against the single device: the
# float-reduction tolerance of tests/test_torch_round.py and
# tests/test_torch_parallel.py (0.1 mm, 0.01 deg).  Sums over sp shards round
# in another order, and a pose that moves by a few float32 ulps can flip a
# correspondence at the gate, which moves the fit by far more than an ulp; the
# one-rank meshes run the single-device code and are held to 1e-3 mm /
# 1e-3 deg (_same_search).
SHARDED_POSE_TOL = (0.1, 0.01)


def _check_mesh_runs(tag, results, single, t_gt, smi) -> dict:
    """Fail unless every rank of a multi-rank phase returned the same matches,
    the fog switch fired, B2 ran on every rank and B1 not, and no join
    overflowed; against ``single`` (name -> (matches, stats)), where given,
    as many matches, each pose within ``SHARDED_POSE_TOL`` (mm, deg), and
    round 0's first samples and accepts equal.  Prints per-rank peak memory
    and shard size and rank 0's seconds; returns rank 0's launches by run."""
    from triplet_match_tpu_torch.io.synthetic import sym_delta

    launches = {}
    for i, rec0 in enumerate(results[0]):
        name = rec0["name"]
        recs = [r[i] for r in results]
        for r in recs:
            st = r["stats"]
            if not st["fine_rescore_full"] or st["join_overflow_max"] != 0:
                raise AssertionError(f"[{tag}] {name} rank {r['rank']}: fog "
                                     f"{st['fine_rescore_full']}, overflow "
                                     f"{st['join_overflow_max']}")
            if r["launches"]["B2"] <= 0 or r["launches"]["B1"] != 0:
                raise AssertionError(f"[{tag}] {name} rank {r['rank']}: launches {r['launches']}")
            # the join's passes on the rank's shard, held to the plain pass, and its fits,
            # held to the float64 fit under the same group
            ja = r["join_audit"]
            if ja["bad"] or not (r["launches"]["JS"] == ja["launching"]
                                 == st["join_score_kernel_launches"] > 0) or not (
                    r["launches"]["JF"] == ja["fits"] == st["join_fit_kernel_launches"] > 0):
                raise AssertionError(f"[{tag}] {name} rank {r['rank']}: join audit {ja}, "
                                     f"launches {r['launches']}")
            if len(r["matches"]) != len(rec0["matches"]) or any(
                    float(abs(a[0] - b[0]).max()) > 0 or a[1] != b[1]
                    for a, b in zip(r["matches"], rec0["matches"])):
                raise AssertionError(f"[{tag}] {name}: rank {r['rank']} returned other matches "
                                     "than rank 0")
        if not rec0["matches"]:
            raise AssertionError(f"[{tag}] {name}: no match")
        dt, dr = sym_delta(rec0["matches"][0][0], t_gt[name])
        if not (dt < 1e-3 and dr < 0.5):
            raise AssertionError(f"[{tag}] {name}: first match {dt * 1e3:.4f} mm / {dr:.4f} deg")
        st = rec0["stats"]
        extra = ""
        if name in single:
            ref, ref_stats = single[name]
            if len(ref) != len(rec0["matches"]):
                raise AssertionError(f"[{tag}] {name}: {len(rec0['matches'])} matches against "
                                     f"{len(ref)} on one device")
            gaps = [_pose_gap(a[0], b.transform) for a, b in zip(rec0["matches"], ref)]
            worst = (max(g[0] for g in gaps), max(g[1] for g in gaps))
            r0 = rec0.get("round0")
            extra = (f" | against the single device: {len(ref)} matches, pose gap at most "
                     f"{worst[0]:.3g} mm / {worst[1]:.3g} deg, hypotheses per round "
                     f"{st['hypotheses_scored'] / st['rounds']:.0f} against "
                     f"{ref_stats['hypotheses_scored'] / ref_stats['rounds']:.0f}")
            if r0 is not None:
                extra += (f", round 0 first samples equal {r0['firsts_equal']} ({r0['firsts']}),"
                          f" accepts equal {r0['accept_equal']}")
                if not (r0["firsts_equal"] and r0["accept_equal"]):
                    raise AssertionError(f"[{tag}] {name}: round 0 differs from the single "
                                         f"device {r0}")
            if not (worst[0] < SHARDED_POSE_TOL[0] and worst[1] < SHARDED_POSE_TOL[1]):
                raise AssertionError(f"[{tag}] {name}: pose gap {worst} beyond "
                                     f"{SHARDED_POSE_TOL} mm / deg")
        prof = rec0.get("profile")
        if prof:
            extra += (f" | rank 0 profiled warm call {prof['wall_ms']:.1f} ms, "
                      f"{prof['collectives']} collectives {prof['collective_ms']:.1f} ms "
                      f"({100 * prof['collective_ms'] / prof['wall_ms']:.1f} %)")
        _log(f"[{tag}] {name} mesh {rec0['shape']}: rank 0 first {rec0['seconds'][0]:.3f} s, warm "
             f"{rec0['seconds'][1]:.3f} s | {len(rec0['matches'])} matches, first "
             f"{dt * 1e3:.4f} mm / {dr:.4f} deg, identical on {len(recs)} ranks | rounds "
             f"{st['rounds']} hypotheses {st['hypotheses_scored']} | launches per rank "
             f"{[r['launches'] for r in recs]} | peak MiB per rank "
             f"{[round(r['peak_mib'], 1) for r in recs]}, shard {rec0['shard']} points{extra} "
             f"| join audit, rank 0: {rec0['join_audit']['passes']} passes on the shard held to "
             f"the plain pass, by shape {rec0['join_audit']['shapes']}; "
             f"{rec0['join_audit']['fits']} fits held to the float64 fit, by shape "
             f"{rec0['join_audit']['fit_shapes']} | {smi}")
        launches[name] = rec0["launches"]
    return launches


def _check_symmetry(model, disc, sample, policy, smi) -> None:
    """detect_self_symmetries of the recall box model (tests/test_symmetry.py's
    rule): the identity first, 2-4 elements, each other one a pi rotation about
    an axis, within 0.1."""
    import dataclasses

    import numpy as np
    import torch

    from triplet_match_tpu_torch.index.symmetry import detect_self_symmetries
    from triplet_match_tpu_torch.refine import icp
    from triplet_match_tpu_torch.search import score

    pol = dataclasses.replace(policy, num_first_samples=48, num_second_samples=16, query_cap=16,
                              score_neighbors=256, finalists=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    js0, jf0 = score.JOIN_SCORE.launches, icp.JOIN_FIT.launches
    with _JoinAudit() as audit:
        orbit = detect_self_symmetries(model, disc, sample, pol, seed=0, rounds=3)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    audit.check("symmetry", score.JOIN_SCORE.launches - js0, None, smi,
                icp.JOIN_FIT.launches - jf0, None)
    want = [np.diag(d).astype(np.float32) for d in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])]
    ok = (2 <= orbit.shape[0] <= 4 and np.abs(orbit[0] - np.eye(4)).max() < 1e-6
          and all(any(np.abs(s[:3, :3] - w).max() < 0.1 for w in want)
                  and np.linalg.norm(s[:3, 3]) < 0.05 for s in orbit[1:]))
    angles = [round(float(np.degrees(np.arccos(np.clip((np.trace(s[:3, :3]) - 1) / 2, -1, 1)))),
                    3) for s in orbit]
    _log(f"[symmetry] recall box model: orbit of {orbit.shape[0]} in {secs:.3f} s, rotation "
         f"angles {angles} deg | {smi}")
    if not ok:
        raise AssertionError(f"[symmetry] orbit {orbit}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 2
    import dataclasses
    import tempfile
    from pathlib import Path
    from types import SimpleNamespace

    import numpy as np

    from triplet_match_tpu_torch import api, config as cfg
    from triplet_match_tpu_torch.cli import match as cli
    from triplet_match_tpu_torch.core.cloud import PointCloud
    from triplet_match_tpu_torch.core.transforms import strict_fp32
    from triplet_match_tpu_torch.index.model import _LUT_JFA_THRESHOLD as LUT_JFA_THRESHOLD
    from triplet_match_tpu_torch.index.model import compile_model
    from triplet_match_tpu_torch.io.pcd import write_pcd
    from triplet_match_tpu_torch.io.synthetic import (
        make_box_model,
        model_arrays,
        recall_box_model,
        recall_scene,
        recall_scene_arrays,
        sym_delta,
    )
    from triplet_match_tpu_torch.ops.knn import radius_chunk_cols
    from triplet_match_tpu_torch.search import driver, score_kernel as sk
    from triplet_match_tpu_torch.refine.icp import JOIN_FIT
    from triplet_match_tpu_torch.search.score import JOIN_SCORE

    t_all = time.perf_counter()
    walls: dict = {}
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    _log(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
         f"cuda {torch.version.cuda}")

    # --- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    ptxas = build_kernels(smi)
    walls["build"] = time.perf_counter() - t0

    # --- 131k fixture: B1, B4 and B3 ---------------------------------------------
    t0 = time.perf_counter()
    disc = cfg.DiscretizationParams()
    sample = cfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
    policy = cfg.SearchPolicy()
    full_policy = dataclasses.replace(policy, ranking_mode="full")
    xyz, nrm, tan = recall_box_model()
    torch.cuda.synchronize()
    tc = time.perf_counter()
    model = compile_model(PointCloud.from_arrays(xyz, nrm, tan, device=dev), disc, sample, policy)
    torch.cuda.synchronize()
    t_compile = time.perf_counter() - tc
    scene, t_gt = recall_scene(131072, seed=0, device=dev)
    torch.cuda.synchronize()
    tp = time.perf_counter()
    with strict_fp32():
        prep = driver.prepare_scene(scene, policy)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - tp
    _log(f"[fixture131] compile_model {t_compile:.3f} s | prepare_scene {t_prep:.3f} s | model lut "
         f"{tuple(model.lut.shape)} n_edge {int(model.n_edge)} pairs {int(model.pair_count)} | "
         f"scene {scene.capacity} pts, {int(prep.n_edge)} edges | {smi}")

    mpack = sk.pack_model_cached(model, coarse_points=policy.coarse_model_points,
                                 fine_points=policy.fine_model_points)
    gen = torch.Generator().manual_seed(1)
    eff_policy, _ = driver.adaptive_policy(prep, model, policy)
    walls["fixture131"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    radius = {"131k": _check_radius("radius131", prep, model, eff_policy, gen, smi)}
    walls["radius131"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    groups, rows = _check_poses(dev, prep, model, t_gt, eff_policy, gen, 456)
    hg = rows.shape[1]
    thres = np.float32(3.0) * np.float32(float(model.resolution))
    t2 = float(thres * thres)
    b1_phases, b4_phases, b3_phases = [], [], []
    keep = sk.two_phase_keep(hg, policy.two_phase_keep_frac, policy.two_phase_pose_tile)
    phases = (("phase1", policy.two_phase_stride, "coarse", hg, False),
              ("phase2", policy.two_phase_fine_stride, "fine", keep, policy.two_phase_fine_strict))
    for phase, stride, block_name, n_poses, strict in phases:
        grp = groups[:, :, ::stride].contiguous()
        lo = (hg - n_poses) // 2  # half near-true poses, half junk
        pr = rows[:, lo:lo + n_poses].contiguous()
        shifted = pr.clone()
        shifted[..., 9:12] -= mpack.center
        wrows = sk.coarse_linear_rows(shifted)
        slack = mpack.coarse_slack if block_name == "coarse" else mpack.fine_slack
        t2c = sk._inflate(t2, slack)
        block, n_edge, n_reps, args = sk._coarse_inputs(mpack, grp, t2c, t2, block_name, strict)
        parity = (grp, shifted, block, t2c, mpack.kind_off, t2, strict)
        # the work this run's data needs: every eligible point against its own
        # kind's real representatives, per pose, 7 fp32 instructions each (1
        # mul, 3 FMA, 2 add for the rep's |p4|^2 hi/lo, 1 min), plus the
        # arithmetic each (pose, eligible point) pair needs once: B1 20 (tp = R
        # p + t 12, |tp4|^2 5, its hi/lo added after the minimum 3; the exact
        # -2 scaling is not counted, as the representatives could carry it), B4
        # 21 (its operand rows 0-2 12, row 6 6, hi/lo 3); per pose B1 3 (t - c),
        # B4 15 (t - c, R^T t, |t|^2).  The all-representative count (every
        # eligible point against every real representative) is printed beside.
        el = grp[:, 4] > 0.5
        n_el_e = (el & (grp[:, 3] > 0.5)).sum(1).double()
        n_el = el.sum(1).double()
        evals = float((n_el_e * n_edge + (n_el - n_el_e) * (n_reps - n_edge)).sum()) * n_poses
        evals_all = float(n_el.sum()) * n_reps * n_poses
        pairs = float(n_el.sum()) * n_poses
        nbytes = _nbytes(grp, pr, block) + 4 * grp.shape[0] * n_poses
        b1_out = None
        # (source, wrapper call, launch alone, plain version, instructions, records)
        for tag, src_name, kernel, launch, plain, instr, records in (
                ("B1", "coarse_rank",
                 lambda: sk.score_groups_coarse(mpack, grp, pr, t2c, t2, block=block_name,
                                                strict_primary=strict),
                 lambda: sk._coarse_launch(grp, pr, block, n_edge, n_reps, mpack.center_xyz,
                                           *args),
                 lambda: sk.score_groups_coarse_plain(grp, shifted, block, *args),
                 7.0 * evals + 20.0 * pairs + 3.0 * grp.shape[0] * n_poses, b1_phases),
                ("B4", "coarse_linear_rank",
                 lambda: sk.score_groups_coarse_linear(mpack, grp, pr, t2c, t2,
                                                       block=block_name, strict_primary=strict),
                 lambda: sk._coarse_linear_launch(grp, pr, block, n_edge, n_reps,
                                                  mpack.center_xyz, *args),
                 lambda: sk.score_groups_coarse_linear_plain(grp, wrows, block, *args),
                 7.0 * evals + 21.0 * pairs + 15.0 * grp.shape[0] * n_poses, b4_phases)):
            got = kernel()
            torch.cuda.synchronize()
            ref = plain()
            torch.cuda.synchronize()
            err, n_near = sk.check_coarse_parity(got, ref, *parity)
            if n_near:
                raise AssertionError(f"[{tag}] {phase}: {n_near} poses differ from the plain "
                                     "version")
            extra = ""
            if b1_out is None:
                b1_out = got
            else:  # B4 against B1: two operand builds, parity within linear_band
                band = sk.linear_band(grp, shifted, mpack.kind_off, block)
                _, n_near_b1 = sk.check_coarse_parity(got, b1_out, *parity, atol=band)
                extra = f" | against B1: near-gate poses {n_near_b1} (band {band:.3g})"
            kernels = _device_ops(kernel)
            if kernels != ["kernel"]:
                raise AssertionError(f"[{tag}] {phase}: one wrapper call ran {kernels} on the "
                                     "device, not one kernel")
            ms = _cuda_ms(kernel, 20)
            launch_ms = _cuda_ms(launch, 20)
            plain_ms = _cuda_ms(plain, 2)
            bound_ms, bound_by = _bound(instr, nbytes)
            bound_all_ms, _ = _bound(instr - 7.0 * (evals - evals_all), nbytes)
            _log(f"[{tag}] {phase}: groups {tuple(grp.shape)} poses {tuple(pr.shape)} block "
                 f"{tuple(block.shape)} ({n_edge} edge + {n_reps - n_edge} surface reps) | "
                 f"kernel {ms:.4f} ms (launch alone {launch_ms:.4f} ms; device kernels per "
                 f"wrapper call {len(kernels)}), plain {plain_ms:.2f} ms, bound {bound_ms:.4f} "
                 f"ms ({bound_by}, {evals:.4g} own-kind evaluations; {100 * bound_ms / ms:.1f} "
                 f"% of it reached; all-representative count {evals_all:.4g}, bound "
                 f"{bound_all_ms:.4f} ms) | max |kernel-plain| {err:.3g}, near-gate poses "
                 f"{n_near}{extra} | hits mean {float(got.mean()):.3f} max "
                 f"{float(got.max()):.3f} | ptxas {ptxas[src_name]} | {smi}")
            records.append({"phase": phase, "ms": ms, "launch_ms": launch_ms,
                            "plain_ms": plain_ms, "max_abs_err": err, "bound_ms": bound_ms,
                            "bound_by": bound_by, "bound_all_reps_ms": bound_all_ms,
                            "evaluations": evals, "evaluations_all_reps": evals_all})
        if phase == "phase2":  # full mode ranks the same survivors through B3
            b3_phases.append(_check_exact("B3", "131k full-mode phase 2", sk, mpack, grp, pr, t2,
                                          False, False, True, smi))
    walls["B1, B4, B3 131k"] = time.perf_counter() - t0

    # --- C18: B1 and B4 at gates above the squared kind offset ----------------------
    t0 = time.perf_counter()
    grp = groups[:, :, ::policy.two_phase_fine_stride].contiguous()
    lo = (hg - keep) // 2
    pr = rows[:, lo:lo + keep].contiguous()
    surf_pack = sk.pack_model(SimpleNamespace(cloud=PointCloud.from_arrays(
        xyz, nrm, np.zeros_like(xyz), device=dev)), coarse_points=policy.coarse_model_points,
        fine_points=policy.fine_model_points)
    for case, pack in (("one_kind_block", surf_pack), ("far_poses", mpack)):
        b1_rec, b4_rec = _check_cross_kind(sk, pack, grp, pr, t2, case, smi)
        b1_phases.append(b1_rec)
        b4_phases.append(b4_rec)
    walls["C18 131k"] = time.perf_counter() - t0

    # --- 131k main paths -----------------------------------------------------------
    t0 = time.perf_counter()
    kw = dict(dist_thres=3.0, model_match_factor=0.5, sample_params=sample, discretization=disc,
              policy=policy, max_icp_iterations=10, seed=5)
    stats131, launches131, matches131 = _main_path(
        "main131", sk, driver, lambda: driver.find_all(model, scene, **kw), t_gt, smi)
    stats = stats131
    if stats["num_second_samples_effective"] != eff_policy.num_second_samples:
        raise AssertionError("the B1 check ran at other shapes than the search: "
                             f"{eff_policy.num_second_samples} second samples vs "
                             f"{stats['num_second_samples_effective']}")
    _expect_launches("main131", launches131, stats, ("B1",), ("B2", "B3", "B4"))
    if stats["fine_rescore_full"]:
        raise AssertionError("the fog-density switch fired at 131k")
    walls["main131"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _profile("profile131", lambda: driver.find_all(model, scene, prep=prep, **kw), smi)
    walls["profile131"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    api_kw = dict(dist_thres=3.0, model_match_factor=0.5, sample_params=sample,
                  max_icp_iterations=10, seed=5)
    api_model = api.Model(PointCloud.from_arrays(xyz, nrm, tan, device=dev), disc,
                          policy).init(sample)
    stats, launches_full131, _ = _main_path(
        "main131full", sk, driver,
        lambda: api.Matcher(api_model, policy=full_policy).match(scene, **api_kw), t_gt, smi)
    _expect_launches("main131full", launches_full131, stats, ("B1", "B3"), ("B2", "B4"))
    if stats["fine_rescore_full"]:
        raise AssertionError("the fog-density switch fired at 131k in full mode")
    walls["main131full"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lin_policy = dataclasses.replace(policy, two_phase_coarse_linear=True)
    stats, launches_lin131, _ = _main_path(
        "main131lin", sk, driver,
        lambda: api.Matcher(api_model, policy=lin_policy).match(scene, **api_kw), t_gt, smi)
    _expect_launches("main131lin", launches_lin131, stats, ("B4",), ("B1", "B2", "B3"))
    walls["main131lin"] = time.perf_counter() - t0

    # --- mesh11 at 131k: a world of one NCCL rank, (1, 1) and (1,) meshes ----------
    t0 = time.perf_counter()
    import datetime

    import torch.distributed as dist

    from triplet_match_tpu_torch.parallel.mesh import make_mesh
    from triplet_match_tpu_torch.parallel.search2d import make_mesh_2d

    store_dir = tempfile.mkdtemp(prefix="_smoke_store_", dir=Path(__file__).resolve().parent)
    dist.init_process_group("nccl", store=dist.FileStore(str(Path(store_dir) / "store"), 1),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    mesh11 = make_mesh_2d(1, 1)
    _log(f"[mesh11] world of {dist.get_world_size()} rank, backend {dist.get_backend()}, mesh "
         f"{mesh11} | {smi}")
    launches_mesh = {}
    for tag, mesh in (("mesh11_131", mesh11), ("mesh1_131", make_mesh(1))):
        st, launches_mesh[tag], m = _main_path(
            tag, sk, driver, lambda: driver.find_all(model, scene, mesh=mesh, **kw), t_gt, smi)
        _expect_launches(tag, launches_mesh[tag], st, ("B1",), ("B2", "B3", "B4"))
        _same_search(tag, m, matches131, st, stats131, launches_mesh[tag], launches131, smi)
    walls["mesh11 131k"] = time.perf_counter() - t0

    # --- the voxel-LUT scorer (scorer="jnp"): no kernel, no fog switch ----------------
    t0 = time.perf_counter()
    lut_kw = dict(kw, policy=dataclasses.replace(policy, scorer="jnp"))
    st, launches_lut, _ = _main_path(
        "lut131", sk, driver, lambda: driver.find_all(model, scene, **lut_kw), t_gt, smi)
    _expect_launches("lut131", launches_lut, st, (), ("B1", "B2", "B3", "B4"))
    if st["fine_rescore_full"]:
        raise AssertionError("[lut131] the fog switch fired on the voxel-LUT route")
    _log(f"[lut131] first {st['search_first_s']:.3f} s, warm {st['search_warm_s']:.3f} s against "
         f"main131's {stats131['search_first_s']:.3f} / {stats131['search_warm_s']:.3f} s | {smi}")
    walls["lut131"] = time.perf_counter() - t0

    # --- self-symmetry detection on the card ------------------------------------------
    t0 = time.perf_counter()
    _check_symmetry(model, disc, sample, policy, smi)
    walls["symmetry"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    s_xyz, s_nrm, s_tan, _ = recall_scene_arrays(131072, seed=0)
    with tempfile.TemporaryDirectory(prefix="_smoke_", dir=Path(__file__).resolve().parent) as d:
        paths = {k: str(Path(d) / f) for k, f in (("model", "model.pcd"), ("scene", "scene.pcd"),
                                                  ("npz", "model.npz"), ("out1", "m1.json"),
                                                  ("out2", "m2.json"))}
        write_pcd(paths["model"], xyz, nrm, tan)
        write_pcd(paths["scene"], s_xyz, s_nrm, s_tan)
        flags = ["--quiet", "--dist-thres", "3.0", "--model-match-factor", "0.5",
                 "--min-diameter-factor", "0.3", "--max-diameter-factor", "0.95", "--max-icp",
                 "10", "--seed", "5"]
        runs = []
        for model_file, extra, out in ((paths["model"], ["--save-model", paths["npz"]], "out1"),
                                       (paths["npz"], [], "out2")):
            tr = time.perf_counter()
            rc = cli.main([model_file, paths["scene"], *flags, *extra, "--out", paths[out]])
            with open(paths[out]) as f:
                payload = json.load(f)
            if rc != 0 or not payload["matches"]:
                raise AssertionError(f"[cli] exit {rc} on {model_file}: {payload}")
            tf = np.asarray(payload["matches"][0]["transform"], np.float32)
            dt, dr = sym_delta(tf, t_gt)
            runs.append(tf)
            _log(f"[cli] {Path(model_file).name}: exit {rc}, {len(payload['matches'])} matches, "
                 f"search {payload['elapsed_sec']:.3f} s, run {time.perf_counter() - tr:.3f} s | "
                 f"first match {dt * 1000:.4f} mm / {dr:.4f} deg | {smi}")
            if not (dt < 1e-3 and dr < 0.5):
                raise AssertionError(f"[cli] pose error {dt * 1000:.4f} mm / {dr:.4f} deg")
        diff = float(np.abs(runs[0] - runs[1]).max())
        _log(f"[cli] the .pcd and the saved .npz runs' transforms differ by at most {diff:.3g} "
             f"| {smi}")
        if diff > 1e-5:
            raise AssertionError(f"[cli] the two runs printed different transforms ({diff})")
        walls["cli"] = time.perf_counter() - t0

        # --- clidist: the CLI under torchrun, two ranks sharing the card, --sp 2 ---
        t0 = time.perf_counter()
        out3 = str(Path(d) / "m3.json")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
               "2", "-m", "triplet_match_tpu_torch.cli.match", paths["model"], paths["scene"],
               *flags, "--sp", "2", "--out", out3]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              cwd=str(Path(__file__).resolve().parent))
        backend_lines = [ln for ln in proc.stderr.splitlines() if "[distributed]" in ln]
        if proc.returncode != 0:
            raise AssertionError(f"[clidist] torchrun exit {proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
        with open(out3) as f:
            payload = json.load(f)
        tf = np.asarray(payload["matches"][0]["transform"], np.float32)
        dt, dr = sym_delta(tf, t_gt)
        gap = _pose_gap(tf, runs[0])
        _log(f"[clidist] torchrun 2 ranks --sp 2: exit 0, {len(payload['matches'])} matches, "
             f"search {payload['elapsed_sec']:.3f} s, run {time.perf_counter() - t0:.3f} s | "
             f"first match {dt * 1000:.4f} mm / {dr:.4f} deg, {gap[0]:.3g} mm / {gap[1]:.3g} deg "
             f"from the single-rank run | {' '.join(backend_lines)} | {smi}")
        if not (dt < 1e-3 and dr < 0.5 and gap[0] < 1e-3):
            raise AssertionError(f"[clidist] transform {dt * 1000:.4f} mm / {dr:.4f} deg, "
                                 f"{gap[0]:.3g} mm from the single-rank run")
    walls["clidist"] = time.perf_counter() - t0
    del prep, scene, groups, rows

    # --- 500k fixture: B2 and B3 -----------------------------------------------------
    t0 = time.perf_counter()
    scene5, t_gt5 = recall_scene(500000, seed=0, device=dev)
    torch.cuda.synchronize()
    tp = time.perf_counter()
    with strict_fp32():
        prep5 = driver.prepare_scene(scene5, policy)
    torch.cuda.synchronize()
    t_prep5 = time.perf_counter() - tp
    eff5, ball_q = driver.adaptive_policy(prep5, model, policy)
    if not ball_q > policy.fine_full_rescore_ratio * policy.score_neighbors:
        raise AssertionError(f"the 500k fixture does not fire the fog switch (q95 {ball_q})")
    fog5, fprep5 = driver.fog_policy(eff5, prep5, model)
    _log(f"[fixture500] prepare_scene {t_prep5:.3f} s | scene {scene5.capacity} pts, "
         f"{int(prep5.n_edge)} detected edges, {int(fprep5.n_edge)} raw-tangent edges | ball q95 "
         f"{ball_q:.1f} (ratio {ball_q / policy.score_neighbors:.2f}) | exact blocks "
         f"{mpack.n_edge_cols} edge + {mpack.n_surf_cols} surface columns | {smi}")
    walls["fixture500"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    radius["500k"] = _check_radius("radius500", fprep5, model, fog5, gen, smi)
    walls["radius500"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    groups5, rows5 = _check_poses(dev, fprep5, model, t_gt5, fog5, gen, 789)
    hg5 = rows5.shape[1]
    keep5 = sk.two_phase_keep(hg5, fog5.two_phase_keep_frac, fog5.two_phase_pose_tile)
    b2_phases = []
    checks = (("phase1", fog5.two_phase_stride, hg5, False, False),
              ("phase2", fog5.two_phase_fine_stride, keep5, False, False),
              ("single-phase weighted+negative", 1, hg5, True, True))
    for phase, stride, n_poses, weighted, negative in checks:
        lo = (hg5 - n_poses) // 2  # half near-true poses, half junk
        b2_phases.append(_check_exact(
            "B2", phase, sk, mpack, groups5[:, :, ::stride].contiguous(),
            rows5[:, lo:lo + n_poses].contiguous(), t2, weighted, negative, False, smi))
    # full mode on the fog route: phase 2 keeps the configured fine stride
    # (driver.fog_policy), and the single-phase route ranks every pose
    fog_full, _ = driver.fog_policy(dataclasses.replace(eff5, ranking_mode="full"), prep5, model)
    lo = (hg5 - keep5) // 2
    b3_phases.append(_check_exact(
        "B3", "500k fog full-mode phase 2", sk, mpack,
        groups5[:, :, ::fog_full.two_phase_fine_stride].contiguous(),
        rows5[:, lo:lo + keep5].contiguous(), t2, False, False, True, smi))
    b3_phases.append(_check_exact("B3", "500k single-phase weighted+negative", sk, mpack,
                                  groups5, rows5, t2, True, True, True, smi))
    walls["B2, B3 500k"] = time.perf_counter() - t0

    # --- 500k main paths -------------------------------------------------------------
    t0 = time.perf_counter()
    audit500 = _JoinAudit(keep=True)
    stats5, launches500, matches500 = _main_path(
        "main500", sk, driver, lambda: driver.find_all(model, scene5, **kw), t_gt5, smi, audit500)
    if not stats5["fine_rescore_full"]:
        raise AssertionError("the fog-density switch did not fire at 500k")
    if stats5["num_second_samples_effective"] != eff5.num_second_samples:
        raise AssertionError("the B2 check ran at other shapes than the search")
    _expect_launches("main500", launches500, stats5, ("B2",), ("B1", "B3", "B4"))
    if stats5["join_overflow_max"] != 0:
        raise AssertionError(f"the subset join overflowed by {stats5['join_overflow_max']}")
    walls["main500"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    js_phases = [_join_time(f"main500 {k}", v["args"], v["calls"], v["max_abs_err"], smi)
                 for k, v in audit500.shapes.items()]
    jf500 = [_fit_time(f"main500 {k}", v, smi) for k, v in audit500.fits.items()]
    del audit500
    walls["join 500k"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _profile("profile500", lambda: driver.find_all(model, scene5, prep=prep5, **kw), smi)
    walls["profile500"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    stats5f, launches_full500, _ = _main_path(
        "main500full", sk, driver,
        lambda: api.Scene(scene5, full_policy).find_all_parallel(api_model, **api_kw), t_gt5,
        smi)
    if not stats5f["fine_rescore_full"]:
        raise AssertionError("the fog-density switch did not fire at 500k in full mode")
    _expect_launches("main500full", launches_full500, stats5f, ("B2", "B3"), ("B1", "B4"))
    if stats5f["join_overflow_max"] != 0:
        raise AssertionError(f"the subset join overflowed by {stats5f['join_overflow_max']}")
    walls["main500full"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    st, launches_mesh["mesh11_500"], m = _main_path(
        "mesh11_500", sk, driver, lambda: driver.find_all(model, scene5, mesh=mesh11, **kw), t_gt5,
        smi)
    if not st["fine_rescore_full"]:
        raise AssertionError("[mesh11_500] the fog-density switch did not fire")
    _expect_launches("mesh11_500", launches_mesh["mesh11_500"], st, ("B2",), ("B1", "B3", "B4"))
    _same_search("mesh11_500", m, matches500, st, stats5, launches_mesh["mesh11_500"], launches500,
                 smi)
    dist.destroy_process_group()
    shutil.rmtree(store_dir, ignore_errors=True)
    walls["mesh11 500k"] = time.perf_counter() - t0
    del scene5, prep5, fprep5, groups5, rows5

    # --- 2M fixture: the bench.py --dense / scaling fixture, seed 1 ---------------------
    t0 = time.perf_counter()
    scene2m, t_gt2m = recall_scene(2097152, seed=1, device=dev)
    with strict_fp32():
        prep2m = driver.prepare_scene(scene2m, policy)
    eff2m, _ = driver.adaptive_policy(prep2m, model, policy)
    fog2m, fprep2m = driver.fog_policy(eff2m, prep2m, model)
    groups2m, rows2m = _check_poses(dev, fprep2m, model, t_gt2m, fog2m, gen, 999)
    hg2m = rows2m.shape[1]
    keep2m = sk.two_phase_keep(hg2m, fog2m.two_phase_keep_frac, fog2m.two_phase_pose_tile)
    for phase, stride, n_poses in (("2M phase 1", fog2m.two_phase_stride, hg2m),
                                   ("2M phase 2", fog2m.two_phase_fine_stride, keep2m)):
        lo = (hg2m - n_poses) // 2  # half near-true poses, half junk
        b2_phases.append(_check_exact(
            "B2", phase, sk, mpack, groups2m[:, :, ::stride].contiguous(),
            rows2m[:, lo:lo + n_poses].contiguous(), t2, False, False, False, smi))
    del prep2m, fprep2m, groups2m, rows2m
    walls["B2 2M"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats2m, launches2m, matches2m = _main_path(
        "main2m", sk, driver, lambda: driver.find_all(model, scene2m, **kw), t_gt2m, smi)
    if not stats2m["fine_rescore_full"]:
        raise AssertionError("the fog-density switch did not fire at 2M")
    _expect_launches("main2m", launches2m, stats2m, ("B2",), ("B1", "B3", "B4"))
    if stats2m["join_overflow_max"] != 0:
        raise AssertionError(f"the subset join overflowed by {stats2m['join_overflow_max']}")
    if stats2m["num_second_samples_effective"] != eff2m.num_second_samples:
        raise AssertionError("the B2 2M check ran at other shapes than the search")
    _log(f"[main2m] effective Hg {hg2m} poses per group ({stats2m['num_second_samples_effective']}"
         f" second samples x {policy.query_cap} pair candidates), radius_sample "
         f"{-(-scene2m.capacity // radius_chunk_cols(scene2m.capacity, 256))} column chunks per "
         f"call | {smi}")
    del scene2m
    walls["main2m"] = time.perf_counter() - t0

    # --- jump-flood LUT: the box model, then the lattice model end to end ---------------
    t0 = time.perf_counter()
    # the rule's own model (tests/test_model_index.py), then the recall box model, reported
    test_box = make_box_model(n_edge=180, n_face=420, size=(1, 1, 1), seed=0)
    _check_jfa("test box model", compile_model(PointCloud.from_arrays(*test_box, device=dev), disc,
                                               sample, policy), smi, rule=True)
    _check_jfa("recall box model", model, smi, rule=False)
    lat = model_arrays("lattice")
    torch.cuda.synchronize()
    tc = time.perf_counter()
    lat_model = compile_model(PointCloud.from_arrays(*lat, device=dev), disc, sample, policy)
    torch.cuda.synchronize()
    t_lat = time.perf_counter() - tc
    _log(f"[jfa] lattice model ({lat[0].shape[0]} points): compile_model {t_lat:.3f} s through "
         f"the jump flood, grid {lat_model.extents} "
         f"({int(np.prod(lat_model.extents))} voxels > {LUT_JFA_THRESHOLD}), n_edge "
         f"{int(lat_model.n_edge)} pairs {int(lat_model.pair_count)} | {smi}")
    if int(np.prod(lat_model.extents)) <= LUT_JFA_THRESHOLD:
        raise AssertionError("the lattice model's grid did not take the jump-flood route")
    _check_exact_lut(lat, lat_model, disc, sample, policy, dev, smi)
    scene_lat, t_gt_lat = recall_scene(131072, seed=0, arrays=lat, device=dev)
    walls["jfa"] = time.perf_counter() - t0
    # B2 at the lattice's fog shapes: an all-edge pack, so an empty surface block
    t0 = time.perf_counter()
    lat_pack = sk.pack_model_cached(lat_model, coarse_points=policy.coarse_model_points,
                                    fine_points=policy.fine_model_points)
    thres_lat = np.float32(3.0) * np.float32(float(lat_model.resolution))
    with strict_fp32():
        prep_lat = driver.prepare_scene(scene_lat, policy)
    eff_lat, _ = driver.adaptive_policy(prep_lat, lat_model, policy)
    fog_lat, fprep_lat = driver.fog_policy(eff_lat, prep_lat, lat_model)
    groups_lat, rows_lat = _check_poses(dev, fprep_lat, lat_model, t_gt_lat, fog_lat, gen, 321)
    hg_lat = rows_lat.shape[1]
    keep_lat = sk.two_phase_keep(hg_lat, fog_lat.two_phase_keep_frac,
                                 fog_lat.two_phase_pose_tile)
    _log(f"[B2] lattice pack: exact blocks {lat_pack.n_edge_cols} edge + "
         f"{lat_pack.n_surf_cols} surface columns | {smi}")
    for phase, stride, n_poses in (("lattice phase 1", fog_lat.two_phase_stride, hg_lat),
                                   ("lattice phase 2", fog_lat.two_phase_fine_stride, keep_lat)):
        lo = (hg_lat - n_poses) // 2  # half near-true poses, half junk
        b2_phases.append(_check_exact(
            "B2", phase, sk, lat_pack, groups_lat[:, :, ::stride].contiguous(),
            rows_lat[:, lo:lo + n_poses].contiguous(), float(thres_lat * thres_lat), False,
            False, False, smi))
    del prep_lat, fprep_lat, groups_lat, rows_lat
    walls["B2 lattice"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats_lat, launches_lat, _ = _main_path(
        "mainlattice", sk, driver, lambda: driver.find_all(lat_model, scene_lat, **kw), t_gt_lat,
        smi)
    if not stats_lat["fine_rescore_full"]:
        raise AssertionError("the fog-density switch did not fire on the lattice")
    _expect_launches("mainlattice", launches_lat, stats_lat, ("B2",), ("B1", "B3", "B4"))
    if stats_lat["join_overflow_max"] != 0:
        raise AssertionError(f"the subset join overflowed by {stats_lat['join_overflow_max']}")
    if stats_lat["num_second_samples_effective"] != eff_lat.num_second_samples:
        raise AssertionError("the B2 lattice check ran at other shapes than the search")
    del lat_model
    walls["mainlattice"] = time.perf_counter() - t0

    # --- the lattice cell's path: the exact 512^3 table and the orbit step --------------
    t0 = time.perf_counter()
    cell_policy = dataclasses.replace(policy, exact_lut=True, resolve_symmetry=True)
    js0, jf0 = JOIN_SCORE.launches, JOIN_FIT.launches
    with _JoinAudit(keep=True) as audit:  # Model.init's symmetry detection runs the join
        lat_api = api.Model(PointCloud.from_arrays(*lat, device=dev), disc,
                            cell_policy).init(sample)
    torch.cuda.synchronize()
    audit.check("latticecell init", JOIN_SCORE.launches - js0, None, smi,
                JOIN_FIT.launches - jf0, None)
    jf_phases = [_fit_time(f"latticecell init {k}", v, smi) for k, v in audit.fits.items()]
    del audit
    orbit_lat = lat_api.compiled.orbit
    _log(f"[latticecell] api.Model.init with exact_lut and resolve_symmetry: "
         f"{time.perf_counter() - t0:.3f} s, table {tuple(lat_api.compiled.lut.shape)}, orbit "
         f"of {0 if orbit_lat is None else orbit_lat.shape[0]} | {smi}")
    if tuple(lat_api.compiled.lut.shape) != (512, 512, 512) or orbit_lat is None \
            or orbit_lat.shape[0] < 2:
        raise AssertionError("[latticecell] no exact 512^3 table or no orbit")
    audit_lat = _JoinAudit(keep=True)
    stats_latc, launches_latc, _ = _main_path(
        "latticecell", sk, driver,
        lambda: api.Matcher(lat_api, policy=cell_policy).match(scene_lat, **api_kw), t_gt_lat,
        smi, audit_lat)
    _expect_launches("latticecell", launches_latc, stats_latc, ("B2",), ("B1", "B3", "B4"))
    if not (any("," in k.split(" scene ")[0] for k in audit_lat.shapes)
            and any(" exact" in k for k in audit_lat.shapes)):
        raise AssertionError(f"[latticecell] no orbit-step [A, K] pass or no exact lookup among "
                             f"{list(audit_lat.shapes)}")
    js_phases = [_join_time(f"latticecell {k}", v["args"], v["calls"], v["max_abs_err"], smi)
                 for k, v in audit_lat.shapes.items()] + js_phases
    jf_phases = [_fit_time(f"latticecell {k}", v, smi)
                 for k, v in audit_lat.fits.items()] + jf500 + jf_phases
    del scene_lat, lat_api, audit_lat
    walls["latticecell"] = time.perf_counter() - t0

    # --- BASELINE config 5: a two-model library in 1M points, raycast-verified -------
    t0 = time.perf_counter()
    launches_multi = _check_multi1m(api, driver, sk, disc, sample, policy, dev, smi)
    walls["multi1m"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _check_prim(smi)
    walls["prim"] = time.perf_counter() - t0

    # --- mesh12, mesh22, mesh212: gloo ranks sharing the card --------------------------
    from triplet_match_tpu_torch.parallel.distributed import run_local

    mesh_kw = {k: kw[k] for k in ("dist_thres", "model_match_factor", "max_icp_iterations",
                                  "seed")}
    single = {"500k": (matches500, stats5), "2M": (matches2m, stats2m)}
    t_gts = {"500k": t_gt5, "2M": t_gt2m}
    t0 = time.perf_counter()
    res12 = run_local(_mesh_rank, 2, "gloo", {"kw": mesh_kw, "runs": [
        {"name": "500k", "points": 500000, "seed": 0, "shape": (1, 2), "round0": True,
         "profile": True},
        {"name": "2M", "points": 2097152, "seed": 1, "shape": (1, 2), "round0": True}]},
        device_type="cuda", join_timeout=900)
    for k, v in _check_mesh_runs("mesh12", res12, single, t_gts, smi).items():
        launches_mesh[f"mesh12_{k}"] = v
    walls["mesh12"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res4 = run_local(_mesh_rank, 4, "gloo", {"kw": mesh_kw, "runs": [
        {"name": "mesh22", "points": 500000, "seed": 0, "shape": (2, 2), "profile": True},
        {"name": "mesh212", "points": 500000, "seed": 0, "shape": (2, 1, 2)}]},
        device_type="cuda", join_timeout=900)
    t_gts.update({"mesh22": t_gt5, "mesh212": t_gt5})
    for k, v in _check_mesh_runs("mesh4", res4, {}, t_gts, smi).items():
        launches_mesh[k] = v
    _log(f"[mesh4] hypotheses per round: (2, 2) "
         f"{res4[0][0]['stats']['hypotheses_scored'] / res4[0][0]['stats']['rounds']:.0f}, "
         f"(2, 1, 2) "
         f"{res4[0][1]['stats']['hypotheses_scored'] / res4[0][1]['stats']['rounds']:.0f}, one "
         f"device {stats5['hypotheses_scored'] / stats5['rounds']:.0f} | {smi}")
    walls["mesh22, mesh212"] = time.perf_counter() - t0
    walls["total"] = time.perf_counter() - t_all
    _log(f"[wall] seconds per phase {json.dumps({k: round(v, 3) for k, v in walls.items()})} | "
         f"{smi}")

    paths = {"main131": launches131, "main131full": launches_full131,
             "main131lin": launches_lin131, "main500": launches500,
             "main500full": launches_full500, "main2m": launches2m,
             "mainlattice": launches_lat, "latticecell": launches_latc, "multi1m": launches_multi,
             "lut131": launches_lut, **launches_mesh}

    def entry(b, name, source, replaces, path, phases):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": paths[path][b], "launches_path": path,
                "launches_by_path": {p: c[b] for p, c in paths.items()},
                "max_abs_err": max(p["max_abs_err"] for p in phases),
                "ms": phases[0]["ms"], "plain_ms": phases[0]["plain_ms"],
                "bound_ms": phases[0]["bound_ms"], "bound_by": phases[0]["bound_by"],
                "library_ms": None, "phases": phases}

    src, tpu = "triplet_match_tpu_torch/csrc/", "triplet_match_tpu/search/score_pallas.py"
    line = {"kernels": [
        entry("B1", "coarse_rank (B1, two-phase coarse 4-D hit-count ranker)",
              src + "coarse_rank.cu", tpu + ":625", "main131", b1_phases),
        entry("B2", "exact_rank (B2, exact two-minimum count ranker)",
              src + "exact_rank.cu", tpu + ":394", "main500", b2_phases),
        entry("B3", "full_rank (B3, orientation-weighted exact ranker, full mode)",
              src + "full_rank.cu", tpu + ":394", "main131full", b3_phases),
        entry("B4", "coarse_linear_rank (B4, pose-linearised coarse 4-D hit-count ranker)",
              src + "coarse_linear_rank.cu", tpu + ":922", "main131lin", b4_phases),
        entry("JS", "join_score (the join's scoring pass, search.score.finish_find)",
              src + "join_score.cu", None, "latticecell", js_phases),
        entry("JF", "join_fit (the join's pose fit, refine.icp._fit)",
              src + "join_fit.cu", None, "latticecell", jf_phases),
    ]}
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
