"""One run of one cell: set-up, warm-up, the measured window, the per-layer
readings, then the reference's check of the window's answers.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, its configuration's file (the entry's ``file``), its
traffic mix (``traffic/<traffic>.json``), its limits
(``limits/<cell>.json``), the generators of its models and scans and its
serving kind (``models/``, ``scenes/``, ``serve/``; see ``traffic`` and
``system``), and one reader per metric (``metrics/<metric>.py``, a function
``read(run)`` that returns the value or None when the run has nothing to
read).  A new cell, metric, model or scene kind is new files and new
manifest entries.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import time
from pathlib import Path

import torch

from tmbench import by_name, reference, traffic
from tmbench.by_name import BENCH
from tmbench.trace import events_from_profiler, reduce_trace

# seconds of the traced run's window that the profiler records
TRACE_SECONDS = 8.0
# launches of each ranking kernel whose work the traced run counts
COUNTED_LAUNCHES = 4
# characters of a device operation's name kept in the breakdown
NAME_CHARS = 160


@dataclasses.dataclass
class Run:
    """What a run hands its metric readers."""

    setup_s: float
    window_s: float
    latencies_s: list
    stats: list
    peak_bytes: int
    trace: dict | None = None
    kernel_inputs: dict = dataclasses.field(default_factory=dict)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, name: str) -> tuple[dict, dict, dict, dict, dict]:
    """(manifest, cell entry, configuration, mix, limits) of a cell."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    conf_entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = load_json(root / conf_entry["file"])
    mix = load_json(root / BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(root / BENCH / "limits" / f"{name}.json")
    return manifest, cell, config, mix, limits


def metrics_of(manifest: dict, cell: str, kind: str) -> list:
    """The manifest's ``end_to_end`` or ``per_layer`` entries a cell reports."""
    return [m for m in manifest[kind] if cell in m.get("workloads", [cell])]


def reader(root: Path, name: str):
    return by_name.load(root, "metrics", name).read


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card_state(device) -> str | None:
    """The card's SM clock, power draw and temperature (``nvidia-smi``), read
    beside the window so that a drift of the clocks shows in the notes."""
    if device.type != "cuda":
        return None
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


@dataclasses.dataclass
class Cell:
    """A cell made ready to serve: its files, the system and the scan pool."""

    name: str
    manifest: dict
    config: dict
    mix: dict
    limits: dict
    models: list
    system: object
    pool: list
    device: torch.device


def prepare(root: Path, name: str, device, system_factory=None) -> Cell:
    """Load a cell's files, build the system and the scan pool."""
    from tmbench.system import System

    device = torch.device(device)
    manifest, _, config, mix, limits = find_cell(root, name)
    models = traffic.model_arrays(root, config)
    system = (system_factory or System)(root, config, models, device)
    return Cell(name, manifest, config, mix, limits, models, system,
                traffic.make_pool(root, mix, models), device)


def warm(cell: Cell, requests: traffic.Requests) -> list:
    """Serve the mix's ``warm_scene_seeds``, one scan of each route and
    bucket the window takes, so every kernel library, kernel and cuBLAS plan
    the window uses is in place before it opens.  Returns the routes the
    warm-up took."""
    routes = []
    for i, scan in enumerate(cell.pool):
        if scan.scene_seed in cell.mix["warm_scene_seeds"]:
            routes.append(cell.system.request(scan, requests.warm_seed(i))[1].get("route"))
    sync(cell.device)
    return routes


def free_system(cell: Cell) -> None:
    """Drop the program's state before the reference runs."""
    cell.system = None
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()


def check(cell: Cell, requests: traffic.Requests, answers: dict, answer_fn=None) -> dict:
    """The reference's readings over ``answers`` (request index -> answer),
    or over ``answer_fn(scan, answer)``'s answers in their place."""
    mrefs = [reference.ModelRef(a, cell.config["find"]["dist_thres"], cell.device)
             for a in cell.models]
    readings = []
    for k, ans in answers.items():
        scan = cell.pool[requests.slot(k)]
        if answer_fn is not None:
            ans = answer_fn(scan, ans)
        readings.append(reference.check_request(mrefs, scan, ans, cell.device))
    return reference.combine(readings)


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, t_proc0: float,
             device="cuda", system_factory=None, guard=None) -> tuple[dict, list, list]:
    """Run one cell once.  Returns (the result object, the check rows, lines
    that say where a traced window's time went).
    ``system_factory`` replaces the program's serving object (the tests'
    faults); ``guard`` is called after set-up and after the window."""
    from tmbench.system import KernelRecorder

    cell = prepare(root, name, device, system_factory)
    device, system, pool = cell.device, cell.system, cell.pool
    requests = traffic.Requests(seed, len(pool))
    warm_routes = warm(cell, requests)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    recorder = prof = None
    if trace:
        recorder = KernelRecorder(COUNTED_LAUNCHES)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    if guard is not None:
        guard()
    setup_s = time.perf_counter() - t_proc0

    answers, latencies, stats, failed = [], [], [], 0
    traced = 0
    card_before = _card_state(device)
    if prof is not None:
        prof.start()
        recorder.active = True
    t_start = time.perf_counter()
    t_end = t_start
    k = 0
    while t_end < t_start + seconds:
        t0 = time.perf_counter()
        try:
            answer, st = system.request(pool[requests.slot(k)], requests.search_seed(k))
        except Exception as exc:  # a request that raises is failed, not fatal
            import traceback

            traceback.print_exception(exc)
            answer, st = None, {}
            failed += 1
        sync(device)
        t_end = time.perf_counter()
        answers.append(answer)
        latencies.append(t_end - t0)
        stats.append(st)
        k += 1
        if prof is not None and recorder.active:
            traced = k
            if t_end - t_start >= min(seconds, TRACE_SECONDS):
                recorder.active = False
                prof.stop()
    if prof is not None and recorder.active:
        recorder.active = False
        prof.stop()
    window_s = t_end - t_start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    card_after = _card_state(device)
    if guard is not None:
        guard()

    t_read = time.perf_counter()
    run = Run(setup_s, window_s, latencies, stats, peak)
    kind = "per_layer" if trace else "end_to_end"
    breakdown = busy = None
    notes = []
    if trace:
        events = events_from_profiler(prof)
        req = [e for e in events if not e.device and e.name == "bench.request"]
        span = (min(e.start_us for e in req), max(e.end_us for e in req)) if req else (0, 0)
        run.trace = reduce_trace(events, span)
        run.kernel_inputs = {"B1": recorder.b1, "B2": recorder.b2}
        recorder.close()
        busy = {"busy_s": run.trace["busy_s"], "window_s": run.trace["window_s"]}
        breakdown = {"device_ops": [[n[:NAME_CHARS], s] for n, s in run.trace["device_ops"]],
                     "idle_gaps": [[n, s] for n, s in run.trace["idle_gaps"]]}
        notes.append("trace " + json.dumps({
            k: run.trace[k] for k in ("window_s", "busy_s", "idle_by_range", "range_s", "range_n",
                                      "syncs")} | {
            "traced_requests": traced,
            "counted_launches": {k: len(v) for k, v in run.kernel_inputs.items()},
            "kernel_s": {k: v[:COUNTED_LAUNCHES] for k, v in run.trace["kernel_s"].items()}}))
    metrics = {}
    for m in metrics_of(cell.manifest, name, kind):
        v = reader(root, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    del system, recorder, prof, run
    free_system(cell)
    t_check = time.perf_counter()
    sample = requests.check_sample(len(answers), cell.mix["check_requests"])
    readings = check(cell, requests, {i: answers[i] for i in sample if answers[i] is not None})
    by_scan: dict = {}
    route_of: dict = {}
    for k, lat in enumerate(latencies):
        seed_k = pool[requests.slot(k)].scene_seed
        by_scan.setdefault(seed_k, []).append(lat)
        route_of.setdefault(seed_k, set()).add(stats[k].get("route"))
    rounds = [st.get("rounds", 0) for st in stats if st]
    notes.append("requests " + json.dumps({
        "latency_quartiles_s": statistics.quantiles(latencies, n=4) if len(latencies) > 1 else [],
        "first_latencies_s": latencies[:len(pool)],
        "mean_s_by_scene_seed": {s: sum(v) / len(v) for s, v in sorted(by_scan.items())},
        "routes_by_scene_seed": {s: sorted(map(str, v)) for s, v in sorted(route_of.items())},
        "routes_not_warmed": sorted(map(str, set().union(*route_of.values()) - set(warm_routes)))
        if route_of else [],
        "rounds_mean": sum(rounds) / max(len(rounds), 1), "rounds_max": max(rounds, default=0),
        "card_before_after": [card_before, card_after]}))
    notes.append("seconds " + json.dumps({"setup": setup_s, "window": window_s,
                                          "readers": t_check - t_read,
                                          "reference": time.perf_counter() - t_check,
                                          "checked_requests": len(sample)}))
    correct, rows = reference.judge(readings, cell.limits)
    correct = correct and failed == 0 and len(answers) > 0
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if busy is not None:
        dev.update(busy)
    result = {"correct": bool(correct), "attempted": len(answers), "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result, rows, notes
