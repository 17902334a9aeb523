"""Run one cell of the benchmark of ``triplet_match_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card.  Loads the
cell's configuration and traffic mix by name, builds the system, warms it
up on every scan of the pool, drives it for ``--seconds`` as a closed loop
with one caller, checks a sample of the window's answers against the plain
reference, and prints one JSON object as the last line of standard output
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones
from a profiled window, plus ``breakdown``); the compared numbers with their
limits are the last lines of standard error and the object's last key.
Exits with a code other than 0 and prints no result without a card, or if
JAX or the JAX package got loaded: after set-up, after the window, and last
of all just before the result is printed.
"""

from __future__ import annotations

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from tmbench import cell, guard

    _, entry, _, _, _ = cell.find_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"run.py: the cell needs {entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {_card_line()}", file=sys.stderr, flush=True)
    result, rows, notes = cell.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                        bool(args.trace), T_PROC0, device="cuda",
                                        guard=guard.check)
    emit(result, rows, notes)
    return 0


def emit(result: dict, rows: list, notes: list) -> None:
    """Print a run's notes, its compared numbers with their limits (the last
    lines of standard error) and its result (the last line of standard
    output), once the JAX guard has found nothing loaded."""
    from tmbench import guard

    guard.check()
    for line in notes:
        print(line, file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
