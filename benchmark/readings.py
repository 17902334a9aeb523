"""The readings that the limits of a cell's ``correct`` are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3]

In one process: builds the cell as ``run.py`` does, answers the mix's
``check_requests`` requests under each seed (the requests a run of that
seed would send first), frees the program, and prints one JSON line per
seed with the reference's readings of the program's answers, then one per
control seed with its readings of the control's answers (``tmbench.control``:
the reference in the program's place, in TF32).  A sound reading is the
lower end of a limit; the control's is its upper end.  Needs the card.
"""

from __future__ import annotations

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]

    import torch

    from tmbench import cell as bc, control, guard, traffic

    if not torch.cuda.is_available():
        print("readings.py: no CUDA card", file=sys.stderr)
        return 2
    c = bc.prepare(ROOT, args.workload, "cuda")
    bc.warm(c, traffic.Requests(seeds[0], len(c.pool)))
    n = c.mix["check_requests"]
    answered = {}
    for seed in sorted(set(seeds) | set(control_seeds)):
        req = traffic.Requests(seed, len(c.pool))
        t0 = time.perf_counter()
        answered[seed] = (req, {k: c.system.request(c.pool[req.slot(k)],
                                                    req.search_seed(k))[0] for k in range(n)})
        bc.sync(c.device)
        print(json.dumps({"seed": seed, "requests": n,
                          "seconds": time.perf_counter() - t0}), file=sys.stderr, flush=True)
    guard.check()
    bc.free_system(c)
    cms = [control.ControlModel(a, c.config["find"]["dist_thres"], c.device) for a in c.models]
    lines = []
    for seed in seeds:
        req, ans = answered[seed]
        lines.append({"workload": args.workload, "seed": seed, "side": "program",
                      "readings": bc.check(c, req, ans)})
    for seed in control_seeds:
        req, ans = answered[seed]
        got = bc.check(c, req, ans, lambda scan, a: control.answer(cms, scan, a, c.device))
        lines.append({"workload": args.workload, "seed": seed, "side": "control",
                      "readings": got})
    guard.check()
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
