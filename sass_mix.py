"""Instruction mix of the loops of a tree's CUDA kernels, from their SASS.

    python3 sass_mix.py [--tree DIR]
        [--kernels coarse_rank coarse_linear_rank exact_rank full_rank]

Builds each ``csrc/<kernel>.cu`` of the PyTorch package in DIR (default: this
checkout) with that tree's ``kernels/build.py``, disassembles the library with
``cuobjdump -sass``, finds every loop (a branch back to a lower address) that
holds a float min (FMNMX: a minimum sweep) or fused multiply-adds beside a
double add (full mode's tie-set sum, the second pass), keeps the innermost
ones, and counts their shared loads
(LDS*) against its fp32 instructions (FFMA, FADD, FMUL, FMNMX, FSETP).  Also
prints each kernel function's registers, stack and local (spill) bytes from
``cuobjdump -res-usage``.  Prints one line per loop and function and, last,
one JSON object with the counts.  Needs nvcc and cuobjdump (the CUDA toolkit);
no card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
from pathlib import Path

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"(0x[0-9a-f]+)")
_FP32 = ("FFMA", "FADD", "FMUL", "FMNMX", "FSETP")
_RES = re.compile(r"Function ([^:\s]+):\s*(.*)")


def loops(sass: str) -> list[dict]:
    """Every innermost loop of every function in ``sass`` that holds an FMNMX,
    or FFMAs and a DADD, with its instruction counts by class and its pass
    ("min" or "tie sum")."""
    out, name, ins = [], None, []

    def flush():
        for i, (addr, op, rest) in enumerate(ins):
            if not op.startswith("BRA"):
                continue
            m = _TARGET.search(rest)
            if not m or int(m.group(1), 16) >= addr:
                continue
            body = [o for a, o, _ in ins if int(m.group(1), 16) <= a <= addr]
            counts = {c: sum(o.split(".")[0] == c for o in body) for c in _FP32}
            counts["LDS"] = sum(o.startswith("LDS") for o in body)
            counts["DADD"] = sum(o.split(".")[0] == "DADD" for o in body)
            counts["all"] = len(body)
            if counts["FMNMX"] or (counts["DADD"] and counts["FFMA"]):
                out.append({"function": name, "start": int(m.group(1), 16), "end": addr,
                            "pass": "min" if counts["FMNMX"] else "tie sum", **counts})

    for line in sass.splitlines():
        if "Function :" in line:
            flush()
            name, ins = line.split("Function :")[1].strip(), []
            continue
        m = _INSTR.search(line)
        if m and name:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    flush()
    # innermost loops only: an outer loop's counts repeat its inner loops'
    inner = [lp for lp in out if not any(
        o is not lp and o["function"] == lp["function"] and lp["start"] <= o["start"]
        and o["end"] <= lp["end"] for o in out)]
    return [{**lp, "start": hex(lp["start"]), "end": hex(lp["end"])} for lp in inner]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--kernels", nargs="+",
                    default=["coarse_rank", "coarse_linear_rank", "exact_rank", "full_rank"])
    args = ap.parse_args()
    tree = str(Path(args.tree).resolve())
    # that tree's build module, loaded by path: it builds from its own csrc/
    spec = importlib.util.spec_from_file_location(
        "_tree_build", Path(tree) / "triplet_match_tpu_torch" / "kernels" / "build.py")
    kbuild = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kbuild)

    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    result = {"tree": tree, "kernels": {}}
    for k in args.kernels:
        lib = kbuild.build(k)
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
        res = subprocess.run([cuobjdump, "-res-usage", str(lib)], capture_output=True, text=True,
                             check=True).stdout.splitlines()
        usage = {}
        for i, line in enumerate(res):
            m = _RES.search(line)
            if m:  # REG, STACK, SHARED, LOCAL, ... on this line or the next
                usage[m.group(1)] = (m.group(2) or (res[i + 1] if i + 1 < len(res) else "")).strip()
                print(f"[res] {k}: {m.group(1)[:60]}: {usage[m.group(1)]}", flush=True)
        found = loops(sass)
        for lp in found:
            fp32 = sum(lp[c] for c in _FP32)
            print(f"[sass] {k}: {lp['pass']} loop {lp['start']}-{lp['end']} of "
                  f"{lp['function'][:60]}: {lp['all']} instructions, LDS {lp['LDS']}, fp32 {fp32} "
                  "(" + ", ".join(f"{c} {lp[c]}" for c in (*_FP32, "DADD")) + ")", flush=True)
        result["kernels"][k] = {"loops": found, "resources": usage}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
