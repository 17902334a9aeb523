"""Instruction mix of the loops of a tree's CUDA kernels, from their SASS.

    python3 sass_mix.py [--tree DIR]
        [--kernels coarse_rank coarse_linear_rank]

Builds each ``csrc/<kernel>.cu`` of the PyTorch package in DIR (default: this
checkout) with that tree's ``kernels/build.py``, disassembles the library with
``cuobjdump -sass``, finds every loop (a branch back to a lower address) that
holds a float min (FMNMX), and counts its shared loads (LDS*) against its
fp32 instructions (FFMA, FADD, FMUL, FMNMX).  Prints one line per loop and,
last, one JSON object with the counts.  Needs nvcc and cuobjdump (the CUDA
toolkit); no card.
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
_FP32 = ("FFMA", "FADD", "FMUL", "FMNMX")


def loops(sass: str) -> list[dict]:
    """Every loop of every function in ``sass`` that holds an FMNMX, with its
    instruction counts by class."""
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
            counts["all"] = len(body)
            if counts["FMNMX"]:
                out.append({"function": name, "start": hex(int(m.group(1), 16)),
                            "end": hex(addr), **counts})

    for line in sass.splitlines():
        if "Function :" in line:
            flush()
            name, ins = line.split("Function :")[1].strip(), []
            continue
        m = _INSTR.search(line)
        if m and name:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    flush()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--kernels", nargs="+", default=["coarse_rank", "coarse_linear_rank"])
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
        found = loops(sass)
        for lp in found:
            fp32 = sum(lp[c] for c in _FP32)
            print(f"[sass] {k}: loop {lp['start']}-{lp['end']} of {lp['function'][:60]}: "
                  f"{lp['all']} instructions, LDS {lp['LDS']}, fp32 {fp32} ("
                  + ", ".join(f"{c} {lp[c]}" for c in _FP32) + ")", flush=True)
        result["kernels"][k] = found
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
