"""Instruction counts of the port's compiled kernels, from their SASS.

    python -m mri_superresolution_torch.tools.sass_loops [--match NAME ...]

Builds the kernels if needed (``kernels/_build``), disassembles the library
with ``cuobjdump -sass`` and, for every kernel whose mangled name contains
one of the ``--match`` substrings, prints one JSON line: its instruction
count, the count up to its first unpredicated ``EXIT`` (the main path,
without the subroutines placed after it, such as the IEEE division's slow
path), each loop (a branch back to an earlier address) with its count,
and, for the main path and each loop, the instructions that issue on the
SM's quarter-rate pipes (MUFU, conversions, FRND) and the counts of shared
loads and stores (LDS*, STS*), global loads (LDG*) and fp32 FFMA, FMUL and
FADD, with shared loads per FFMA. Dividing a loop's count by the elements
one trip handles gives the instructions an element.

The defaults are kernel B4's two kernels at slope 1.0 (the element kernel
on bf16, 8 elements a thread; the stream kernel, 16 elements a trip) and
B1's one-pass kernel with its int8 output. ``--lib`` disassembles another
build of the library (an older commit's ``build/torch_kernels/*.so``)
instead of this checkout's. Needs the CUDA toolkit (``cuobjdump``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

from mri_superresolution_torch.kernels import _build

DEFAULT_MATCH = ("leaky_quantize_kernelI13__nv_bfloat16Li8E",
                 "leaky_quantize_stream_kernelILb0E",
                 "gn_onepass_kernelI13__nv_bfloat16Li8ELb0ELb1E")
QUARTER_RATE = ("MUFU", "F2I", "I2F", "F2F", "FRND", "F2FP", "I2FP", "F2IP")
# opcode families counted by their first word: every width of a load
COUNTED = ("LDS", "STS", "LDG", "FFMA", "FMUL", "FADD")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_PRED = re.compile(r"^@!?U?P[T0-9]+\s+")


def _cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found (CUDA toolkit required)")


def parse(sass: str) -> dict:
    """{function name: [(address, predicated, opcode, text)]}."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[-1].strip()
            funcs[cur] = []
            continue
        m = _INSN.search(line)
        if cur is None or not m:
            continue
        text = m.group(2).strip()
        pred = bool(_PRED.match(text))
        op = _PRED.sub("", text).split()[0]
        funcs[cur].append((int(m.group(1), 16), pred, op, text))
    return funcs


def _quarter(insns) -> dict:
    c = Counter(op.split(".")[0] for _, _, op, _ in insns)
    return {k: c[k] for k in QUARTER_RATE if c[k]}


def _counted(insns) -> dict:
    c = Counter(op.split(".")[0] for _, _, op, _ in insns)
    out = {k: c[k] for k in COUNTED}
    out["lds_per_ffma"] = c["LDS"] / c["FFMA"] if c["FFMA"] else None
    return out



def summarize(insns) -> dict:
    """Counts of one function's instructions (NOPs left out)."""
    body = [i for i in insns if i[2] != "NOP"]
    main = []
    for i in body:
        main.append(i)
        if i[2] == "EXIT" and not i[1]:
            break
    loops = []
    for addr, _, op, text in body:
        if op.startswith("BRA"):
            t = re.search(r"0x([0-9a-f]+)", text.split("BRA", 1)[1])
            if t and int(t.group(1), 16) <= addr:
                lo = int(t.group(1), 16)
                inner = [i for i in body if lo <= i[0] <= addr]
                loops.append({"from": hex(lo), "to": hex(addr),
                              "instructions": len(inner),
                              "quarter_rate": _quarter(inner),
                              "counts": _counted(inner)})
    return {"instructions": len(body), "main_path": len(main),
            "main_path_quarter_rate": _quarter(main),
            "main_path_counts": _counted(main), "loops": loops}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--match", nargs="+", default=list(DEFAULT_MATCH))
    ap.add_argument("--lib", default=None,
                    help="library to disassemble (default: build this one)")
    args = ap.parse_args(argv)
    lib = args.lib or _build.build()
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    found = 0
    for name, insns in parse(sass).items():
        if any(m in name for m in args.match):
            found += 1
            print(json.dumps({"kernel": name, **summarize(insns)}),
                  flush=True)
    if not found:
        print(f"no kernel matches {args.match}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
