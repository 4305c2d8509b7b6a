#!/usr/bin/env python3
"""Issue slots an element of K1 (``csrc/fused_noise.cu``) in gaussian_noise's
mode, counted from its SASS.

Run from the root of a checkout, on a machine with the CUDA toolkit:

    python3 scripts/count_k1_sass.py            # builds fused_noise.cu, dumps, counts
    python3 scripts/count_k1_sass.py --sass FILE  # counts a saved `cuobjdump -sass` dump
    python3 scripts/count_k1_sass.py --out int8   # the int8 path's centered_u8 mode

The instance is ``fused_noise_kernel<0, 1, true>`` (gaussian, bf16 out,
vector loads and stores: the float path's), or with ``--out int8``
``fused_noise_kernel<0, 2, true>`` (the centered int8 grid out: the int8
path's). Its thread handles 4 elements
in straight-line code, so the count of the instructions a thread issues,
over 4, is its issue slots an element. The method:

- take the kernel's main body, from its entry to its last ``EXIT``; the
  out-of-line subroutines after it (the slow paths of ``sqrtf`` and
  ``__fdiv_rn``, for special or denormal operands) are not issued;
- drop each region that a forward conditional branch skips when it holds a
  ``CALL`` (the call of such a slow path) or a backward branch (cosf's
  Payne-Hanek reduction, a loop through local memory taken only for
  |x| > 105615; here x ≤ 2π); the branch itself is issued;
- count every other instruction once, predicated ones included.

It prints the count, its split by kind (Philox's integer multiplies and
logic, float arithmetic, the special-function unit, the rest) and the
bound it gives at 33.5 T lane-instructions a second (132 SMs × 4 warp
instructions a clock × 32 lanes × 1.98 GHz).
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# <kGaussian, out kind, VEC> by --out (ops/noise.py::_OUT_KIND: bf16 1, int8 2)
INSTANCES = {"bf16": "fused_noise_kernelILi0ELi1ELb1E", "int8": "fused_noise_kernelILi0ELi2ELb1E"}
ELEMENTS = 4  # csrc/fused_noise.cu: kPerThread
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def instructions(sass: str, instance: str) -> list[tuple[int, str]]:
    """(address, instruction) of the instance's function in a dump."""
    start = sass.find("Function : ")
    while start >= 0 and instance not in sass[start:sass.find("\n", start)]:
        start = sass.find("Function : ", start + 1)
    if start < 0:
        raise SystemExit(f"count_k1_sass: no {instance} in the dump")
    end = sass.find("Function : ", start + 1)
    body = sass[start:end if end >= 0 else len(sass)]
    return [(int(a, 16), text) for a, text in LINE.findall(body)]


def main_path(code: list[tuple[int, str]]) -> list[str]:
    """The instructions of the main path, by the rules of the docstring."""
    last_exit = max(i for i, (_, t) in enumerate(code) if re.search(r"\bEXIT\b", t))
    body = code[:last_exit + 1]
    index = {a: i for i, (a, _) in enumerate(body)}
    skip = set()
    for i, (addr, text) in enumerate(body):
        m = re.match(r"@!?U?P\w+\s+BRA\s+(?:!?U?P\w+,\s*)?0x([0-9a-f]+)", text)
        if not m or int(m.group(1), 16) <= addr or int(m.group(1), 16) not in index:
            continue
        region = range(i + 1, index[int(m.group(1), 16)])
        slow = any("CALL" in body[j][1] for j in region) or any(
            (b := re.search(r"\bBRA\s+(?:!?U?P\w+,\s*)?0x([0-9a-f]+)", body[j][1]))
            and int(b.group(1), 16) <= body[j][0] for j in region)
        if slow:
            skip.update(region)
    return [t for i, (_, t) in enumerate(body) if i not in skip and not t.startswith("NOP")]


def kind(text: str) -> str:
    op = text.split()[1] if text.startswith("@") else text.split()[0]
    op = op.split(".")[0]
    if op in ("IMAD", "LOP3", "IADD3", "UIADD3", "UIMAD", "SHF", "VIADD", "LEA", "IMNMX"):
        return "integer"
    if op in ("FFMA", "FMUL", "FADD", "FSEL", "FSETP", "FRND", "FCHK", "HFMA2", "FMNMX"):
        return "float"
    if op == "MUFU":
        return "special function"
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sass", type=Path, help="a saved cuobjdump -sass dump of fused_noise")
    parser.add_argument("--out", choices=sorted(INSTANCES), default="bf16",
                        help="the output mode's instance (default bf16)")
    args = parser.parse_args()
    instance = INSTANCES[args.out]
    if args.sass:
        sass = args.sass.read_text()
    else:
        from robustart_torch.ops import build

        build.build(["fused_noise"])
        tool = Path(build.nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(tool), "-sass", str(build.library_path("fused_noise"))],
                              capture_output=True, text=True, check=True).stdout
    code = instructions(sass, instance)
    path = main_path(code)
    split = {}
    for text in path:
        split[kind(text)] = split.get(kind(text), 0) + 1
    per = len(path) / ELEMENTS
    print(f"[k1 sass] {instance}: {len(code)} instructions in the function, {len(path)} on the "
          f"main path of a thread ({ELEMENTS} elements): {per:g} issue slots an element; "
          + ", ".join(f"{k} {v}" for k, v in sorted(split.items())))
    print(f"[k1 sass] issue bound at 128 x 224^2 x 3 elements: "
          f"{128 * 224 * 224 * 3 * per / 33.5e12 * 1e3:.4f} ms (33.5 T lane-instructions/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
