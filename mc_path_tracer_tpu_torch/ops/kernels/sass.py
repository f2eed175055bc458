"""Where the instructions of the port's CUDA kernels go, from their SASS.

    python3 -m mc_path_tracer_tpu_torch.ops.kernels.sass [--save DIR]   # with nvcc
    python3 -m mc_path_tracer_tpu_torch.ops.kernels.sass --load DIR     # saved SASS

Builds (where needed) the libraries of csrc/ through ops/kernels/build,
disassembles each with `cuobjdump -sass`, and prints one JSON line per
kernel: its instruction count, and for each loop (a backward branch and
the instructions from its target to it) the static instruction count and
the count of each opcode class, so the inner loop's instructions per
triangle test can be read off.  `--save` writes each library's SASS to
DIR/<name>.sass; `--load` parses such files instead, with no toolkit.
A measuring aid, not part of any render path.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

from mc_path_tracer_tpu_torch.ops.kernels import build

NAMES = ("traversal", "dense", "tonemap")
_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def cuobjdump() -> str:
    """The toolkit's cuobjdump, beside the nvcc that builds the kernels."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        raise RuntimeError(f"{tool} not found: run with the CUDA toolkit or --load")
    return str(tool)


def parse(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """{kernel symbol: [(address, opcode, operands)]}."""
    kernels: dict[str, list[tuple[int, str, str]]] = {}
    current = None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            current = kernels.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return kernels


def loops(insns: list[tuple[int, str, str]]) -> list[dict]:
    """Each backward branch as a loop: its address range, static
    instruction count and opcode-class counts (base opcode, before the
    first '.')."""
    out = []
    for a, op, args in insns:
        if not op.startswith("BRA"):
            continue
        m = _TARGET.search(args)
        if not m or int(m.group(1), 16) > a:
            continue
        start = int(m.group(1), 16)
        body = [o for x, o, _ in insns if start <= x <= a]
        ops = Counter(o.split(".")[0] for o in body)
        out.append({"start": hex(start), "end": hex(a), "instructions": len(body),
                    "ops": {k: ops[k] for k in sorted(ops, key=lambda k: -ops[k])}})
    return out


def report(name: str, sass: str) -> None:
    for symbol, insns in parse(sass).items():
        ops = Counter(o.split(".")[0] for _, o, _ in insns)
        print(json.dumps({
            "library": name, "kernel": symbol, "instructions": len(insns),
            "fp32": {k: ops[k] for k in ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "MUFU")},
            "loops": loops(insns)}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save", type=Path, help="write each library's SASS here")
    parser.add_argument("--load", type=Path, help="parse SASS saved by --save instead")
    args = parser.parse_args()
    if args.load:
        for name in NAMES:
            path = args.load / f"{name}.sass"
            if path.exists():
                report(name, path.read_text())
        return 0
    tool = cuobjdump()
    for name, (_, info) in build.load_all(NAMES).items():
        sass = subprocess.run([tool, "-sass", str(info.path)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        if args.save:
            args.save.mkdir(parents=True, exist_ok=True)
            (args.save / f"{name}.sass").write_text(sass)
        report(name, sass)
    return 0


if __name__ == "__main__":
    sys.exit(main())
