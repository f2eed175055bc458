"""Readings for the limits that decide `correct`: a cell's driver run
once per seed in one process, sound (the program as configured) and as
the control (the program with TF32 matmuls on, the nearest precision
below the configurations' float32), each printing every number the
check computes.  Not part of a benchmark run.

    python3 benchmark/calibrate.py --workload bench.frame --seeds 11 12 13 \\
        [--control-seeds 21 22 23] [--fault train.half --fault-seeds 31 32 33] \\
        [--seconds 1] [--out chiprun_out/calib.jsonl]

Sound runs give each limit's lower reading, the control its upper one;
a fault planted in the program (faults.py) gives a training cell's
upper readings where the control gives no number (PERF.md sets each
limit between them).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import faults  # noqa: E402
from benchmark.harness import card, manifest  # noqa: E402
from benchmark.harness.driver import Context, log  # noqa: E402


class _Patches:
    """A monkeypatch for faults.plant that undo() reverts."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved.clear()


def reading(cell, seed: int, seconds: float, tf32: bool = False, fault: str | None = None,
            device: str = "cuda") -> dict:
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                  t_start=time.perf_counter(), device=device, tf32=tf32)
    patches = _Patches()
    if fault:
        faults.plant(fault, patches)
    try:
        out = cell.driver().run(ctx)
    finally:
        patches.undo()
    return {"workload": cell.name, "seed": seed,
            "control": "tf32" if tf32 else (f"fault {fault}" if fault else None),
            "correct": out.correct, "attempted": out.attempted, "numbers": out.numbers,
            "e2e": out.e2e}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault")
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    card.require_cards(cell.chips)
    log(f"calibrating {cell.name} on {card.name_and_limit()}")
    runs = ([(s, False, None) for s in args.seeds] + [(s, True, None) for s in args.control_seeds]
            + [(s, False, args.fault) for s in args.fault_seeds])
    for seed, tf32, fault in runs:
        line = json.dumps(reading(cell, seed, args.seconds, tf32, fault))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
