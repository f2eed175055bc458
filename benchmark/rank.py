"""One rank of a multi-card cell, other than rank 0: started by the cell's
driver (drivers/frames4.py) with torchrun's environment, never by hand.

    python3 benchmark/rank.py --root DIR --workload CELL --seed N --seconds S
        --trace 0|1 --rank R --world W --port P --device cuda|cpu --tf32 0|1
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import manifest  # noqa: E402
from benchmark.harness.driver import Context  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("benchmark/rank.py")
    for name in ("--root", "--workload", "--device"):
        ap.add_argument(name, required=True)
    for name in ("--seed", "--trace", "--rank", "--world", "--port", "--tf32"):
        ap.add_argument(name, type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload, root=Path(args.root))
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  t_start=T_START, device=args.device, tf32=bool(args.tf32))
    cell.driver().rank_run(ctx, args.rank, args.world, args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
