"""Where a benchmark cell's traced window goes, stage by stage: one traced
run of the cell (as `benchmark/run.py --trace 1` runs it), then a table of
the program's `mcpt::` spans (utils/profiling) over that window.

    python3 tools/stage_table.py --workload bench.frame --seed 7 \
        [--out out/stages.json] [--root DIR] [--device cuda]

For each stage name: spans, wall (the union of its spans), self time (less
the spans inside it), the kernel launches its outermost spans counted
(ops.kernels.LAUNCHES) and the device-busy seconds during its spans, each
per unit of the cell's work (frame, step or preview frame), and the share
of the window's wall that the main thread's spans cover.  For
`mcpt::sample`, one span a sample pass, it also gives the samples per span
(the third element of the span's ident: block, first sample, samples), so
spans per unit and samples per span say how far forward blocks batch
their samples.  Prints the
table, then the run's result line as run.py prints it (on the CPU, with
--device cpu and a --root holding a small configuration, only `correct`
and the per-layer metrics); `--out` also writes both as JSON.  On several
cards the table is rank 0's.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import manifest, stages, trace  # noqa: E402
from benchmark.harness.driver import Context, log  # noqa: E402


def stage_table(events, recs, lo: int, hi: int) -> list[dict]:
    """Per `mcpt::` stage name in [lo, hi]: spans, wall, self time,
    launches of its outermost spans of that name, device-busy seconds
    during its spans and, for sample passes, their samples, the largest
    wall first."""
    spans = stages.clipped(recs, lo, hi)
    own = stages.self_ns(spans)
    busy = stages.merged((max(e.start_ns, lo), min(e.end_ns, hi))
                         for e in trace.device_events(events))
    rows, intervals = {}, defaultdict(list)
    for i, (r, s, e) in spans.items():
        row = rows.setdefault(r.name, {"stage": r.name, "spans": 0, "self_s": 0.0,
                                       "launches": defaultdict(int)})
        row["spans"] += 1
        if r.name == "mcpt::sample":
            row["samples"] = row.get("samples", 0) + r.ident[2]
        row["self_s"] += own[i] / 1e9
        intervals[r.name].append((s, e))
        outer = spans.get(r.parent)
        while outer is not None and outer[0].name != r.name:
            outer = spans.get(outer[0].parent)
        if outer is None:
            for k, v in r.launches.items():
                row["launches"][k] += v
    for name, row in rows.items():
        iv = stages.merged(intervals[name])
        row["wall_s"] = stages.length(iv) / 1e9
        row["device_busy_s"] = stages.overlap(iv, busy) / 1e9
        row["launches"] = dict(row["launches"])
    return sorted(rows.values(), key=lambda r: r["wall_s"], reverse=True)


def main_thread_cover(recs, lo: int, hi: int, thread: int) -> float:
    """Share of [lo, hi] inside some span of `thread`."""
    spans = stages.clipped(recs, lo, hi)
    return stages.length(stages.merged(
        (s, e) for r, s, e in spans.values() if r.thread == thread)) / (hi - lo)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("tools/stage_table.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    run = manifest.load_module(ROOT / "benchmark" / "run.py", "bench_run_module")
    cell = manifest.load_cell(args.workload, root=Path(args.root))
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=True,
                  t_start=T_START, device=args.device)
    outcome = cell.driver().run(ctx)
    line = run.result_line(cell, outcome, True) if args.device == "cuda" else {
        "correct": outcome.correct, "metrics": run.layer_metrics(cell, outcome.layer)}
    events = outcome.layer.events
    lo, hi = trace.window_bounds(events)
    recs = stages.records()
    units = max(outcome.attempted, 1)
    table = stage_table(events, recs, lo, hi)
    cover = main_thread_cover(recs, lo, hi, threading.get_native_id())
    log(f"{cell.name} seed {args.seed}: window {(hi - lo) / 1e9:.4f} s over {units} unit(s); "
        f"main thread's spans cover {100 * cover:.2f}% of it")
    log(f"{'stage':24s} {'spans/u':>8s} {'wall s/u':>9s} {'self s/u':>9s} "
        f"{'busy s/u':>9s}  launches/u")
    for row in table:
        launches = {k: v / units for k, v in row["launches"].items()}
        batch = f"; {row['samples'] / row['spans']:.2f} samples/span" if "samples" in row else ""
        log(f"{row['stage']:24s} {row['spans'] / units:8.1f} {row['wall_s'] / units:9.4f} "
            f"{row['self_s'] / units:9.4f} {row['device_busy_s'] / units:9.4f}  {launches}"
            f"{batch}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": cell.name, "seed": args.seed, "units": units,
             "window_s": (hi - lo) / 1e9, "main_thread_cover": cover, "stages": table,
             "line": line}))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
