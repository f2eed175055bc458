"""The benchmark of mc_path_tracer_tpu_torch: one cell of BENCHMARK.json,
run once, on the cards of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration, traffic and metrics by name
(harness/manifest.py), refuses to run without the cards the cell asks for,
runs the traffic's driver (set-up and warm-up, the measured window, the
comparison with the plain reference) and prints, as the last line of
standard output, one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1), device (and busy_s / window_s when traced), breakdown (traced
runs) and, last, checks: each number compared with its limit.  The same
numbers are the last lines of standard error.  Progress goes to standard
error.  Exits non-zero, printing no result, without the cards, when a
JAX module is loaded once the window has closed, or when the run fails.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import card, guard, manifest  # noqa: E402
from benchmark.harness.driver import Context, LayerContext, log  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser("benchmark/run.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def layer_metrics(cell, layer: LayerContext) -> dict:
    """Each per-layer metric's reader over the traced window; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"]).read(layer)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell, outcome, trace: bool) -> dict:
    if trace:
        metrics = layer_metrics(cell, outcome.layer)
    else:
        missing = [m["name"] for m in cell.end_to_end if m["name"] not in outcome.e2e]
        if missing:
            raise RuntimeError(f"the driver measured no {missing}")
        metrics = {m["name"]: {"value": float(outcome.e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = card.device_entry(outcome.count, outcome.memory_peak_bytes)
    if trace:
        device.update(busy_s=float(outcome.busy_s), window_s=float(outcome.window_s))
    line = {"correct": outcome.correct, "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics, "device": device}
    if trace and outcome.breakdown is not None:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {c.name: {"value": float(c.value), "limit": float(c.limit)}
                      for c in outcome.checks}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    cell = manifest.load_cell(args.workload)
    try:
        card.require_cards(cell.chips)
    except card.NoCard as e:
        log(f"refused: {e}")
        return 2
    log(f"{cell.name}: seed {args.seed}, {args.seconds} s, trace {args.trace}, "
        f"{cell.chips} card(s): {card.name_and_limit()}")
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  t_start=T_START)
    outcome = cell.driver().run(ctx)
    found = guard.forbidden_modules()
    if found:
        log(f"refused: JAX modules loaded in the process that reports: {found}")
        return 3
    line = result_line(cell, outcome, bool(args.trace))
    for c in outcome.checks:
        log(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
