"""What every driver shares: the run's context, the program's set-up, the
traced window, and the outcome it hands back to run.py.

A driver (drivers/<name>.py) has `run(ctx) -> Outcome`.  It builds the
scene from the configuration, warms up the cell's own shapes, runs the
window (untraced, or traced with `ctx.trace`), reads the peak memory,
frees the program's state and then compares what the window produced
with the plain reference.  `ctx.device` is "cuda" in a benchmark run and
"cpu" only in the harness's own tests, which drive the same code at
tiny sizes.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np

from benchmark.harness import trace as trace_mod
from benchmark.harness.spans import Spans


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Check:
    """One number compared, with its limit: ok when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back.  `e2e` holds the end-to-end metrics' values
    by name (setup_s included); `layer` is the per-layer readers' context,
    `busy_s` / `window_s` the device's busy and window seconds and
    `breakdown` the top device operations and idle gaps (traced runs)."""
    e2e: dict
    checks: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    layer: object = None
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None
    count: int = 1
    numbers: dict = field(default_factory=dict)   # every number the check computed

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(c.ok for c in self.checks)


@dataclass
class Context:
    cell: object                 # manifest.Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float               # perf_counter at process start
    device: str = "cuda"
    spans: Spans = field(default_factory=Spans)
    # the control of how `correct` is decided: the program with TF32
    # matmuls on (calibration and the card-only tests only)
    tf32: bool = False

    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def scene_spec(self):
        return self.cell.scene_module().scene(self.cell.config)


def prepare_torch(ctx: Context):
    """Import torch, set the precision the configurations state (float32
    matmuls without TF32; TF32 only for the control) and reset the peak."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = ctx.tf32
    torch.backends.cudnn.allow_tf32 = ctx.tf32
    if ctx.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    return torch


def build_scene(ctx: Context, spec):
    """The program's SceneData, built under the `scene_build` span."""
    from benchmark.harness.scene import to_program

    with ctx.spans.span("scene_build", ctx.sync):
        sd = to_program(spec).build(ctx.device)
    return sd


def memory_peak(ctx: Context) -> int:
    if ctx.device != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated())


def plain_calls() -> int:
    from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES

    return int(LAUNCHES["plain"])


class Window:
    """The measured window.  Untraced: only the host clock.  Traced: a
    profiler session and the `bench.window` annotation around the work,
    closed by a synchronise, so busy time and the window's wall come from
    the same session."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.session = trace_mod.Session(ctx.device) if ctx.trace else None
        self.events = None
        self.start = self.end = None
        self._annotation = None

    def __enter__(self):
        self.ctx.sync()
        if self.session is not None:
            import torch

            self.session.start()
            self._annotation = torch.autograd.profiler.record_function(trace_mod.MARKER)
            self._annotation.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ctx.sync()
        self.end = time.perf_counter()
        if self.session is not None:
            self._annotation.__exit__(None, None, None)
            self.events = self.session.stop()
        return False

    def traced(self):
        """(busy_s, window_s, breakdown) of the traced window."""
        lo, hi = trace_mod.window_bounds(self.events)
        busy = trace_mod.busy_s(self.events, lo, hi)
        kinds = {}
        for e in self.events:
            kinds[e.kind] = kinds.get(e.kind, 0) + 1
        log(f"trace: {len(self.events)} events by kind {kinds}; profiler stop "
            f"{self.session.disable_s:.1f} s, events {self.session.read_s}")
        t = time.perf_counter()
        breakdown = {"device_ops": trace_mod.top_device_ops(self.events),
                     "idle_gaps": trace_mod.idle_gaps(self.events, lo, hi)}
        log(f"trace: busy {busy:.4f} s of {(hi - lo) / 1e9:.4f} s; breakdown in "
            f"{time.perf_counter() - t:.1f} s")
        return busy, (hi - lo) / 1e9, breakdown


@dataclass
class LayerContext:
    """What the per-layer readers read (metrics/<name>.py, `read(ctx)`)."""
    events: list | None          # the traced window's events (harness.trace.Event)
    busy_s: float | None
    window_s: float | None
    spans: Spans
    work: dict                   # the traced window's work: units, samples, rays...
    extra: dict = field(default_factory=dict)


def release(ctx: Context) -> None:
    """Return the freed program state's device memory before the
    reference runs (the caller has dropped its references)."""
    import gc

    gc.collect()
    if ctx.device == "cuda":
        import torch

        torch.cuda.empty_cache()
