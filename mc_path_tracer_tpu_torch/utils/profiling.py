"""Profiling and observability (port of mc_path_tracer_tpu/utils/profiling.py):
scoped wall-clock timers with a global registry, the program's stage spans,
ray-throughput accounting for renders, and a device trace.

Spans (`span`, `spanned`) mark the program's stages, all named `mcpt::...`:
the frame's render, sample, camera, trace, bounce, closest, anyhit, sort,
finish_closest, film and tonemap, and the area light's area.sample and
area.hit; the preview's chunks and IBL products;
the train step's forward, backward and all-reduce; the rows of a sharded
frame; the scene's build and the kernels' load.  While a torch profiler
session records, each span appends a `SpanRecord` to `GLOBAL_TIMINGS`:
its edges on `time.time_ns()`, the clock of Kineto's CPU events and so of
the device events a trace holds, its host thread, the record of the span
open around it on that thread, and the kernel launches
(`ops.kernels.LAUNCHES`) made while it was open.  With no session a span
costs one flag check and records nothing, unless it is `keep=True` (the
few coarse spans of set-up and of the train step): those also add to
`totals` / `counts` and keep their last record in every run.  A span
records on the threads whose operators the session records: the thread
that started it and those that inherit its state, as autograd's workers
do while they replay a checkpointed sample.  A span never opens a
`record_function` range, so it adds no event to the device timeline.

`device_trace` takes the place of the JAX package's `xla_trace`: a
torch.profiler session over CPU and CUDA activities that writes a Chrome
trace into `log_dir`.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES


class SpanRecord(NamedTuple):
    """One closed span: edges in ns of time.time_ns(), the host thread
    (threading.get_native_id()), the index of the record open around it on
    that thread (-1: none), the LAUNCHES counters that moved while it was
    open, and the caller's identifier (a sample pass's (block, first
    sample, samples))."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: int
    launches: dict
    ident: object = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _NoSpan:
    """The span of a stage that records nothing: shared, stateless."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    """An open span; `ident` may be set before it closes."""

    __slots__ = ("_timings", "_name", "_keep", "ident", "_records", "_index", "_stack",
                 "_parent", "_launches", "_start")

    def __init__(self, timings, name: str, keep: bool, ident, recording: bool):
        self._timings, self._name, self._keep, self.ident = timings, name, keep, ident
        self._records = timings._records if recording else None

    def __enter__(self):
        self._launches = dict(LAUNCHES)
        self._parent, self._index = -1, None
        if self._records is not None:
            self._stack = self._timings._open_stack()
            self._parent = self._stack[-1] if self._stack else -1
            with self._timings._lock:
                self._index = len(self._records)
                self._records.append(None)
            self._stack.append(self._index)
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        moved = {k: v - self._launches.get(k, 0) for k, v in LAUNCHES.items()
                 if v != self._launches.get(k, 0)}
        record = SpanRecord(self._name, self._start, end, threading.get_native_id(),
                            self._parent, moved, self.ident)
        if self._index is not None:
            self._stack.pop()
            self._records[self._index] = record
        if self._keep:
            t = self._timings
            t.totals[self._name] += (end - self._start) / 1e9
            t.counts[self._name] += 1
            t._last[self._name] = record
        return False


@dataclass
class Timings:
    """Registry of named wall-clock sections and of the program's spans."""

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    _records: list = field(default_factory=list, repr=False, compare=False)
    _last: dict = field(default_factory=dict, repr=False, compare=False)
    _lock: object = field(default_factory=threading.Lock, repr=False, compare=False)
    _local: object = field(default_factory=threading.local, repr=False, compare=False)

    def span(self, name: str, keep: bool = False, ident=None):
        """A context manager around one stage (module docstring): records
        while a torch profiler session records; `keep` also adds to
        totals / counts and keeps the last record with no session."""
        recording = torch.autograd._profiler_enabled()
        if not (recording or keep):
            return _NO_SPAN
        return _Span(self, name, keep, ident, recording)

    def _open_stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def records(self) -> list[SpanRecord]:
        """The spans recorded so far, in the order they opened (a parent
        before its children); a span still open is None."""
        return list(self._records)

    def last(self, name: str) -> SpanRecord | None:
        """The last record of the kept span `name`, traced or not."""
        return self._last.get(name)

    def clear(self) -> None:
        """Drop the recorded spans (kept totals and last records stay)."""
        self._records = []

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = [
            f"{name:30s} {self.totals[name]*1e3:9.2f} ms  x{self.counts[name]}"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps(
            {k: {"total_s": self.totals[k], "count": self.counts[k]}
             for k in self.totals}
        )


GLOBAL_TIMINGS = Timings()
span = GLOBAL_TIMINGS.span


def spanned(name: str, keep: bool = False):
    """Decorator: each call of the function runs inside span(name)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with GLOBAL_TIMINGS.span(name, keep):
                return fn(*args, **kwargs)

        return inner

    return wrap


def rays_per_sample(max_depth: int) -> int:
    """Traced rays per pixel-sample at depth D: 1 camera + (D-2) extension
    closest-hits and 2*(D-1) any-hits (see models/integrator.py)."""
    return 1 + max(max_depth - 2, 0) + 2 * max(max_depth - 1, 0)


@dataclass
class RenderStats:
    width: int
    height: int
    spp: int
    max_depth: int
    seconds: float

    @property
    def total_rays(self) -> int:
        return self.width * self.height * self.spp * rays_per_sample(self.max_depth)

    @property
    def mrays_per_s(self) -> float:
        return self.total_rays / max(self.seconds, 1e-9) / 1e6

    def __str__(self):
        return (
            f"{self.width}x{self.height} {self.spp}spp depth{self.max_depth}: "
            f"{self.seconds:.3f}s  {self.mrays_per_s:.1f} Mrays/s"
        )


@contextlib.contextmanager
def device_trace(log_dir: str, device=DEFAULT_DEVICE):
    """Capture a CPU + CUDA trace of the block (torch.profiler) and write it
    as a Chrome trace, `log_dir`/trace.json.  The card is synchronised
    before the profiler stops, so the trace holds every kernel the block
    queued.  device="cpu" traces CPU activity only; the default, the card,
    raises without one."""
    from torch.profiler import ProfilerActivity, profile

    on_card = resolve_device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if on_card:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
