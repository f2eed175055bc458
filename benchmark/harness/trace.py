"""The traced window: a torch.profiler (Kineto) session over CPU and CUDA
activity, read without building the profiler's Python event tree, and the
arithmetic the per-layer metrics and the breakdown take from it.

A bench frame launches about a million kernels, so the session is read
through `torch.autograd._disable_profiler()`'s raw Kineto events (a few
microseconds each) instead of `torch.profiler.profile.__exit__`, which
builds a Python object per event and nests them.  Each event becomes an
`Event` tuple on one clock (nanoseconds, Kineto's CPU-aligned time base):

    kind  "kernel" | "memcpy" | "memset" (device), "op" (a host operator),
          "annotation" (a host record_function range), "runtime" (a CUDA
          runtime or driver call), "device_annotation", "other" (classify)
    name, start_ns, end_ns, thread (host thread id; device events: the
    device index)

Busy time is the union of the device events' intervals ("kernel",
"memcpy" and "memset": every stretch in which an operation ran on the
device); idle share is 1 - busy / the traced window's wall, both of the
same session.  Idle gaps are labelled by the innermost host event open at
the gap's start (a CUDA runtime or driver call, or the operator that
holds it), on whichever host thread opened its event last.

The session records host operators and CUDA activity (kernels, copies,
sets and the runtime calls that launch them).  Recording the operators
roughly doubles a launch-bound frame's host time under the profiler
(PERF.md), so a traced window's idle share is the traced program's.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import NamedTuple

DEVICE_KINDS = ("kernel", "memcpy", "memset")
TOP = 10   # entries per breakdown list
MARKER = "bench.window"   # the host annotation around the traced work
HOST_KINDS = ("op", "runtime")   # what labels an idle gap
IDLE_HOST = "(host between CUDA calls)"


class Event(NamedTuple):
    kind: str
    name: str
    start_ns: int
    end_ns: int
    thread: int


def classify(name: str, on_device: bool) -> str:
    """An event's kind from its name and side (the torch of the card
    machine gives no activity type): device events are copies, sets, the
    window's annotation or kernels; host events CUDA runtime or driver
    calls, operators ("ns::name") or other ranges."""
    if on_device:
        if name.startswith("Memcpy"):
            return "memcpy"
        if name.startswith("Memset"):
            return "memset"
        return "device_annotation" if name == MARKER else "kernel"
    if name == MARKER:
        return "annotation"
    if name.startswith(("cuda", "cu")) and "::" not in name:
        return "runtime"
    return "op" if "::" in name else "other"


class Session:
    """One profiler session over CPU and CUDA activity: `start()`, the
    traced work, `stop()` -> [Event].  `stop` synchronises the card first,
    so every kernel the work queued is in the session."""

    def __init__(self, device: str = "cuda"):
        self.device = device
        self._prof = None

    def start(self) -> None:
        import torch.autograd.profiler as autograd_profiler

        # use_kineto: CUPTI's kernel records; without it the profiler falls
        # back to a pair of CUDA events around every operator
        prof = autograd_profiler.profile(use_device="cuda" if self.device == "cuda" else None,
                                         use_kineto=True)
        prof._prepare_trace()
        prof._start_trace()
        self._prof = prof

    def stop(self) -> list[Event]:
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        result = torch.autograd._disable_profiler()
        self.disable_s = time.perf_counter() - t
        self._prof = None
        out = []
        cuda = torch.autograd.DeviceType.CUDA
        t0 = time.perf_counter()
        events = result.events()
        t1 = time.perf_counter()
        for e in events:
            kind = classify(e.name(), e.device_type() == cuda)
            start = e.start_ns()
            out.append(Event(kind, e.name(), start, start + e.duration_ns(),
                             e.device_index() if kind in DEVICE_KINDS else e.start_thread_id()))
        self.read_s = {"events": t1 - t0, "convert": time.perf_counter() - t1}
        return out


def union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_events(events, kinds=DEVICE_KINDS) -> list[Event]:
    return [e for e in events if e.kind in kinds]


def busy_s(events, start_ns: int, end_ns: int) -> float:
    """Seconds of [start_ns, end_ns] in which some operation ran on the
    device."""
    return union_ns((max(e.start_ns, start_ns), min(e.end_ns, end_ns))
                    for e in device_events(events)
                    if e.end_ns > start_ns and e.start_ns < end_ns) / 1e9


def idle_share(busy: float, window: float) -> float:
    """1 - busy / window, as a share (0..1)."""
    if window <= 0:
        raise ValueError("the traced window has no length")
    return 1.0 - busy / window


def kernel_count(events) -> int:
    """CUDA kernels in the session."""
    return sum(1 for e in events if e.kind == "kernel")


def per_unit_kernels(ctx, unit: str):
    """A per-layer reader's kernels per `unit` of the traced work (None
    when nothing was traced or no such unit)."""
    units = ctx.work.get(unit)
    if ctx.events is None or not units:
        return None
    return kernel_count(ctx.events) / units


def idle_percent(ctx, unit: str):
    """A per-layer reader's idle share in %, when the traced work has
    `unit`s: 100 x (1 - busy / window); on several cards the mean over the
    ranks' (busy, window) pairs in ctx.extra["ranks"]."""
    if unit not in ctx.work:
        return None
    pairs = ctx.extra.get("ranks") or [(ctx.busy_s, ctx.window_s)]
    if any(b is None or not w for b, w in pairs):
        return None
    return 100.0 * sum(idle_share(b, w) for b, w in pairs) / len(pairs)


def top_device_ops(events, n: int = TOP) -> list[list]:
    """The device operations that took most time: [[name, seconds], ...]."""
    totals = defaultdict(int)
    for e in device_events(events):
        totals[e.name] += e.end_ns - e.start_ns
    best = sorted(totals.items(), key=lambda kv: kv[1], reverse=True)[:n]
    return [[name, ns / 1e9] for name, ns in best]


def _innermost_segments(ops):
    """Per host thread, the timeline of its innermost open operator:
    {thread: (starts, ends, names, opened)} with `opened` the start of
    the operator that owns each segment."""
    by_thread = defaultdict(list)
    for e in ops:
        by_thread[e.thread].append(e)
    out = {}
    for thread, evs in by_thread.items():
        evs.sort(key=lambda e: (e.start_ns, -e.end_ns))
        starts, ends, names, opened = [], [], [], []
        stack = []   # open operators, outermost first
        cursor = None

        def emit(upto):
            nonlocal cursor
            if stack and cursor is not None and upto > cursor:
                top = stack[-1]
                starts.append(cursor)
                ends.append(upto)
                names.append(top.name)
                opened.append(top.start_ns)
            cursor = upto

        for e in evs:
            while stack and stack[-1].end_ns <= e.start_ns:
                emit(stack[-1].end_ns)
                stack.pop()
            emit(e.start_ns)
            stack.append(e)
        while stack:
            emit(stack[-1].end_ns)
            stack.pop()
        out[thread] = (starts, ends, names, opened)
    return out


def _label_at(segments, t: int) -> str:
    best, best_open = IDLE_HOST, None
    for starts, ends, names, opened in segments.values():
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and ends[i] > t and (best_open is None or opened[i] > best_open):
            best, best_open = names[i], opened[i]
    return best


def idle_gaps(events, window_start_ns: int, window_end_ns: int, n: int = TOP) -> list[list]:
    """Device idle time inside the window, summed by the innermost host
    operator open at each gap's start: [[operator, seconds], ...], the
    largest first."""
    spans = sorted((e.start_ns, e.end_ns) for e in device_events(events))
    gaps, cursor = [], window_start_ns
    for s, e in spans:
        if s > cursor:
            gaps.append((cursor, min(s, window_end_ns)))
        cursor = max(cursor, e)
    if window_end_ns > cursor:
        gaps.append((cursor, window_end_ns))
    segments = _innermost_segments([e for e in events if e.kind in HOST_KINDS])
    totals = defaultdict(int)
    for s, e in gaps:
        if e > s:
            totals[_label_at(segments, s)] += e - s
    best = sorted(totals.items(), key=lambda kv: kv[1], reverse=True)[:n]
    return [[name, ns / 1e9] for name, ns in best]


def window_bounds(events, marker: str = MARKER) -> tuple[int, int]:
    """The traced window on the events' clock: the host annotation
    `marker` that the driver opens around the traced work (it ends after a
    synchronise, so it holds every kernel of that work)."""
    marks = [e for e in events if e.name == marker and e.kind == "annotation"]
    if len(marks) != 1:
        raise RuntimeError(f"expected one {marker!r} annotation in the trace, found {len(marks)}")
    return marks[0].start_ns, marks[0].end_ns
