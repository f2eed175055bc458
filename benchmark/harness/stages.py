"""The program's own stage spans over the traced window.

The port records a span per stage of its work (`mcpt::render`,
`mcpt::sample`, `mcpt::closest`, `mcpt::train.backward`, ...;
mc_path_tracer_tpu_torch/utils/profiling.py) while a profiler session
records, in memory, in the process that does the work: each record holds
its name, its edges in ns of time.time_ns() (the clock of the session's
events, so of the device events harness/trace.py reads), its host thread
and the index of the record open around it on that thread.  A reader
takes them from this process; a program that records no spans gives
none, and the readers then return None.

Every span is clipped to the traced window (trace.window_bounds).  A
span's self time is its clipped duration less the union of its children's
(the spans whose parent it is, on its own thread).
"""

from __future__ import annotations

from collections import defaultdict

from benchmark.harness import trace

PREFIX = "mcpt::"


def records() -> list:
    """This process's span records, by index (None where a span is still
    open); [] where the program keeps none."""
    try:
        from mc_path_tracer_tpu_torch.utils import profiling
    except ImportError:
        return []
    get = getattr(profiling.GLOBAL_TIMINGS, "records", None)
    return list(get()) if get is not None else []


def kept_seconds(names) -> float | None:
    """The process's kept totals of the spans `names` (seconds), None
    where none of them ran."""
    try:
        from mc_path_tracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    t = profiling.GLOBAL_TIMINGS
    if not any(t.counts.get(n, 0) for n in names):
        return None
    return float(sum(t.totals.get(n, 0.0) for n in names))


def merged(intervals) -> list[tuple[int, int]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def length(intervals) -> int:
    return sum(e - s for s, e in intervals)


def overlap(a, b) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def clipped(recs, lo: int, hi: int) -> dict[int, tuple]:
    """{index: (record, start, end)} of the `mcpt::` spans that overlap
    [lo, hi], their edges clipped to it."""
    out = {}
    for i, r in enumerate(recs):
        if r is None or not r.name.startswith(PREFIX):
            continue
        s, e = max(r.start_ns, lo), min(r.end_ns, hi)
        if e > s:
            out[i] = (r, s, e)
    return out


def self_ns(spans: dict) -> dict[int, int]:
    """Each clipped span's self time: its length less the union of its
    children's (clipped) intervals."""
    children = defaultdict(list)
    for i, (r, s, e) in spans.items():
        if r.parent in spans:
            children[r.parent].append((s, e))
    return {i: (e - s) - length(merged(children[i])) for i, (r, s, e) in spans.items()}


def window(ctx):
    """(lo, hi, the window's spans clipped) of a traced run; None when
    nothing was traced or the program recorded no span in the window."""
    if ctx.events is None:
        return None
    lo, hi = trace.window_bounds(ctx.events)
    spans = clipped(records(), lo, hi)
    if not spans or hi <= lo:
        return None
    return lo, hi, spans


def self_share(ctx, names) -> float | None:
    """100 x the self time of the spans `names` in the window over the
    window's wall."""
    got = window(ctx)
    if got is None:
        return None
    lo, hi, spans = got
    own = self_ns(spans)
    return 100.0 * sum(own[i] for i, (r, _, _) in spans.items() if r.name in names) / (hi - lo)


def wall_ns(spans: dict, names) -> int:
    """Length of the union of the spans `names` (on any thread)."""
    return length(merged((s, e) for r, s, e in spans.values() if r.name in names))


def wall_share(ctx, names) -> float | None:
    """100 x the wall inside the spans `names` in the window over the
    window's wall."""
    got = window(ctx)
    if got is None:
        return None
    lo, hi, spans = got
    return 100.0 * wall_ns(spans, names) / (hi - lo)


def idle_outside_share(events, recs, lo: int, hi: int) -> float | None:
    """100 x the device-idle time of [lo, hi] during which no `mcpt::`
    span is open on any host thread, over all device-idle time of it."""
    busy = merged((max(e.start_ns, lo), min(e.end_ns, hi)) for e in trace.device_events(events))
    idle, cursor = [], lo
    for s, e in busy:
        if s > cursor:
            idle.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        idle.append((cursor, hi))
    idle_ns = length(idle)
    if idle_ns <= 0:
        return None
    covered = merged((s, e) for _, s, e in clipped(recs, lo, hi).values())
    return 100.0 * (idle_ns - overlap(idle, covered)) / idle_ns

