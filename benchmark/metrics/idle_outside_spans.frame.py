"""idle_outside_spans.frame: 100 x the device-idle time of the traced
window during which no `mcpt::` span of the program is open on any host
thread of this process, over all device-idle time of the window
(harness/stages.py).  It says how much of the idle time the program's
stage spans leave unexplained.  On several cards: rank 0's."""

from benchmark.harness import stages, trace


def read(ctx):
    if ctx.events is None or "pixel_samples" not in ctx.work:
        return None
    recs = stages.records()
    if not recs:
        return None
    lo, hi = trace.window_bounds(ctx.events)
    return stages.idle_outside_share(ctx.events, recs, lo, hi)
