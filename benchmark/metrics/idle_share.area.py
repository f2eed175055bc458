"""idle_share.area: 100 x (1 - device busy / traced window wall) over the
traced area-lit frames, from one profiler session (busy: the union of the
device's kernel, copy and set intervals)."""

from benchmark.harness import trace


def read(ctx):
    return trace.idle_percent(ctx, "pixel_samples")
