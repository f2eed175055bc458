"""idle_share.preview: 100 x (1 - device busy / traced window wall) over
the traced preview frames, from one profiler session."""

from benchmark.harness import trace


def read(ctx):
    return trace.idle_percent(ctx, "frames")
