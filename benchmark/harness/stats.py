"""The arithmetic of the end-to-end metrics, kept apart so the tests can
hold it on synthetic timings."""

from __future__ import annotations

import math


def rays_per_sample(max_depth: int) -> int:
    """Nominal traced rays per pixel-sample at depth D: 1 camera ray, D - 2
    extension closest hits and 2 (D - 1) any-hits (the port's
    utils/profiling.rays_per_sample, frozen here)."""
    return 1 + max(max_depth - 2, 0) + 2 * max(max_depth - 1, 0)


def nominal_rays(width: int, height: int, spp: int, max_depth: int) -> int:
    """Nominal rays of one frame."""
    return width * height * spp * rays_per_sample(max_depth)


def rate_per_s(work: float, start: float, end: float) -> float:
    """All the work over all the time from the window's start to the end of
    its last unit: a stall anywhere in the window counts."""
    if end <= start:
        raise ValueError("the window has no length")
    return work / (end - start)


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of every value, linearly
    interpolated between order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def beyond(values, q: float) -> int:
    """How many values lie above the q-th percentile."""
    p = percentile(values, q)
    return sum(1 for v in values if v > p)
