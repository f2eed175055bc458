"""The numbers that decide `correct`: the program's answers against the
plain reference's, reduced to a few numbers that each traffic's
`limits` bound.  Every function returns all its numbers; a traffic file
names the ones it holds to a limit."""

from __future__ import annotations

import statistics

import numpy as np

# a pixel's radiance error is relative to its reference radiance plus this
# floor, so that black pixels do not divide by zero
RAD_FLOOR = 1e-3
# a pixel whose relative error passes this counts as off
RAD_OFF = 1e-3


def sample_pixels(seed: int, width: int, height: int, frames: int, total: int):
    """`total` pixels drawn from the seed, spread over the window's frames:
    one (px, py) pair of int arrays per frame, at least one pixel each."""
    gen = np.random.default_rng(seed)
    out = []
    for f in range(frames):
        k = total // frames + (1 if f < total % frames else 0)
        idx = gen.choice(width * height, size=max(k, 1), replace=False)
        out.append((idx % width, idx // width))
    return out


def pixels(got_rad, want_rad, got_u8=None, want_u8=None) -> dict:
    """Per-pixel radiance [k, 3] and display bytes [k, 3]:
    rad_off_share: the share of pixels whose largest channel's
      |got - want| / (|want| + RAD_FLOOR) passes RAD_OFF (NaN counts as off);
    u8_off_share: the share of pixels with a channel more than one level
      off; u8_max_diff: the largest difference in levels."""
    got = np.asarray(got_rad, np.float64)
    want = np.asarray(want_rad, np.float64)
    err = (np.abs(got - want) / (np.abs(want) + RAD_FLOOR)).max(axis=-1)
    out = {"rad_off_share": float(np.mean(~(err <= RAD_OFF)))}
    if got_u8 is not None:
        out.update(bytes_(got_u8, want_u8))
    return out


def bytes_(got_u8, want_u8) -> dict:
    diff = np.abs(np.asarray(got_u8, np.int32) - np.asarray(want_u8, np.int32)).max(axis=-1)
    return {"u8_off_share": float(np.mean(diff > 1)), "u8_max_diff": float(diff.max())}


def norm_gap(got: float, want: float, scale: float) -> float:
    """|got - want| / max(want, scale): a gap of norms, measured against
    the reference's norm or a larger scale (the median leaf's)."""
    denom = max(abs(want), scale)
    return abs(got - want) / denom if denom > 0 else abs(got - want)


def worst_leaf(got_norms: dict, want_norms: dict, leaves) -> float:
    """The worst leaf's norm_gap over `leaves`, against each reference
    norm or the median of the counted leaves' norms, whichever is larger."""
    if not leaves:
        return 0.0
    scale = statistics.median(want_norms[k] for k in leaves)
    return max(norm_gap(got_norms[k], want_norms[k], scale) for k in leaves)


def counted_leaves(grad_norms: dict, rule: float = 1e-3) -> list[str]:
    """The leaves whose reference gradient is at least `rule` times the
    median leaf's (leaves with no element left out): the others move by
    round-off alone."""
    sized = {k: v for k, v in grad_norms.items() if v is not None}
    if not sized:
        return []
    median = statistics.median(sized.values())
    return [k for k, v in sized.items() if v >= rule * median and v > 0]
