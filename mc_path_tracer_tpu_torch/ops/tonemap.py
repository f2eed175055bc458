"""Tone mapping: exposure + Reinhard, 8-bit quantize (port of
mc_path_tracer_tpu/ops/tonemap.py; the reference's draw_to_surface:
color = Ld/samples * exposure, color/(color + 1), no gamma), and the
luminance heat map, a selectable debug view."""

from __future__ import annotations

import torch

from mc_path_tracer_tpu_torch.ops.math import luminance, mix


def reinhard(ld: torch.Tensor, samples: torch.Tensor, exposure) -> torch.Tensor:
    """Accumulated radiance [..., 3] + per-pixel sample counts [...] ->
    display RGB in [0, 1]."""
    c = ld / torch.clamp(samples, min=1.0)[..., None] * exposure
    return c / (c + 1.0)


def heatmap(ld: torch.Tensor, samples: torch.Tensor, exposure) -> torch.Tensor:
    """Luminance heat-map debug view of the Reinhard display colour:
    blue -> green (lum .15), green -> yellow (.5), yellow -> red (1)."""
    lum = luminance(reinhard(ld, samples, exposure))

    def remap(lo, hi):
        return torch.clamp((lum - lo) / (hi - lo), 0.0, 1.0)[..., None]

    blue, green, yellow, red = (
        torch.tensor(c, dtype=ld.dtype, device=ld.device)
        for c in ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (1.0, 1.0, 0.0), (1.0, 0.0, 0.0)))
    low = mix(blue, green, remap(0.0, 0.15))
    mid = mix(green, yellow, remap(0.15, 0.5))
    high = mix(yellow, red, remap(0.5, 1.0))
    l3 = lum[..., None]
    return torch.where(l3 < 0.15, low, torch.where(l3 < 0.5, mid, high))


def quantize(rgb: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> uint8 by truncating 255 c."""
    return torch.clamp(rgb * 255.0, 0.0, 255.0).to(torch.uint8)
