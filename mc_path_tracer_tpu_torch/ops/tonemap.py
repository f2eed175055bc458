"""Tone mapping: exposure + Reinhard, 8-bit quantize (port of
mc_path_tracer_tpu/ops/tonemap.py; the reference's draw_to_surface:
color = Ld/samples * exposure, color/(color + 1), no gamma)."""

from __future__ import annotations

import torch


def reinhard(ld: torch.Tensor, samples: torch.Tensor, exposure) -> torch.Tensor:
    """Accumulated radiance [..., 3] + per-pixel sample counts [...] ->
    display RGB in [0, 1]."""
    c = ld / torch.clamp(samples, min=1.0)[..., None] * exposure
    return c / (c + 1.0)


def quantize(rgb: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> uint8 by truncating 255 c."""
    return torch.clamp(rgb * 255.0, 0.0, 255.0).to(torch.uint8)
