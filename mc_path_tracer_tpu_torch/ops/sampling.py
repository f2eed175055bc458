"""Monte Carlo samplers and MIS heuristics (port of
mc_path_tracer_tpu/ops/sampling.py).

All samplers take uniform variates in [0, 1) with shape [..., 2] and return
directions/points broadcast over the batch axes.
"""

from __future__ import annotations

import torch

from mc_path_tracer_tpu_torch.ops.math import PI, TWO_PI


def sample_uniform_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Uniform hemisphere around +y (cos(theta) = e0); local-frame
    (x, y=cos_theta, z); pdf = 1/(2 pi)."""
    e0, e1 = u[..., 0], u[..., 1]
    sin_theta = torch.sqrt(torch.clamp(1.0 - e0 * e0, min=0.0))
    phi = TWO_PI * e1
    return torch.stack(
        [sin_theta * torch.cos(phi), e0, sin_theta * torch.sin(phi)], dim=-1
    )


def sample_cosine_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere around +y; pdf = cos(theta)/pi."""
    e0, e1 = u[..., 0], u[..., 1]
    cos_theta = torch.sqrt(torch.clamp(1.0 - e0, min=0.0))
    sin_theta = torch.sqrt(e0)
    phi = TWO_PI * e1
    return torch.stack(
        [sin_theta * torch.cos(phi), cos_theta, sin_theta * torch.sin(phi)],
        dim=-1,
    )


def sample_uniform_sphere(u: torch.Tensor) -> torch.Tensor:
    """Uniform sphere; pdf = 1/(4 pi)."""
    e0, e1 = u[..., 0], u[..., 1]
    y = 1.0 - 2.0 * e0
    sin_theta = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    phi = TWO_PI * e1
    return torch.stack(
        [sin_theta * torch.cos(phi), y, sin_theta * torch.sin(phi)], dim=-1
    )


def sample_uniform_disk(u: torch.Tensor) -> torch.Tensor:
    """Uniform disk via sqrt warp; returns [..., 2]."""
    r = torch.sqrt(u[..., 0])
    phi = TWO_PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def sample_concentric_disk(u: torch.Tensor) -> torch.Tensor:
    """Concentric disk mapping (PBRT / jek::concentric_sample_disk), used by
    the thin-lens camera."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    zero = (torch.abs(ox) < 1e-12) & (torch.abs(oy) < 1e-12)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(
        use_x,
        (PI / 4.0) * (oy / torch.where(use_x, ox, 1.0)),
        (PI / 2.0) - (PI / 4.0) * (ox / torch.where(use_x, 1.0, oy)),
    )
    pt = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    return torch.where(zero[..., None], 0.0, pt)


def power_heuristic(nf: float, f_pdf: torch.Tensor, ng: float,
                    g_pdf: torch.Tensor) -> torch.Tensor:
    """Power heuristic (beta = 2), matching dMaterial.cu:134-139."""
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    return torch.where(denom > 0.0, f * f / torch.clamp(denom, min=1e-38), 0.0)
