"""Importance-sampled HDR environment light: CDF build, sampling, pdf, lookup
(port of mc_path_tracer_tpu/ops/envmap.py).

  - pdf_texture = lum * sin(pi y/H) / sum(...); marginal row CDF and
    per-row conditional column CDFs (light_initialization_kernels.cu),
    built on the host (`build_distribution`) or in torch on the texture's
    device, differentiable in the texels (`build_distribution_traced`).
  - sampling: two uniforms -> searchsorted(side="right") in the row CDF,
    then in that row's column CDF -> uv = (x/W, y/H) -> equirect direction.
  - pdf(wi) = pdf_texel * W H / (2 pi^2 sin(theta)), texel binned by
    rounding u W (the JAX package's documented deviation, kept).
  - L(wi): bilinear, wrap-addressed equirect fetch.
  - Color mode: uniform-sphere direction, pdf 1/(4 pi).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mc_path_tracer_tpu_torch.ops.math import INV_4PI, PI, equirect_dir, equirect_uv
from mc_path_tracer_tpu_torch.ops.sampling import sample_uniform_sphere

LUMINANCE = (0.299, 0.587, 0.114)   # Rec.601 weights (jek::luminance)
# the environment light's two modes (models/lights.EnvLight; env_is_hdri
# tells them apart by the texture's shape)
COLOR_MODE = 0
HDRI_MODE = 1


class EnvMapDistribution(NamedTuple):
    """CDF tables for environment importance sampling."""

    marginal_cdf: torch.Tensor  # [H] row CDF P(y)
    cond_cdf: torch.Tensor      # [H, W] per-row column CDF P(x|y)
    pdf_texture: torch.Tensor   # [H, W] per-texel pdf (lum * sin / denom)


def build_distribution(tex, device=DEFAULT_DEVICE) -> EnvMapDistribution:
    """Sampling tables from an equirect HDR texture [H, W, 3], built on the
    host in numpy (the JAX package's host build, same arithmetic) and moved
    to `device` once."""
    device = resolve_device(device)
    tex = np.asarray(tex, np.float32)
    h = tex.shape[0]
    lum = tex @ np.asarray(LUMINANCE, np.float32)
    v = np.arange(h, dtype=np.float32) / h
    sin_theta = np.sin(np.pi * v).astype(np.float32)
    weighted = lum * sin_theta[:, None]
    denom = max(float(weighted.sum()), 1e-20)
    pdf_texture = weighted / denom
    marginal_p = pdf_texture.sum(axis=1)
    marginal_cdf = np.cumsum(marginal_p).astype(np.float32)
    cond_p = pdf_texture / np.maximum(marginal_p[:, None], 1e-20)
    cond_cdf = np.cumsum(cond_p, axis=1).astype(np.float32)
    return EnvMapDistribution(
        torch.from_numpy(marginal_cdf).to(device),
        torch.from_numpy(cond_cdf).to(device),
        torch.from_numpy(pdf_texture.astype(np.float32)).to(device),
    )


def build_distribution_traced(tex: torch.Tensor) -> EnvMapDistribution:
    """build_distribution's tables in torch on `tex`'s own device, so that
    gradients reach the texels: for optimisation loops that update the
    environment and rebuild its sampling tables."""
    h = tex.shape[0]
    lum = torch.sum(tex * torch.tensor(LUMINANCE, dtype=tex.dtype, device=tex.device), dim=-1)
    v = torch.arange(h, dtype=torch.float32, device=tex.device) / h
    sin_theta = torch.sin(PI * v)
    weighted = lum * sin_theta[:, None]
    denom = torch.clamp(torch.sum(weighted), min=1e-20)
    pdf_texture = weighted / denom
    marginal_p = torch.sum(pdf_texture, dim=1)
    marginal_cdf = torch.cumsum(marginal_p, dim=0)
    cond_p = pdf_texture / torch.clamp(marginal_p[:, None], min=1e-20)
    cond_cdf = torch.cumsum(cond_p, dim=1)
    return EnvMapDistribution(marginal_cdf, cond_cdf, pdf_texture)


# above this table width/height the flat broadcast-compare search switches to
# the two-level (blocked) form, bounding the per-lane compare width
_SEARCH_BLOCK = 128
_FLAT_SEARCH_MAX = 1024


def _count_le(rows: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Per-lane count of row entries <= e (searchsorted side="right")."""
    return (rows <= e[..., None]).sum(dim=-1)


def _search_rows_2level(cdf_rows: torch.Tensor, row_idx: torch.Tensor,
                        e: torch.Tensor) -> torch.Tensor:
    """Per-lane searchsorted(side="right") of e within cdf_rows[row_idx] in
    two levels: block maxima first ([R, W/B] compare), then one [R, B]
    window gather."""
    h, w = cdf_rows.shape
    b = _SEARCH_BLOCK
    nb = -(-w // b)
    pad = nb * b - w
    if pad:
        # 2.0 > any CDF entry: never counted by <= e
        cdf_rows = torch.nn.functional.pad(cdf_rows, (0, pad), value=2.0)
    coarse = cdf_rows[:, b - 1 :: b]                         # [H, nb]
    blk = torch.clamp(_count_le(coarse[row_idx], e), 0, nb - 1)
    flat = cdf_rows.reshape(h * nb, b)
    off = _count_le(flat[row_idx * nb + blk], e)
    return torch.clamp(blk * b + off, 0, w - 1)


def sample_direction(dist: EnvMapDistribution, u: torch.Tensor):
    """Draw directions from the env distribution; u is [..., 2] uniforms.
    Returns (wi [..., 3], uv [..., 2]) with uv = (x/W, y/H)."""
    h, w = dist.cond_cdf.shape
    ey, ex = u[..., 1], u[..., 0]
    if h <= _FLAT_SEARCH_MAX:
        y = torch.clamp(_count_le(dist.marginal_cdf, ey), 0, h - 1)
    else:
        y = _search_rows_2level(
            dist.marginal_cdf[None, :], torch.zeros_like(ey, dtype=torch.int64), ey
        )
    if w <= _FLAT_SEARCH_MAX:
        x = torch.clamp(_count_le(dist.cond_cdf[y], ex), 0, w - 1)
    else:
        x = _search_rows_2level(dist.cond_cdf, y, ex)
    uv = torch.stack(
        [x.to(torch.float32) / w, y.to(torch.float32) / h], dim=-1
    )
    return equirect_dir(uv), uv


def pdf(dist: EnvMapDistribution, wi: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of wi; the texel is binned by rounding u W so a
    sample and its pdf always name the same texel."""
    h, w = dist.pdf_texture.shape
    uv = equirect_uv(wi)
    ix = torch.remainder(torch.round(uv[..., 0] * w).to(torch.int64), w)
    iy = torch.clamp(torch.round(uv[..., 1] * h).to(torch.int64), 0, h - 1)
    p = dist.pdf_texture[iy, ix]
    sin_theta = torch.sin(PI * uv[..., 1])
    return torch.where(
        sin_theta > 0.0,
        p * (w * h) / (2.0 * PI * PI * torch.clamp(sin_theta, min=1e-20)),
        0.0,
    )


def _bilinear_coords(h: int, w: int, uv: torch.Tensor):
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    y0i = torch.remainder(y0.to(torch.int64), h)
    return x0i, y0i, fx, fy


def _blend(t00, t01, t10, t11, fx, fy):
    return (
        t00 * (1 - fx) * (1 - fy)
        + t01 * fx * (1 - fy)
        + t10 * (1 - fx) * fy
        + t11 * fx * fy
    )


def bilinear_wrap(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear, wrap-addressed fetch matching CUDA texture sampling
    (normalized coords, texel centers at (i + 0.5)/N)."""
    h, w = tex.shape[0], tex.shape[1]
    x0i, y0i, fx, fy = _bilinear_coords(h, w, uv)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.remainder(y0i + 1, h)
    return _blend(tex[y0i, x0i], tex[y0i, x1i], tex[y1i, x0i], tex[y1i, x1i],
                  fx, fy)


def radiance(tex: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """L(wi): equirect bilinear lookup."""
    return bilinear_wrap(tex, equirect_uv(wi))


def pack_bilinear(tex: torch.Tensor) -> torch.Tensor:
    """Quad-packed texture [H, W, 12]: each texel carries itself and its
    +x / +y / +x+y wrap neighbours, so a bilinear fetch is one row gather."""
    tx = torch.roll(tex, -1, dims=1)
    ty = torch.roll(tex, -1, dims=0)
    txy = torch.roll(tx, -1, dims=0)
    return torch.cat([tex, tx, ty, txy], dim=-1)


def radiance_packed(packed: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """Bilinear equirect fetch from a pack_bilinear table; numerically
    identical to radiance()."""
    h, w = packed.shape[0], packed.shape[1]
    x0i, y0i, fx, fy = _bilinear_coords(h, w, equirect_uv(wi))
    q = packed[y0i, x0i]
    return _blend(q[..., 0:3], q[..., 3:6], q[..., 6:9], q[..., 9:12], fx, fy)


def sample_color_mode(u: torch.Tensor) -> torch.Tensor:
    """Uniform-sphere direction for Color-mode env lights."""
    return sample_uniform_sphere(u)


def pdf_color_mode(wi: torch.Tensor) -> torch.Tensor:
    return torch.full(wi.shape[:-1], INV_4PI, dtype=wi.dtype, device=wi.device)
