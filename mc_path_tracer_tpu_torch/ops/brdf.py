"""Cook-Torrance GGX specular + Lambertian diffuse BRDF (port of
mc_path_tracer_tpu/ops/brdf.py; the reference's dMaterial.cu formulas).

  - fresnel_schlick(f0, v, h) with dot(v, h) clamped at 0.
  - GGX Trowbridge-Reitz NDF with alpha = roughness^2.
  - Smith G as the product of Schlick-GGX G1 terms with k = alpha/2.
  - Diffuse direction sampling is uniform hemisphere (pdf 1/(2 pi)).
  - Diffuse f = kD * albedo * max(n.wi, eps)/pi, kD = (1 - F)(1 - metallic).
  - Specular half-vector sampling with a2 = roughness^4, wi = reflect(-wo, wh).
  - 50/50 lobe mixture with pdf 0.5 (pdf_diff + pdf_spec) and f = spec + diff.

Every function is a plain torch function of the material parameters, so
autograd reaches them; directions are unit world-space vectors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mc_path_tracer_tpu_torch.ops.math import (
    INV_2PI,
    INV_PI,
    PI,
    TWO_PI,
    dot,
    frame_to_world,
    normalize,
    reflect,
)

EPS = 1e-6


class MaterialParams(NamedTuple):
    """Per-ray (gathered) material parameters."""

    albedo: torch.Tensor     # [..., 3]
    roughness: torch.Tensor  # [...]
    metallic: torch.Tensor   # [...]
    fresnel: torch.Tensor    # [..., 3] F0 for dielectrics (reference: 0.04)

    @property
    def f0(self) -> torch.Tensor:
        """mix(fresnel, albedo, metallic)."""
        m = self.metallic[..., None]
        return self.fresnel * (1.0 - m) + self.albedo * m


def fresnel_schlick(f0: torch.Tensor, v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    v_dot_h = torch.clamp(dot(v, h), min=0.0)
    return f0 + (1.0 - f0) * torch.pow(1.0 - v_dot_h, 5.0)[..., None]


def ndf_ggx_tr(n: torch.Tensor, h: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    a = roughness * roughness
    a2 = a * a
    n_dot_h = torch.clamp(dot(n, h), min=EPS)
    denom = torch.clamp(n_dot_h * n_dot_h * (a2 - 1.0) + 1.0, min=EPS)
    return a2 / (PI * denom * denom)


def g1_schlick_ggx(v: torch.Tensor, n: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    a = roughness * roughness
    k = a / 2.0
    n_dot_v = torch.clamp(dot(n, v), min=EPS)
    return n_dot_v / torch.clamp(n_dot_v * (1.0 - k) + k, min=EPS)


def geo_atten_schlick_ggx(wi, wo, n, roughness) -> torch.Tensor:
    return g1_schlick_ggx(wi, n, roughness) * g1_schlick_ggx(wo, n, roughness)


# ---------------------------------------------------------------------------
# Diffuse lobe
# ---------------------------------------------------------------------------


def diff_sample_wi(n: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Uniform-hemisphere diffuse direction around shading normal n."""
    e0, e1 = u[..., 0], u[..., 1]
    sin_theta = torch.sqrt(torch.clamp(1.0 - e0 * e0, min=0.0))
    phi = TWO_PI * e1
    local = torch.stack(
        [sin_theta * torch.cos(phi), e0, sin_theta * torch.sin(phi)], dim=-1
    )
    return frame_to_world(local, n)


def diff_pdf(n: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """Constant 1/(2 pi)."""
    return torch.full(wi.shape[:-1], INV_2PI, dtype=wi.dtype, device=wi.device)


def diff_f(mat: MaterialParams, n, wi, wo) -> torch.Tensor:
    n_dot_wi = torch.clamp(dot(n, wi), min=EPS)
    wh = normalize(wo + wi)
    f = fresnel_schlick(mat.f0, wh, wo)
    kd = (1.0 - f) * (1.0 - mat.metallic[..., None])
    return kd * mat.albedo * (n_dot_wi * INV_PI)[..., None]


# ---------------------------------------------------------------------------
# Specular lobe
# ---------------------------------------------------------------------------


def spec_sample_wi(mat: MaterialParams, n, wo, u) -> torch.Tensor:
    """GGX NDF-importance-sampled half vector, reflected."""
    r = mat.roughness
    a2 = r * r * r * r
    e0, e1 = u[..., 0], u[..., 1]
    cos_theta = torch.sqrt(
        torch.clamp((1.0 - e0) / torch.clamp(e0 * (a2 - 1.0) + 1.0, min=EPS), 0.0, 1.0)
    )
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = TWO_PI * e1
    local_h = torch.stack(
        [sin_theta * torch.cos(phi), cos_theta, sin_theta * torch.sin(phi)], dim=-1
    )
    wh = frame_to_world(local_h, n)
    return normalize(reflect(-wo, wh))


def spec_pdf(mat: MaterialParams, n, wi, wo) -> torch.Tensor:
    wh = normalize(wo + wi)
    wh_dot_n = torch.clamp(dot(wh, n), min=EPS)
    wo_dot_wh = torch.clamp(dot(wo, wh), min=EPS)
    d = ndf_ggx_tr(n, wh, mat.roughness)
    return d * wh_dot_n / torch.clamp(4.0 * wo_dot_wh, min=EPS)


def spec_f(mat: MaterialParams, n, wi, wo) -> torch.Tensor:
    wh = normalize(wo + wi)
    n_dot_wi = torch.clamp(dot(n, wi), min=EPS)
    n_dot_wo = torch.clamp(dot(n, wo), min=EPS)
    d = ndf_ggx_tr(n, wh, mat.roughness)
    g = geo_atten_schlick_ggx(wi, wo, n, mat.roughness)
    f = fresnel_schlick(mat.f0, wh, wo)
    return f * (
        d * g * n_dot_wi / torch.clamp(4.0 * n_dot_wo * n_dot_wi, min=EPS)
    )[..., None]


# ---------------------------------------------------------------------------
# 50/50 lobe mixture used by the wavefront material stage
# ---------------------------------------------------------------------------


def mixture_sample_wi(mat: MaterialParams, n, wo, u_coin, u2) -> torch.Tensor:
    """Specular when u_coin < 0.5, else diffuse."""
    wi_s = spec_sample_wi(mat, n, wo, u2)
    wi_d = diff_sample_wi(n, u2)
    return torch.where((u_coin < 0.5)[..., None], wi_s, wi_d)


def mixture_pdf(mat: MaterialParams, n, wi, wo) -> torch.Tensor:
    return 0.5 * (diff_pdf(n, wi, wo) + spec_pdf(mat, n, wi, wo))


def mixture_f(mat: MaterialParams, n, wi, wo) -> torch.Tensor:
    """f = spec_f + diff_f."""
    return spec_f(mat, n, wi, wo) + diff_f(mat, n, wi, wo)
