"""The plain reference of the shaded preview: one closest hit per pixel
through its centre, direct light from each directional light with one
shadow ray, and image-based ambient light from the environment: the
diffuse term is the cosine convolution of a 16 x 32 downsample, the
specular term a cosine-power lobe (s = 2 / alpha^2 - 2, alpha = r^2,
1 <= s <= 2,048) over a 32 x 64 downsample, blended toward the exact
lookup below roughness 0.15, times the split-sum fit of Karis / Lazarov.
Misses show the environment.  The downsample is PyTorch's antialiased
bilinear resize; the products are float32 matmuls (TF32 off).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import core

SHADOW_OFFSET = 0.01
IRR = (16, 32)
SPEC = (32, 64)


def _ipow(x, n: int):
    acc = None
    while True:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if not n:
            return acc
        x = x * x


def _resize(tex, h: int, w: int):
    y = F.interpolate(tex.permute(2, 0, 1)[None], size=(h, w), mode="bilinear",
                      align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0)


def _basis(h: int, w: int, device):
    v = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    u = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    uv = torch.stack(torch.meshgrid(u, v, indexing="xy"), dim=-1)
    dirs = core.equirect_dir(uv.reshape(-1, 2))
    sin_t = torch.sin(core.PI * uv[..., 1]).reshape(-1)
    return dirs, sin_t * (core.PI / h) * (2.0 * core.PI / w)


def _specular(tex, refl, roughness):
    small = _resize(tex, *SPEC)
    dirs, d_omega = _basis(*SPEC, refl.device)
    alpha2 = _ipow(torch.clamp(roughness, min=0.04), 4)
    s = torch.clamp(2.0 / alpha2 - 2.0, 1.0, 2048.0)[:, None]
    w = torch.clamp(refl @ dirs.T, min=1e-6) ** s
    filtered = (w @ (small.reshape(-1, 3) * d_omega[:, None])) / ((w @ d_omega[:, None]) + 1e-20)
    exact = core.env_radiance(tex, refl)
    mirror = torch.clamp(roughness / 0.15, 0.0, 1.0)[:, None]
    return filtered * mirror + exact * (1.0 - mirror)


def _irradiance(tex, n):
    small = _resize(tex, *IRR)
    dirs, d_omega = _basis(*IRR, n.device)
    cos = torch.clamp(n @ dirs.T, min=0.0)
    return (cos @ (small.reshape(-1, 3) * d_omega[:, None])) / core.PI


def _env_brdf_ab(n_dot_v, roughness):
    rx = roughness * -1.0 + 1.0
    ry = roughness * -0.0275 + 0.0425
    rz = roughness * -0.572 + 1.04
    rw = roughness * 0.022 - 0.04
    a004 = torch.minimum(rx * rx, torch.exp2(-9.28 * n_dot_v)) * rx + ry
    return a004 * -1.04 + rz, a004 * 1.04 + rw


def shaded(scene, cam: core.Camera, px, py):
    """The shaded preview's radiance at pixels (px, py) [R], [R, 3]."""
    ro, rd = core.camera_rays(cam, px, py)
    hit = core.intersect(scene.tris, ro, rd)
    mat = scene.material(hit.material)
    n, wo = hit.normal, -rd
    direct = torch.zeros_like(ro)
    shadow_o = hit.position + n * SHADOW_OFFSET
    for i in range(scene.dir_dir.shape[0]):
        wl = scene.dir_dir[i].expand(n.shape)
        f = core.mixture_f(mat, n, wl, wo)
        vis = ~core.occluded(scene.tris, shadow_o, wl, hit.hit)
        direct = direct + torch.where(vis[..., None], f * (scene.dir_color[i] * scene.dir_ls[i]),
                                      0.0)
    n_dot_v = torch.clamp(torch.sum(n * wo, dim=-1), min=0.0)
    f0 = mat.f0
    f_rough = f0 + (torch.maximum(1.0 - mat.roughness[..., None], f0) - f0) * _ipow(
        1.0 - n_dot_v[..., None], 5)
    k_d = (1.0 - f_rough) * (1.0 - mat.metallic[..., None])
    refl = 2.0 * n_dot_v[..., None] * n - wo
    refl = refl / torch.clamp(torch.sqrt(torch.sum(refl * refl, dim=-1, keepdim=True)), min=1e-8)
    pre = _specular(scene.env_tex, refl, mat.roughness)
    ab_a, ab_b = _env_brdf_ab(n_dot_v, mat.roughness)
    spec = pre * (f0 * ab_a[..., None] + ab_b[..., None])
    ambient = k_d * _irradiance(scene.env_tex, n) * mat.albedo + spec
    bg = core.env_radiance(scene.env_tex, rd)
    return torch.where(hit.hit[..., None], direct + ambient, bg)
