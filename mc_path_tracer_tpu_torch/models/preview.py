"""Preview renderer: a deterministic single-bounce ray cast standing in for
the reference's deferred-PBR rasterizer, and the single-bounce debug
visualizer (port of mc_path_tracer_tpu/models/preview.py).

  - IBL ambient: the cosine (irradiance) convolution of the environment,
    evaluated per shading normal as one relu-matmul pair over a 16x32
    downsampled environment grid, and a split-sum specular term whose
    prefilter is a cosine-power lobe over a 32x64 grid.
  - shadows: one any-hit shadow ray per directional light.
  - wireframe: barycentric edge distance on hit pixels and a perspective
    ground grid on miss pixels.
  - debug: direct light from one light sample with one shadow tap on hits,
    the environment's sampling pdf as a heat map on misses.

Output modes mirror the G-buffer debug menu: PREVIEW_MODES.

Primary rays and shadow taps go through the integrator's `_intersect` /
`_occluded` on the route `resolve_accel` picks (on the card: the dense
kernel up to DENSE_ACCEL_MAX_TRIS triangles, the traversal kernel above).
The frame runs in PIXEL_CHUNK-pixel chunks in row-major order, so the
[R, T] products of the IBL terms stay bounded by the chunk (65,536 x 2,048
floats, 0.5 GB) at any frame size; `depth` is normalised by the whole
frame's largest t after the last chunk.  The IBL products are plain
`torch.matmul`, as the JAX package computes them outside any kernel: keep
TF32 off on the card (`cos ** s` with s up to 2,048 multiplies any relative
error of `cos` by s).  Every hit is detached; the preview has no gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE
from mc_path_tracer_tpu_torch.models import camera as camera_mod
from mc_path_tracer_tpu_torch.models import lights as lights_mod
from mc_path_tracer_tpu_torch.models.film import Film
from mc_path_tracer_tpu_torch.models.integrator import (
    PIXEL_CHUNK,
    SHADOW_OFFSET,
    _intersect,
    _occluded,
    built_scene,
    camera_params,
    resolve_accel,
)
from mc_path_tracer_tpu_torch.models.scene import SceneData
from mc_path_tracer_tpu_torch.ops import brdf, envmap, rng
from mc_path_tracer_tpu_torch.ops.intersect import winner_uvt
from mc_path_tracer_tpu_torch.ops.math import PI, equirect_dir

PREVIEW_MODES = (
    "shaded",
    "position",
    "normal",
    "albedo",
    "metallic_roughness",
    "emissive",
    "depth",
    "wireframe",
)

# irradiance convolution source resolution: 16x32 equirect (512 texels)
_IRR_H, _IRR_W = 16, 32
# specular prefilter source resolution: finer, so low-roughness lobes keep
# some sharpness (2,048 texels)
_SPEC_H, _SPEC_W = 32, 64


def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n for a positive int n by binary exponentiation: the products
    the JAX package's `x ** n` of a Python int makes (lax.integer_pow), so
    both round alike."""
    acc = None
    while True:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if not n:
            return acc
        x = x * x


def _resize(tex: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[H, W, 3] -> [h, w, 3] with jax.image.resize's "linear" weights:
    triangle filter at half-pixel centres, widened by the scale when
    downsampling (PyTorch's antialiased bilinear; without antialias a
    downsample skips texels)."""
    x = tex.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0)


def _env_basis(h: int, w: int, device):
    """Directions [T, 3] and solid-angle weights [T] of an h x w equirect
    texel grid."""
    v = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    u = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    uv = torch.stack(torch.meshgrid(u, v, indexing="xy"), dim=-1)  # [h, w, 2]
    dirs = equirect_dir(uv.reshape(-1, 2))
    sin_t = torch.sin(PI * uv[..., 1]).reshape(-1)
    d_omega = sin_t * (PI / h) * (2.0 * PI / w)
    return dirs, d_omega


def _prefiltered_spec(env: lights_mod.EnvLight, refl: torch.Tensor,
                      roughness: torch.Tensor) -> torch.Tensor:
    """Prefiltered environment radiance along the reflection vector: a
    cosine-power lobe w = max(R.w_t, 0)^s, s = 2/alpha^2 - 2 (alpha = r^2),
    over the downsampled grid, normalised by its own integral,
        spec(R) = (w @ L dOmega) / (w @ dOmega);
    below roughness 0.15 it blends toward the exact equirect lookup."""
    if not lights_mod.env_is_hdri(env):
        return (env.color * env.ls).expand(refl.shape)
    tex = _resize(env.tex, _SPEC_H, _SPEC_W)
    dirs, d_omega = _env_basis(_SPEC_H, _SPEC_W, refl.device)
    alpha2 = _ipow(torch.clamp(roughness, min=0.04), 4)
    s = torch.clamp(2.0 / alpha2 - 2.0, 1.0, 2048.0)[:, None]         # [R, 1]
    cos = torch.clamp(refl @ dirs.T, min=1e-6)                          # [R, T]
    w = cos ** s
    num = w @ (tex.reshape(-1, 3) * d_omega[:, None])                   # [R, 3]
    den = (w @ d_omega[:, None]) + 1e-20                                # [R, 1]
    filtered = num / den
    exact = envmap.radiance(env.tex, refl)
    mirror = torch.clamp(roughness / 0.15, 0.0, 1.0)[:, None]
    return filtered * mirror + exact * (1.0 - mirror)


def _env_brdf_ab(n_dot_v: torch.Tensor, roughness: torch.Tensor):
    """Split-sum BRDF, the analytic fit of Karis / Lazarov: (A, B) with
    specular = prefiltered * (F0 * A + B)."""
    rx = roughness * -1.0 + 1.0
    ry = roughness * -0.0275 + 0.0425
    rz = roughness * -0.572 + 1.04
    rw = roughness * 0.022 - 0.04
    a004 = torch.minimum(rx * rx, torch.exp2(-9.28 * n_dot_v)) * rx + ry
    return a004 * -1.04 + rz, a004 * 1.04 + rw


def _irradiance(env: lights_mod.EnvLight, n: torch.Tensor) -> torch.Tensor:
    """Diffuse IBL term E(n)/pi per shading normal, E(n) = sum_t L_t
    max(0, n . w_t) dOmega_t over the downsampled grid; a colour
    environment gives its constant radiance."""
    if not lights_mod.env_is_hdri(env):
        return (env.color * env.ls).expand(n.shape)
    tex = _resize(env.tex, _IRR_H, _IRR_W)
    dirs, d_omega = _env_basis(_IRR_H, _IRR_W, n.device)
    cos = torch.clamp(n @ dirs.T, min=0.0)                    # [R, T]
    e = cos @ (tex.reshape(-1, 3) * d_omega[:, None])         # [R, 3]
    return e / PI


def _ground_grid(ro, rd, hit_mask):
    """Perspective unit grid on y = 0 for miss pixels: anti-aliased lines
    widened with distance, faded with distance."""
    t = -ro[..., 1] / torch.where(rd[..., 1].abs() > 1e-6, rd[..., 1], 1e-6)
    ok = (t > 0.0) & ~hit_mask
    p = ro + t[..., None] * rd
    # torch.round rounds half to even, as jnp.round does
    fx = (p[..., 0] - torch.round(p[..., 0])).abs()
    fz = (p[..., 2] - torch.round(p[..., 2])).abs()
    width = torch.clamp(0.01 * torch.clamp(t, min=1.0), 0.01, 0.5)
    line = torch.maximum(
        torch.clamp(1.0 - fx / width, 0.0, 1.0),
        torch.clamp(1.0 - fz / width, 0.0, 1.0),
    )
    fade = torch.exp(-0.02 * torch.clamp(t, min=0.0))
    return torch.where(ok, line * fade * 0.6, 0.0)


def _rgb(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def _preview_chunk(scene: SceneData, route: str, ro, rd, mode: str) -> torch.Tensor:
    """One chunk of the preview, [R, 3]; for "depth" the unnormalised t of
    hit lanes (0 on misses) in every channel."""
    hit = _intersect(scene, route, ro, rd)
    atlas = scene.atlas
    mat = scene.materials.gather(hit.material_id, hit.uv, atlas)
    hmask = hit.hit[..., None]

    if mode == "position":
        return torch.where(hmask, hit.position, 0.0)
    if mode == "normal":
        return torch.where(hmask, hit.normal * 0.5 + 0.5, 0.0)
    if mode == "albedo":
        return torch.where(hmask, mat.albedo, 0.0)
    if mode == "metallic_roughness":
        mra = torch.stack([mat.metallic, mat.roughness, torch.ones_like(mat.metallic)], dim=-1)
        return torch.where(hmask, mra, 0.0)
    if mode == "emissive":
        return torch.where(hmask, scene.materials.emission(hit.material_id, hit.uv, atlas), 0.0)
    if mode == "depth":
        return torch.where(hit.hit, hit.t, 0.0)[..., None].expand(-1, 3)
    if mode == "wireframe":
        # barycentric edge distance: recover (u, v) of the winner, line where
        # min(u, v, 1 - u - v) ~ 0
        u, v, _ = winner_uvt(scene.tris, hit.tri_id, ro, rd)
        u = torch.where(hit.hit, u, 0.0)
        v = torch.where(hit.hit, v, 0.0)
        edge = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
        aa = 0.03
        line = torch.clamp(1.0 - edge / aa, 0.0, 1.0)
        base = torch.where(hmask, 0.12 + 0.25 * hit.normal.abs(), 0.0)
        out = torch.where(hmask, base + line[..., None] * _rgb([0.9, 0.9, 0.95], ro), 0.0)
        grid = _ground_grid(ro, rd, hit.hit)
        return out + grid[..., None] * _rgb([0.5, 0.5, 0.55], ro)

    # shaded
    wo = -rd
    n = scene.materials.perturb_normal(hit.material_id, hit.uv, atlas,
                                       hit.normal, hit.tangent, hit.bitangent)
    lights = scene.lights
    direct = torch.zeros_like(ro)
    shadow_o = hit.position + n * SHADOW_OFFSET
    for i in range(lights.directional.direction.shape[0]):
        wl = lights.directional.direction[i].expand(n.shape)
        li = lights.directional.color[i] * lights.directional.ls[i]
        f = brdf.mixture_f(mat, n, wl, wo)
        vis = ~_occluded(scene, route, shadow_o, wl, mask=hit.hit)
        direct = direct + torch.where(vis[..., None], f * li, 0.0)
    ao = scene.materials.ambient_occlusion(hit.material_id, hit.uv, atlas)
    # IBL ambient = kD * irradiance * albedo + split-sum specular, times AO
    n_dot_v = torch.clamp(torch.sum(n * wo, dim=-1), min=0.0)
    f0 = mat.f0
    f_rough = f0 + (torch.maximum(1.0 - mat.roughness[..., None], f0) - f0) * _ipow(
        1.0 - n_dot_v[..., None], 5)
    k_d = (1.0 - f_rough) * (1.0 - mat.metallic[..., None])
    refl = 2.0 * n_dot_v[..., None] * n - wo
    refl = refl / torch.clamp(torch.sqrt(torch.sum(refl * refl, dim=-1, keepdim=True)),
                              min=1e-8)
    pre = _prefiltered_spec(lights.env, refl, mat.roughness)
    ab_a, ab_b = _env_brdf_ab(n_dot_v, mat.roughness)
    spec = pre * (f0 * ab_a[..., None] + ab_b[..., None])
    ambient = (k_d * _irradiance(lights.env, n) * mat.albedo + spec) * ao[..., None]
    if lights_mod.env_is_hdri(lights.env):
        bg = envmap.radiance(lights.env.tex, rd)
    else:
        bg = (lights.env.color * lights.env.ls).expand(rd.shape)
    emissive = scene.materials.emission(hit.material_id, hit.uv, atlas)
    return torch.where(hmask, direct + ambient + emissive, bg)


def _debug_chunk(scene: SceneData, route: str, ro, rd, pid) -> torch.Tensor:
    """One chunk of the debug view, [R, 3]."""
    hit = _intersect(scene, route, ro, rd)
    mat = scene.materials.gather(hit.material_id, hit.uv, scene.atlas)
    lights = lights_mod.with_packed(scene.lights)
    n_l = lights_mod.num_lights(lights)

    # deterministic light sample per pixel (pixel-keyed stream, key 0)
    u = rng.pixel_uniforms(rng.prng_key(0), pid, 3)
    l_id = torch.clamp((u[:, 0] * n_l).to(torch.int64), max=n_l - 1)
    wl = lights_mod.sample_dir(lights, l_id, u[:, 1:3])
    li = lights_mod.radiance(lights, l_id, wl)
    pdf_l = lights_mod.pdf(lights, l_id, wl)
    f = brdf.mixture_f(mat, hit.normal, wl, -rd)
    vis = ~_occluded(scene, route, hit.position + hit.normal * SHADOW_OFFSET, wl,
                     mask=hit.hit)
    ld = torch.where(
        (vis & (pdf_l > 0))[..., None],
        f * li * float(n_l) / torch.clamp(pdf_l, min=1e-20)[..., None],
        0.0,
    )

    # miss pixels: env pdf heat map (blue -> red), normalised to the
    # uniform-sphere pdf so 1/4pi reads as mid-scale
    env_pdf = lights_mod.pdf(lights, torch.zeros_like(l_id), rd)
    rel = torch.log1p(env_pdf * 4.0 * PI) / torch.log(torch.tensor(16.0, device=rd.device))
    h01 = torch.clamp(rel, 0.0, 1.0)
    heat = torch.stack([h01, 0.25 * torch.sin(PI * h01) + 0.1 * h01, 1.0 - h01], dim=-1)
    return torch.where(hit.hit[..., None], ld, heat)


def preview_pixels(scene: SceneData, cam, width: int, height: int, px, py, mode: str,
                   accel: str = "auto") -> torch.Tensor:
    """The preview (`mode` in PREVIEW_MODES) or the debug view
    (mode="debug") of pixels (px, py) [R] (f32 coordinates): [R, 3], in
    PIXEL_CHUNK-pixel chunks.  `depth` is normalised by the largest t over
    these pixels.  `accel` picks the intersection route, as
    RenderConfig.accel does."""
    route = resolve_accel(scene.tris.num_triangles, px.device, accel)
    chunks = []
    for s0 in range(0, px.shape[0], PIXEL_CHUNK):
        px_c, py_c = px[s0 : s0 + PIXEL_CHUNK], py[s0 : s0 + PIXEL_CHUNK]
        ro, rd = camera_mod.gen_camera_rays(
            cam, width, height, px_c, py_c,
            torch.zeros((px_c.shape[0], 2), dtype=torch.float32, device=px.device))
        if mode == "debug":
            pid = (py_c * width + px_c).to(torch.int32)
            chunks.append(_debug_chunk(scene, route, ro, rd, pid))
        else:
            chunks.append(_preview_chunk(scene, route, ro, rd, mode))
    out = torch.cat(chunks, dim=0)
    if mode == "depth":
        out = out / torch.clamp(out.max(), min=1e-6)
    return out


def _frame(scene, camera, width: int, height: int, mode: str, device) -> Film:
    """The whole frame in row-major pixel order."""
    scene_data, device = built_scene(scene, device)
    cam = camera_params(camera, width, height, device)
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    px = xs.reshape(-1).to(torch.float32)
    py = ys.reshape(-1).to(torch.float32)
    img = preview_pixels(scene_data, cam, width, height, px, py, mode)
    return Film(ld=img.reshape(height, width, 3),
                samples=torch.ones((height, width), dtype=torch.float32, device=device))


def render_preview(scene, camera, width: int, height: int, mode: str = "shaded",
                   device=DEFAULT_DEVICE) -> Film:
    """Deterministic single-pass preview of `scene` (a Scene, built on
    `device`, or a SceneData) in one of PREVIEW_MODES."""
    if mode not in PREVIEW_MODES:
        raise ValueError(f"mode {mode!r} not in {PREVIEW_MODES}")
    return _frame(scene, camera, width, height, mode, device)


def render_debug(scene, camera, width: int, height: int, device=DEFAULT_DEVICE) -> Film:
    """The single-bounce debug visualizer (not the path tracer)."""
    return _frame(scene, camera, width, height, "debug", device)
