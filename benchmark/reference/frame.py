"""The plain reference of a path-traced frame: the radiance of chosen
pixels, summed over the frame's samples, with the same per-pixel random
streams the renderer is specified to draw (threefry keyed by pixel id).

The estimator: environment radiance on a primary miss; next-event
estimation at hits 1..depth-1 combining one light sample (uniform light
selection over [environment, directional lights...], the environment by
its CDF) and one BRDF sample with the power heuristic (delta lights at
full weight), one any-hit ray for each; a 50/50 GGX / Lambert
continuation; Russian roulette from bounce RR_START with
q = max(0.05, 1 - beta.y), survivors divided by 1 - q.  Sampled
directions, pdfs, MIS weights and hits are detached, so autograd reaches
the materials, light scales and environment texels through the shading
alone (reference/train.py differentiates it).
"""

from __future__ import annotations

import torch

from benchmark.reference import core, rng

SHADOW_OFFSET = 0.01
VIS_OFFSET = 0.001
EXT_OFFSET = 0.001
RR_START = 3
RR_MIN_Q = 0.05
LENS_STREAM = 1_000_007   # the pinhole camera draws this stream and ignores it


def _light_sample_dir(scene, l_id, u2):
    wi_env = core.env_sample(scene.env_dist, u2)
    d = scene.dir_dir.shape[0]
    if d == 0:
        return wi_env
    return torch.where((l_id == 0)[..., None], wi_env, scene.dir_dir[torch.clamp(l_id - 1, 0, d - 1)])


def _light_radiance(scene, l_id, wi):
    l_env = core.env_radiance(scene.env_tex, wi)
    d = scene.dir_dir.shape[0]
    if d == 0:
        return l_env
    k = torch.clamp(l_id - 1, 0, d - 1)
    return torch.where((l_id == 0)[..., None], l_env,
                       scene.dir_color[k] * scene.dir_ls[:, None][k])


def _light_pdf(scene, l_id, wi):
    p_env = core.env_pdf(scene.env_dist, wi)
    if scene.dir_dir.shape[0] == 0:
        return p_env
    return torch.where(l_id == 0, p_env, 1.0)


def trace(scene, ray_o, ray_d, key, pid, depth: int):
    """One sample of radiance per ray [R, 3]."""
    tris = scene.tris
    r = ray_o.shape[0]
    n_lights = 1 + scene.dir_dir.shape[0]
    l_out = torch.zeros((r, 3), dtype=torch.float32, device=ray_o.device)
    beta = torch.ones((r, 3), dtype=torch.float32, device=ray_o.device)
    isect = core.intersect(tris, ray_o, ray_d)
    bg = _light_radiance(scene, torch.zeros(r, dtype=torch.int64, device=ray_o.device), ray_d)
    l_out = l_out + torch.where(isect.hit[..., None], 0.0, bg)
    alive = isect.hit
    wo = -ray_d
    for bounce in range(1, depth):
        u = rng.pixel_uniforms(rng.fold_in(key, bounce), pid, 10).detach()
        pos = isect.position
        n = isect.normal
        mat = scene.material(isect.material)

        l_id = torch.clamp((u[:, 0] * n_lights).to(torch.int64), max=n_lights - 1)
        wl = _light_sample_dir(scene, l_id, u[:, 1:3]).detach()
        delta = l_id != 0
        li_light = _light_radiance(scene, l_id, wl)
        pdf_light = _light_pdf(scene, l_id, wl).detach()
        shadow_o = pos + n * SHADOW_OFFSET
        f_light = core.mixture_f(mat, n, wl, wo)
        pdf_brdf_at_wl = torch.where(delta, 1.0, core.mixture_pdf(mat, n, wl, wo)).detach()
        sh_mask = alive & (pdf_light > 0.0) & (f_light.detach() != 0.0).any(dim=-1)

        wb = core.mixture_sample(mat, n, wo, u[:, 3], u[:, 4:6]).detach()
        vis_o = pos + wb * VIS_OFFSET
        f_at_wb = core.mixture_f(mat, n, wb, wo)
        pdf_at_wb = core.mixture_pdf(mat, n, wb, wo).detach()
        occ = core.occluded(tris, torch.cat([shadow_o, vis_o]), torch.cat([wl, wb]),
                            torch.cat([sh_mask, alive & ~delta]))
        visible = ~occ[:r] & alive
        vis2 = ~occ[r:] & ~delta & alive
        li_brdf = torch.where(vis2[..., None], _light_radiance(scene, l_id, wb), 0.0)
        f_brdf = torch.where(vis2[..., None], f_at_wb, 0.0)
        pdf_brdf = torch.where(vis2, pdf_at_wb, 1.0).detach()
        pdf_light_at_wb = torch.where(vis2, _light_pdf(scene, l_id, wb), 1.0).detach()

        w1 = torch.where(delta, 1.0, core.power_heuristic(pdf_light, pdf_brdf_at_wl).detach())
        w2 = core.power_heuristic(pdf_brdf, pdf_light_at_wb).detach()
        ld = torch.where(
            (visible & (pdf_light > 0.0) & (w1 > 0.0))[..., None],
            f_light * li_light * (w1 / torch.clamp(pdf_light, min=1e-20))[..., None], 0.0)
        ld = ld + torch.where(
            (vis2 & (pdf_brdf > 0.0) & (w2 > 0.0))[..., None],
            f_brdf * li_brdf * (w2 / torch.clamp(pdf_brdf, min=1e-20))[..., None], 0.0)
        ld = ld * float(n_lights)
        l_out = l_out + torch.where(alive[..., None], beta * ld, 0.0)

        ws = core.mixture_sample(mat, n, wo, u[:, 6], u[:, 7:9]).detach()
        pdf_s = core.mixture_pdf(mat, n, ws, wo).detach()
        f_s = core.mixture_f(mat, n, ws, wo)
        cont_ok = (pdf_s > 0.0) & (f_s.detach() != 0.0).any(dim=-1)
        beta = torch.where(alive[..., None],
                           beta * f_s / torch.clamp(pdf_s, min=1e-20)[..., None], beta)
        alive = alive & cont_ok
        if bounce >= RR_START:
            q = torch.clamp(1.0 - beta[:, 1].detach(), min=RR_MIN_Q)
            alive = alive & ~(u[:, 9] < q)
            beta = beta / torch.clamp(1.0 - q.detach(), min=RR_MIN_Q)[..., None]
        if bounce < depth - 1:
            ray_d = ws
            wo = -ray_d
            isect = core.intersect(tris, pos + n * EXT_OFFSET, ray_d, alive)
            alive = alive & isect.hit
    return l_out


def radiance_sum(scene, cam: core.Camera, px, py, key, spp: int, depth: int):
    """Radiance of pixels (px, py) [R] (f32 coordinates) summed over `spp`
    samples, sample s keyed by fold_in(key, s): [R, 3]."""
    pid = (py * cam.width + px).to(torch.int32)
    ro, rd = core.camera_rays(cam, px, py)
    acc = torch.zeros((px.shape[0], 3), dtype=torch.float32, device=px.device)
    for s in range(spp):
        acc = acc + trace(scene, ro, rd, rng.fold_in(key, s), pid, depth)
    return acc


def reinhard_u8(ld, samples: float, exposure: float = 1.0):
    """The display pixels: c = ld / samples * exposure, c / (c + 1), 255 c
    truncated to uint8."""
    c = ld / max(samples, 1.0) * exposure
    return torch.clamp(c / (c + 1.0) * 255.0, 0.0, 255.0).to(torch.uint8)
