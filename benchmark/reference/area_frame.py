"""The plain reference of path-traced frames lit by emitters (config2):
the radiance of chosen pixels, each of its own frame, summed over the
frame's samples, with the per-pixel random streams the renderer is
specified to draw (threefry keyed by pixel id, reference/rng.py).  Each
lane carries its frame's key, so the pixels of many frames are traced
together, in one pass per sample.

The estimator: the light table is [environment, area]: a constant-colour
environment and every emissive triangle of the scene as one area light.
Environment radiance on a primary miss and the material's emission on a
primary hit.  At hits 1..depth-1, next-event estimation combines one
light sample and one BRDF sample with the power heuristic:
  - the light is picked uniformly, id = min(floor(2 u0), 1), and the sum
    is scaled by 2 (the selection's compensation);
  - the environment: a uniform direction on the sphere from u[1:3], its
    colour, pdf 1 / (4 pi);
  - the area light reads u[1:4]: a triangle by searchsorted (right) of u1
    in the area-weighted CDF, a uniform point on it by the sqrt warp
    (b1 = 1 - sqrt(u2), b2 = u3 sqrt(u2)), one-sided emission (cos_l =
    max(n_face . -wi, 0) > 0, n_face the unit e1 x e2), solid-angle pdf
    dist^2 / (cos_l * total_area), zero where cos_l <= 1e-6;
  - the light sample's shadow ray starts at p + n SHADOW_OFFSET and is
    bounded toward the area sample: a blocker counts only at t <= dist
    (1 - 1e-3) - 2 SHADOW_OFFSET, so the emitter never occludes itself
    (unbounded, 1e32, toward the environment);
  - the BRDF sample (u[3] picks the GGX or the Lambert lobe, u[4:6] the
    direction) is traced to its closest hit from p + wb VIS_OFFSET: with
    the area light chosen it counts where it lands on an emitter's front
    face (the emitter's emission, the solid-angle pdf of the hit point),
    with the environment where it misses everything; each weighted by
    the power heuristic against the other strategy's pdf.
A 50/50 GGX / Lambert continuation from u[6:9] and Russian roulette from
bounce RR_START follow, as reference/frame.py's.  u[3] serves both the
area sample's third uniform and the BRDF lobe: the port reads it twice,
and the reference does too (ROADMAP, reference-side finding 4); it is a
correlation of two unbiased estimators, not a departure.

The one input taken from the program is the order of the emitter
triangles: the program lists them in its BVH's leaf order, which decides
which triangle a uniform selects, and the reference cannot work that
order out without the program's BVH.  The driver reads it from the built
scene (harness/area_scene.emitter_order); reference/area_scene.build
checks that it is a permutation of the description's emitters and
computes the areas, the CDF, the points and the pdfs itself.

Departures from the port: intersection is brute force over every
triangle of each object whose padded box the ray enters
(reference/core.py), ties to the lowest description index where the
port's traversal ties in its leaf order; a ray that grazes the edge two
triangles share can take the other triangle, with the same point and
nearly the same normal.  Sampled directions, pdfs and MIS weights are
not differentiated (the cell renders forward only).  Everything is
float32 with TF32 off.
"""

from __future__ import annotations

import torch

from benchmark.reference import core, rng
from benchmark.reference.frame import EXT_OFFSET, RR_MIN_Q, RR_START, SHADOW_OFFSET, VIS_OFFSET

INV_4PI = 1.0 / (4.0 * core.PI)
N_LIGHTS = 2        # [environment, area]
AREA_ID = 1
SHADOW_SHRINK = 1.0 - 1e-3   # the bounded shadow ray stops short of the light point
T_UNBOUNDED = 1e32


def uniform_sphere(u):
    """A uniform direction on the sphere from u [..., 2]."""
    y = 1.0 - 2.0 * u[..., 0]
    sin_theta = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    phi = core.TWO_PI * u[..., 1]
    return torch.stack([sin_theta * torch.cos(phi), y, sin_theta * torch.sin(phi)], dim=-1)


def sample_area(scene, pos, u3):
    """A point on the area light toward each shading point: (wi, dist, li,
    pdf_sa) [R, 3], [R], [R, 3], [R]."""
    tris = scene.base.tris
    e = torch.clamp((scene.emit_cdf <= u3[..., 0][..., None]).sum(dim=-1), 0,
                    scene.emit_tri.shape[0] - 1)
    tid = scene.emit_tri[e]
    su = torch.sqrt(torch.clamp(u3[..., 1], min=0.0))
    ub = 1.0 - su
    vb = u3[..., 2] * su
    p = tris.v0[tid] + ub[..., None] * tris.e1[tid] + vb[..., None] * tris.e2[tid]
    delta = p - pos
    dist2 = torch.clamp(core.dot(delta, delta), min=1e-12)
    dist = torch.sqrt(dist2)
    wi = delta / dist[..., None]
    cos_l = torch.clamp(core.dot(scene.face_normal[tid], -wi), min=0.0)
    li = torch.where((cos_l > 0.0)[..., None], scene.emission_of[tid], 0.0)
    pdf = torch.where(cos_l > 1e-6,
                      dist2 / torch.clamp(cos_l * scene.total_area, min=1e-12), 0.0)
    return wi, dist, li, pdf


def area_hit(scene, hit: core.Hit, ray_o):
    """The area light seen by a BRDF ray's closest hit: (li, pdf_sa,
    on_light), the pdf in sample_area's measure."""
    tid = torch.clamp(hit.tri, min=0)
    d = hit.position - ray_o
    dist2 = torch.clamp(core.dot(d, d), min=1e-12)
    wi = d / torch.sqrt(dist2)[..., None]
    cos_l = torch.clamp(core.dot(scene.face_normal[tid], -wi), min=0.0)
    on_light = hit.hit & scene.is_emissive[tid] & (cos_l > 1e-6)
    li = torch.where(on_light[..., None], scene.emission_of[tid], 0.0)
    pdf = torch.where(on_light, dist2 / torch.clamp(cos_l * scene.total_area, min=1e-12), 0.0)
    return li, pdf, on_light


def fold_lanes(keys, data):
    """jax.random.fold_in per lane: keys [R, 2] (reference/rng.py's words),
    data an int or an [R] integer tensor -> [R, 2]."""
    data = data.to(torch.int64) if isinstance(data, torch.Tensor) else int(data)
    y1, y2 = rng.threefry2x32(keys[:, 0], keys[:, 1], 0, data & rng.MASK)
    return torch.stack([y1, y2], dim=-1)


def lane_uniforms(keys, pid, n: int):
    """rng.pixel_uniforms with a key per lane: `n` uniforms in [0, 1) per
    lane, keyed by the lane's key and pixel id."""
    k = fold_lanes(keys, pid)
    lo = torch.arange(n, dtype=torch.int64, device=pid.device)
    b1, b2 = rng.threefry2x32(k[:, 0:1], k[:, 1:2], torch.zeros_like(lo), lo)
    return rng._bits_to_unit(b1 ^ b2)


def trace(scene, ray_o, ray_d, keys, pid, depth: int):
    """One sample of radiance per ray [R, 3]; keys [R, 2] the sample's key
    of each lane."""
    tris = scene.base.tris
    r = ray_o.shape[0]
    env = scene.env.expand(r, 3)
    l_out = torch.zeros((r, 3), dtype=torch.float32, device=ray_o.device)
    beta = torch.ones((r, 3), dtype=torch.float32, device=ray_o.device)
    isect = core.intersect(tris, ray_o, ray_d)
    l_out = l_out + torch.where(isect.hit[..., None], 0.0, env)
    l_out = l_out + torch.where(isect.hit[..., None], scene.mat_emission[isect.material], 0.0)
    alive = isect.hit
    wo = -ray_d
    for bounce in range(1, depth):
        u = lane_uniforms(fold_lanes(keys, bounce), pid, 10)
        pos = isect.position
        n = isect.normal
        mat = scene.base.material(isect.material)

        l_id = torch.clamp((u[:, 0] * N_LIGHTS).to(torch.int64), max=N_LIGHTS - 1)
        is_area = l_id == AREA_ID
        wl_a, dist_a, li_a, pdf_a = sample_area(scene, pos, u[:, 1:4])
        wl = torch.where(is_area[..., None], wl_a, uniform_sphere(u[:, 1:3]))
        li_light = torch.where(is_area[..., None], li_a, env)
        pdf_light = torch.where(is_area, pdf_a, torch.full_like(pdf_a, INV_4PI))
        t_max = torch.where(is_area, dist_a * SHADOW_SHRINK - 2.0 * SHADOW_OFFSET,
                            torch.full_like(dist_a, T_UNBOUNDED))
        shadow_o = pos + n * SHADOW_OFFSET
        f_light = core.mixture_f(mat, n, wl, wo)
        pdf_brdf_at_wl = core.mixture_pdf(mat, n, wl, wo)
        sh_mask = alive & (pdf_light > 0.0) & (f_light != 0.0).any(dim=-1)

        wb = core.mixture_sample(mat, n, wo, u[:, 3], u[:, 4:6])
        vis_o = pos + wb * VIS_OFFSET
        f_at_wb = core.mixture_f(mat, n, wb, wo)
        pdf_at_wb = core.mixture_pdf(mat, n, wb, wo)
        visible = ~core.occluded(tris, shadow_o, wl, sh_mask, t_max) & alive
        hit_b = core.intersect(tris, vis_o, wb, alive)
        li_hit, pdf_hit, on_light = area_hit(scene, hit_b, vis_o)
        vis2 = torch.where(is_area, on_light, ~hit_b.hit) & alive
        li_brdf = torch.where(vis2[..., None],
                              torch.where(is_area[..., None], li_hit, env), 0.0)
        f_brdf = torch.where(vis2[..., None], f_at_wb, 0.0)
        pdf_brdf = torch.where(vis2, pdf_at_wb, 1.0)
        pdf_light_at_wb = torch.where(vis2, torch.where(is_area, pdf_hit, INV_4PI), 1.0)

        w1 = core.power_heuristic(pdf_light, pdf_brdf_at_wl)
        w2 = core.power_heuristic(pdf_brdf, pdf_light_at_wb)
        ld = torch.where(
            (visible & (pdf_light > 0.0) & (w1 > 0.0))[..., None],
            f_light * li_light * (w1 / torch.clamp(pdf_light, min=1e-20))[..., None], 0.0)
        ld = ld + torch.where(
            (vis2 & (pdf_brdf > 0.0) & (w2 > 0.0))[..., None],
            f_brdf * li_brdf * (w2 / torch.clamp(pdf_brdf, min=1e-20))[..., None], 0.0)
        ld = ld * float(N_LIGHTS)
        l_out = l_out + torch.where(alive[..., None], beta * ld, 0.0)

        ws = core.mixture_sample(mat, n, wo, u[:, 6], u[:, 7:9])
        pdf_s = core.mixture_pdf(mat, n, ws, wo)
        f_s = core.mixture_f(mat, n, ws, wo)
        cont_ok = (pdf_s > 0.0) & (f_s != 0.0).any(dim=-1)
        beta = torch.where(alive[..., None],
                           beta * f_s / torch.clamp(pdf_s, min=1e-20)[..., None], beta)
        alive = alive & cont_ok
        if bounce >= RR_START:
            q = torch.clamp(1.0 - beta[:, 1], min=RR_MIN_Q)
            alive = alive & ~(u[:, 9] < q)
            beta = beta / torch.clamp(1.0 - q, min=RR_MIN_Q)[..., None]
        if bounce < depth - 1:
            ray_d = ws
            wo = -ray_d
            isect = core.intersect(tris, pos + n * EXT_OFFSET, ray_d, alive)
            alive = alive & isect.hit
    return l_out


def radiance_sum(scene, cam: core.Camera, px, py, keys, spp: int, depth: int):
    """Radiance of pixels (px, py) [R] (f32 coordinates) summed over `spp`
    samples, keys [R, 2] each lane's frame key, sample s keyed by
    fold_in(key, s): [R, 3]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pid = (py * cam.width + px).to(torch.int32)
    ro, rd = core.camera_rays(cam, px, py)
    acc = torch.zeros((px.shape[0], 3), dtype=torch.float32, device=px.device)
    for s in range(spp):
        acc = acc + trace(scene, ro, rd, fold_lanes(keys, s), pid, depth)
    return acc
