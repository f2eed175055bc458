"""Wavefront path-tracing integrator (port of
mc_path_tracer_tpu/models/integrator.py).

Each bounce is straight-line masked tensor code over the block's rays; dead
lanes are predicated off with `where`.  Per bounce the default two-sample
estimator makes one closest-hit dispatch (the extension ray) and one fused
any-hit dispatch of 2R rays (the light sample's shadow ray and the BRDF
sample's visibility ray).  With an area light it makes, per NEE bounce, one
R-lane bounded any-hit (the shadow ray, t_max short of the sampled light
point) and one R-lane closest hit (the BRDF ray: did it reach the emitter?)
instead of the fused 2R any-hit.  With `reuse_brdf_ray` one mixture sample
serves both the BRDF-sample estimator and the continuation, so the
extension hit answers the visibility query: one R-lane shadow any-hit and
one closest hit per bounce, and the last NEE bounce alone pays dedicated
visibility lanes.  Everything between the dispatches is plain PyTorch.

Routes (`resolve_accel`, a pure function of triangle count, device and
RenderConfig.accel): "auto" on a CUDA scene of at most
DENSE_ACCEL_MAX_TRIS triangles takes the dense kernel (csrc/dense.cu),
any larger one the traversal kernel (csrc/traversal.cu); "dense" forces
the dense kernel; "pallas", "wide" and "bvh", the JAX package's BVH
routes, all take the traversal kernel ("auto" and "pallas" over sorted
lanes, below); "brute" calls the plain brute-force version.  On CPU
tensors every kernel wrapper runs that plain version.

Estimator (the reference's wavefront kernels, as in the JAX package):
environment radiance on primary miss, emission on a primary hit of an
emissive triangle (scenes with an area light); next-event estimation at hits
1..max_depth-1 combining a light sample and a BRDF sample with the power
heuristic (delta lights take the light sample at full weight); 50/50
specular/diffuse continuation; Russian roulette from bounce `rr_start`
with q = max(0.05, 1 - beta.y) and survivors divided by 1 - q (under
`reuse_brdf_ray`, before the shared trace).  Materials are textured
through the scene's atlas (albedo, metallic-roughness, emission and
tangent-space normal maps).  `reference_quirks=True` reproduces the
reference's bugs (env added once per light, no selection compensation, no
RR reweight, halved delta lights) and ignores `reuse_brdf_ray`.  All
randomness is threefry keyed by pixel id (ops/rng.py), so a render matches
the JAX package's pixel by pixel.

`render` draws sample s of a frame with key fold_in(key, s);
`render_progressive` draws pass p's samples with fold_in(key, p) through
`_tile_pass`, one film snapshot per (pass, tile), as the JAX package does.
`render_tile_radiance` runs the pixels in blocks: PIXEL_CHUNK pixels
while autograd records a graph, FRAME_CHUNK pixels otherwise.  Either
block's (pixel, sample) pairs run in passes of at most FRAME_CHUNK
sample-major lanes (32 samples a pass of a 256 x 256 frame or of a 384 x
128 train step, 1 of a 1080p frame), each lane keyed by its pixel and
sample, so the radiance is the same under any cut.  A call derives every
sample's keys on the host once (`_key_words`) and sends them to the
device as one tensor of words; every pass, and every replay of a pass,
reads its samples' rows of it.

Gradients (detached sampling): sampled directions, pdfs, MIS weights and
intersections are detached (`stop_gradient` in the JAX package), so
autograd reaches the material factors, the light radiances and the
environment texels through the shading math only, and no kernel needs a
backward pass.  While grad mode is on and a tensor the sample reads
requires grad, `render_tile_radiance` replays each pass
(`torch.utils.checkpoint`, the JAX package's `jax.checkpoint` with
`nothing_saveable`): the forward keeps only each pass's inputs, and the
backward re-runs the pass, its k samples' every kernel dispatch included,
to rebuild its graph.  Randomness is threefry keyed by pixel id and the
kernels are deterministic, so the replay meets the hits of the forward.
A render of a scene that nothing differentiates runs as a plain forward.

`sort_rays` (default on, as in the JAX package) dispatches the traversal
kernel over lanes grouped by direction octant, dead lanes last
(traversal.sort_perm), on the routes where the JAX package sorts: the
traversal reached from accel "auto" or "pallas" (`dispatch_route`).  The
packed rays are gathered once in sorted order and the winners scattered
back to caller order; the sort is stable on integer keys, so a replayed
sample meets the forward's hits, and per-ray results never change.

The stages run in spans of utils/profiling, recorded only under a
profiler session: `mcpt::render` (its own time: the frame's set-up),
`mcpt::sample` per pass (ident: block, first sample, samples in the
pass), `mcpt::camera`, `mcpt::trace`, `mcpt::bounce` per bounce (its own
time: the shading glue), `mcpt::closest` / `mcpt::anyhit` per dispatch
and `mcpt::film`; with an area light, `mcpt::area.sample` (the light
sample on the emitters and its merge) and `mcpt::area.hit` (the BRDF
ray's emitter hit and its merge) inside each bounce, beside its
dispatches.  LAUNCHES["anyhit_bounded"]
counts the any-hit dispatches that carry a t_max.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mc_path_tracer_tpu_torch.models import camera as camera_mod
from mc_path_tracer_tpu_torch.models import lights as lights_mod
from mc_path_tracer_tpu_torch.models.film import Film, make_film, tile_grid, tile_order
from mc_path_tracer_tpu_torch.models.scene import SceneData
from mc_path_tracer_tpu_torch.ops import brdf, rng
from mc_path_tracer_tpu_torch.ops.intersect import (
    Hit,
    finish_closest,
    intersect_bvh,
    occluded_bvh,
    pack_rays,
)
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES, dense, traversal
from mc_path_tracer_tpu_torch.ops.sampling import power_heuristic
from mc_path_tracer_tpu_torch.utils.profiling import span, spanned

# reference constants (wavefront_kernels.cu)
SHADOW_OFFSET = 0.01
VIS_OFFSET = 0.001
EXT_OFFSET = 0.001
RR_START = 3
RR_MIN_Q = 0.05
DEFAULT_SPP = 250
DEFAULT_MAX_DEPTH = 5
PIXEL_CHUNK = 65536
# a forward-only render's block and its most lanes a pass: 32 PIXEL_CHUNK
# blocks, a whole 1080p frame
FRAME_CHUNK = 32 * PIXEL_CHUNK
# the folds of a sample's key that key its camera streams
JITTER_FOLD, LENS_FOLD = 1_000_003, 1_000_007
# scenes at or below this triangle count skip the BVH on the card: the dense
# kernel tests every triangle (the JAX package's _resolve_accel threshold)
DENSE_ACCEL_MAX_TRIS = 2048
ACCELS = ("auto", "pallas", "dense", "wide", "bvh", "brute")
# the JAX package's BVH routes: on the card all take the traversal kernel
BVH_ACCELS = ("pallas", "wide", "bvh")
# the accels whose traversal the JAX package dispatches over sorted lanes
# (its "pallas" route, which "auto" takes on the accelerator)
SORTED_ACCELS = ("auto", "pallas")


@dataclass(frozen=True)
class RenderConfig:
    """Integrator configuration: the JAX package's fields."""

    spp: int = DEFAULT_SPP
    max_depth: int = DEFAULT_MAX_DEPTH
    accel: str = "auto"            # one of ACCELS (resolve_accel)
    # JAX parity only, no effect: the JAX traversal unrolls this many leaf
    # slots, while the port's traversal reads each leaf's own triangle count
    # (the tree's leaf size is Scene.max_leaf)
    max_leaf: int = 4
    jitter: bool = False           # the reference shoots pixel centers only
    reference_quirks: bool = False
    rr_start: int = RR_START
    # octant-sorted, dead-last traversal dispatches (dispatch_route);
    # sorting permutes kernel lanes only, never the result
    sort_rays: bool = True
    # one mixture sample shared by the BRDF-sample estimator and the
    # continuation (about 1.45x per-sample variance on glossy surfaces in
    # the JAX package's measurement; ignored under reference_quirks)
    reuse_brdf_ray: bool = False
    mis_mode: str = "mis"          # "mis" | "light" | "brdf"
    env_importance: bool = True


def _check_supported(cfg: RenderConfig) -> None:
    if cfg.mis_mode not in ("mis", "light", "brdf"):
        raise ValueError(f"unknown mis_mode {cfg.mis_mode!r} "
                         "(expected 'mis', 'light' or 'brdf')")
    if cfg.accel not in ACCELS:
        raise ValueError(f"unknown accel {cfg.accel!r} (expected one of {ACCELS})")


def _detach(h: Hit) -> Hit:
    return Hit(*(x.detach() for x in h))


def resolve_accel(num_triangles: int, device, accel: str) -> str:
    """The intersection route: "bvh" (traversal kernel), "dense" (dense
    kernel) or "brute" (plain version).  "pallas", "wide" and "bvh" take
    the traversal; "auto" takes the dense kernel for CUDA scenes of at most
    DENSE_ACCEL_MAX_TRIS triangles, as the JAX package's _resolve_accel
    does on its accelerator, else the traversal."""
    if accel in ("dense", "brute"):
        return accel
    if accel in BVH_ACCELS:
        return "bvh"
    if accel != "auto":
        raise ValueError(f"unknown accel {accel!r}")
    on_card = torch.device(device).type == "cuda"
    return "dense" if on_card and num_triangles <= DENSE_ACCEL_MAX_TRIS else "bvh"


def dispatch_route(num_triangles: int, device, accel: str, sort_rays: bool) -> str:
    """resolve_accel's route, with the traversal ("bvh") taken over sorted
    lanes ("sorted") where the JAX package sorts: `sort_rays` on and accel
    "auto" or "pallas".  "wide" and "bvh" stay unsorted, as there."""
    route = resolve_accel(num_triangles, device, accel)
    return "sorted" if route == "bvh" and sort_rays and accel in SORTED_ACCELS else route


@spanned("mcpt::closest")
def _intersect(scene: SceneData, route: str, ro, rd, mask=None) -> Hit:
    if route in ("bvh", "sorted"):
        return _detach(intersect_bvh(scene.bvh, scene.tris, ro, rd, mask=mask,
                                     sort=route == "sorted"))
    plain = traversal.closest_plain if route == "brute" else dense.dense_closest
    _, tri_id = plain(pack_rays(ro, rd, mask), scene.tris.geo)
    return _detach(finish_closest(scene.tris, tri_id, ro, rd))


@spanned("mcpt::anyhit")
def _occluded(scene: SceneData, route: str, ro, rd, mask=None, t_max=None):
    if t_max is not None:
        LAUNCHES["anyhit_bounded"] += 1
    if route in ("bvh", "sorted"):
        return occluded_bvh(scene.bvh, scene.tris, ro, rd, mask=mask, t_max=t_max,
                            sort=route == "sorted")
    plain = traversal.anyhit_plain if route == "brute" else dense.dense_anyhit
    return plain(pack_rays(ro, rd, mask, t_max), scene.tris.geo)


@spanned("mcpt::trace")
def trace_radiance(scene: SceneData, ray_o, ray_d, key: torch.Tensor | None,
                   cfg: RenderConfig, pid=None, bounce_keys=None) -> torch.Tensor:
    """Path-trace one sample for each input ray; returns radiance [R, 3].
    `pid` keys each lane's random stream (pixel ids from the renderer);
    it defaults to the array position.  Bounce b of sample j draws with
    the words `bounce_keys[j, b - 1]` ([k, max_depth - 1, 2] on the
    lanes' device, rows of `_key_words`: fold_in(skey, b) of each sample
    key skey, k samples over sample-major lanes).  Without them, the one
    sample's key is `key`, whose bounce folds are made on the host and
    sent to the device once, at entry."""
    _check_supported(cfg)
    num_rays = ray_o.shape[0]
    if pid is None:
        pid = torch.arange(num_rays, dtype=torch.int32, device=ray_o.device)
    if bounce_keys is None:
        bounce_keys = torch.tensor(_folds(key, range(1, cfg.max_depth)), dtype=torch.int64,
                                   device=ray_o.device).view(1, cfg.max_depth - 1, 2)
    quirks = cfg.reference_quirks
    reuse = cfg.reuse_brdf_ray and not quirks
    route = dispatch_route(scene.tris.num_triangles, ray_o.device, cfg.accel, cfg.sort_rays)
    lights = lights_mod.with_packed(scene.lights)
    n_lights = lights_mod.num_lights(lights)
    aid = lights_mod.area_light_id(lights)  # -1 when there is no area light
    atlas = scene.atlas

    l_out = torch.zeros((num_rays, 3), dtype=torch.float32, device=ray_o.device)
    beta = torch.ones((num_rays, 3), dtype=torch.float32, device=ray_o.device)

    isect = _intersect(scene, route, ray_o, ray_d)

    # background on primary miss; quirk mode adds it once per light
    env_id = torch.zeros(num_rays, dtype=torch.int64, device=ray_o.device)
    bg = lights_mod.radiance(lights, env_id, ray_d)
    bg_scale = float(n_lights) if quirks else 1.0
    l_out = l_out + torch.where(isect.hit[..., None], 0.0, bg * bg_scale)
    # emitters seen directly by the camera
    if aid >= 0:
        prim_emit = scene.materials.emission(isect.material_id, isect.uv, atlas)
        l_out = l_out + torch.where(isect.hit[..., None], prim_emit, 0.0)

    alive = isect.hit
    wo = -ray_d

    # next-event estimation at hits 1..max_depth-1
    for bounce in range(1, cfg.max_depth):
        with span("mcpt::bounce"):
            u = rng.pixel_uniforms(bounce_keys[:, bounce - 1], pid, 10).detach()
            pos = isect.position
            mat = scene.materials.gather(isect.material_id, isect.uv, atlas)
            n = scene.materials.perturb_normal(isect.material_id, isect.uv, atlas,
                                               isect.normal, isect.tangent, isect.bitangent)

            # ---- light selection and the light-sample estimator ----
            l_id = torch.clamp((u[:, 0] * n_lights).to(torch.int64), max=n_lights - 1)
            wl = lights_mod.sample_dir(lights, l_id, u[:, 1:3],
                                       env_importance=cfg.env_importance).detach()
            delta = lights_mod.is_delta(lights, l_id)
            li_light = lights_mod.radiance(lights, l_id, wl)
            pdf_light = lights_mod.pdf(lights, l_id, wl,
                                       env_importance=cfg.env_importance).detach()
            shadow_tmax = None
            if aid >= 0:
                # the area sample reads u[:, 1:4]: its third uniform is u[:, 3],
                # which also picks the two-sample BRDF lobe below, as in the JAX
                # package (a correlation of two unbiased estimators, kept for
                # pixel parity)
                with span("mcpt::area.sample"):
                    is_area = l_id == aid
                    wl_a, dist_a, li_a, pdf_a = lights_mod.sample_area(
                        lights.area, scene.tris, pos, u[:, 1:4])
                    wl_a, dist_a, pdf_a = wl_a.detach(), dist_a.detach(), pdf_a.detach()
                    wl = torch.where(is_area[..., None], wl_a, wl)
                    li_light = torch.where(is_area[..., None], li_a, li_light)
                    pdf_light = torch.where(is_area, pdf_a, pdf_light)
                    # bounded shadow ray: blockers strictly between surface and
                    # light; the 2 * SHADOW_OFFSET margin covers the origin's
                    # offset so the emitter never occludes itself
                    shadow_tmax = torch.where(
                        is_area, dist_a * (1.0 - 1e-3) - 2.0 * SHADOW_OFFSET,
                        torch.full_like(dist_a, 1e32))
            shadow_o = pos + n * SHADOW_OFFSET
            f_light = brdf.mixture_f(mat, n, wl, wo)
            pdf_brdf_at_wl = torch.where(
                delta, 1.0, brdf.mixture_pdf(mat, n, wl, wo)).detach()
            # lanes whose light sample contributes nothing skip the shadow ray
            sh_mask = alive if quirks else (
                alive & (pdf_light > 0.0) & (f_light.detach() != 0.0).any(dim=-1)
            )

            # ---- brdf-sample estimator, non-delta lights ----
            # reuse: the continuation sample ws is the BRDF sample, traced from
            # the extension origin; its hit becomes the next isect unless this
            # is the last NEE bounce
            last = bounce == cfg.max_depth - 1
            shared = reuse and not last
            isect_next = None
            if reuse:
                wb = brdf.mixture_sample_wi(mat, n, wo, u[:, 6], u[:, 7:9]).detach()
                vis_o = pos + n * EXT_OFFSET
            else:
                wb = brdf.mixture_sample_wi(mat, n, wo, u[:, 3], u[:, 4:6]).detach()
                vis_o = pos + wb * VIS_OFFSET
            f_at_wb = brdf.mixture_f(mat, n, wb, wo)
            pdf_at_wb = brdf.mixture_pdf(mat, n, wb, wo).detach()
            if shared:
                # continuation throughput and Russian roulette before the shared
                # trace: killed lanes skip it, survivors carry 1 / (1 - q)
                cont_ok = (pdf_at_wb > 0.0) & (f_at_wb.detach() != 0.0).any(dim=-1)
                beta_next = torch.where(
                    alive[..., None],
                    beta * f_at_wb / torch.clamp(pdf_at_wb, min=1e-20)[..., None],
                    beta,
                )
                surv = alive & cont_ok
                if bounce >= cfg.rr_start:
                    q = torch.clamp(1.0 - beta_next[:, 1].detach(), min=RR_MIN_Q)
                    surv = surv & ~(u[:, 9] < q)
                    beta_next = beta_next / torch.clamp(1.0 - q.detach(), min=RR_MIN_Q)[..., None]
                ext_mask = surv
            else:
                surv = alive
                ext_mask = alive & ~delta
            if aid >= 0:
                # the bounded shadow any-hit, then the BRDF ray's closest hit:
                # did it reach the emitter?  (Env visibility is its miss.)
                visible = ~_occluded(scene, route, shadow_o, wl, mask=sh_mask,
                                     t_max=shadow_tmax) & alive
                hit_b = _intersect(scene, route, vis_o, wb, mask=ext_mask)
                if shared:
                    isect_next = hit_b
                with span("mcpt::area.hit"):
                    li_hit, pdf_sa_hit, on_light = lights_mod.area_eval_hit(
                        lights.area, scene.tris, hit_b, vis_o)
                    vis2 = torch.where(is_area, on_light, ~hit_b.hit) & ~delta & surv
                    li_brdf_raw = torch.where(
                        is_area[..., None], li_hit, lights_mod.radiance(lights, l_id, wb))
                    pdf_l_at_wb_raw = torch.where(
                        is_area, pdf_sa_hit.detach(),
                        lights_mod.pdf(lights, l_id, wb, env_importance=cfg.env_importance))
            elif shared:
                # the R-lane shadow any-hit; the extension's closest hit doubles
                # as the visibility query (a miss sees the environment along wb)
                visible = ~_occluded(scene, route, shadow_o, wl, mask=sh_mask) & alive
                isect_next = _intersect(scene, route, vis_o, wb, mask=ext_mask)
                vis2 = ~isect_next.hit & ~delta & surv
                li_brdf_raw = lights_mod.radiance(lights, l_id, wb)
                pdf_l_at_wb_raw = lights_mod.pdf(lights, l_id, wb,
                                                 env_importance=cfg.env_importance)
            else:
                # one fused any-hit dispatch for the shadow and visibility rays
                occ2 = _occluded(
                    scene, route,
                    torch.cat([shadow_o, vis_o], dim=0),
                    torch.cat([wl, wb], dim=0),
                    mask=torch.cat([sh_mask, alive & ~delta], dim=0),
                )
                visible = ~occ2[:num_rays] & alive
                vis2 = ~occ2[num_rays:] & ~delta & alive
                li_brdf_raw = lights_mod.radiance(lights, l_id, wb)
                pdf_l_at_wb_raw = lights_mod.pdf(lights, l_id, wb,
                                                 env_importance=cfg.env_importance)
            f_brdf = torch.where(vis2[..., None], f_at_wb, 0.0)
            li_brdf = torch.where(vis2[..., None], li_brdf_raw, 0.0)
            pdf_brdf = torch.where(vis2, pdf_at_wb, 1.0).detach()
            pdf_light_at_wb = torch.where(vis2, pdf_l_at_wb_raw, 1.0).detach()

            # ---- MIS combine ----
            w1 = power_heuristic(1, pdf_light, 1, pdf_brdf_at_wl).detach()
            if not quirks:
                w1 = torch.where(delta, 1.0, w1)
            w2 = power_heuristic(1, pdf_brdf, 1, pdf_light_at_wb).detach()
            if cfg.mis_mode == "light":
                w1, w2 = torch.ones_like(w1), torch.zeros_like(w2)
            elif cfg.mis_mode == "brdf":
                w1, w2 = torch.zeros_like(w1), torch.ones_like(w2)
            ld = torch.where(
                (visible & (pdf_light > 0.0) & (w1 > 0.0))[..., None],
                f_light * li_light * (w1 / torch.clamp(pdf_light, min=1e-20))[..., None],
                0.0,
            )
            ld_brdf = None
            if shared:
                # beta_next already carries f / pdf and the RR reweight; vis2
                # implies survival and pdf > 0
                ld_brdf = torch.where((vis2 & (w2 > 0.0))[..., None],
                                      beta_next * li_brdf * w2[..., None], 0.0)
            else:
                ld = ld + torch.where(
                    (vis2 & (pdf_brdf > 0.0) & (w2 > 0.0))[..., None],
                    f_brdf * li_brdf * (w2 / torch.clamp(pdf_brdf, min=1e-20))[..., None],
                    0.0,
                )
            if not quirks:
                ld = ld * float(n_lights)  # uniform-selection compensation
                if ld_brdf is not None:
                    ld_brdf = ld_brdf * float(n_lights)
            l_out = l_out + torch.where(alive[..., None], beta * ld, 0.0)
            if ld_brdf is not None:
                l_out = l_out + ld_brdf

            # ---- path continuation sample ----
            if shared:
                ws, beta, alive = wb, beta_next, surv
            else:
                if reuse:
                    ws, pdf_s, f_s = wb, pdf_at_wb, f_at_wb
                else:
                    ws = brdf.mixture_sample_wi(mat, n, wo, u[:, 6], u[:, 7:9]).detach()
                    pdf_s = brdf.mixture_pdf(mat, n, ws, wo).detach()
                    f_s = brdf.mixture_f(mat, n, ws, wo)
                cont_ok = (pdf_s > 0.0) & (f_s.detach() != 0.0).any(dim=-1)
                beta = torch.where(
                    alive[..., None],
                    beta * f_s / torch.clamp(pdf_s, min=1e-20)[..., None],
                    beta,
                )
                alive = alive & cont_ok

                # ---- Russian roulette ----
                if bounce >= cfg.rr_start:
                    q = torch.clamp(1.0 - beta[:, 1].detach(), min=RR_MIN_Q)
                    alive = alive & ~(u[:, 9] < q)
                    if not quirks:
                        beta = beta / torch.clamp(1.0 - q.detach(), min=RR_MIN_Q)[..., None]

            # ---- extension, only if another NEE bounce follows ----
            if not last:
                ray_d = ws
                wo = -ray_d
                if isect_next is None:
                    isect_next = _intersect(scene, route, pos + n * EXT_OFFSET, ray_d, mask=alive)
                isect = isect_next
                alive = alive & isect.hit

    return l_out


def _folds(key: torch.Tensor, folds) -> list:
    """fold_in(key, d) for each d in `folds`, as [two ints] rows: the
    host's threefry, ready for one tensor of key words."""
    return [rng.fold_in(key, d).tolist() for d in folds]


def _key_words(key: torch.Tensor, cfg: RenderConfig, spp: int, device) -> torch.Tensor:
    """The keys that samples 0..spp-1 draw from, as words on `device`:
    [spp, 2 + (max_depth - 1), 2] int64, row s holding fold_in(skey, d) of
    the sample key skey = fold_in(key, s) for d = JITTER_FOLD (zeros with
    jitter off), LENS_FOLD and the bounces 1..max_depth-1.  Derived on the
    host once per render_tile_radiance call and sent to the device as one
    tensor, which every pass of the call reads."""
    rows = []
    for s in range(spp):
        skey = rng.fold_in(key, s)
        jitter = _folds(skey, [JITTER_FOLD]) if cfg.jitter else [[0, 0]]
        rows.append(jitter + _folds(skey, (LENS_FOLD, *range(1, cfg.max_depth))))
    return torch.tensor(rows, dtype=torch.int64).to(device)


def _sample_pass(scene, cfg, camera, width, height, px, py, words, sample_idx, block=0):
    """The k samples sample_idx .. sample_idx + k - 1 of pixels (px, py)
    [R] in one pass over sample-major lanes, lane j * R + i pixel i's
    sample sample_idx + j: radiance [k * R, 3].  `words` are those
    samples' rows of `_key_words`, [k, F, 2] on the lanes' device: the
    jitter key words[:, 0], the lens key words[:, 1] and the bounce keys
    words[:, 2:], each read per lane with its pixel id.  `block` (the
    block's index in its render_tile_radiance call) only names the pass's
    span, with its first sample and its sample count."""
    k = words.shape[0]
    with span("mcpt::sample", ident=(block, sample_idx, k)):
        pid = (py * width + px).to(torch.int32)
        # k runs of the pixels; a view at k = 1
        px, py, pid = (v.expand(k, -1).reshape(-1) for v in (px, py, pid))
        with span("mcpt::camera"):
            if cfg.jitter:
                uj = rng.pixel_uniforms(words[:, 0], pid, 2)
                pxj = px + uj[..., 0] - 0.5
                pyj = py + uj[..., 1] - 0.5
            else:
                pxj, pyj = px, py
            lens_u = rng.pixel_uniforms(words[:, 1], pid, 2)
            ro, rd = camera_mod.gen_camera_rays(camera, width, height, pxj, pyj, lens_u)
        return trace_radiance(scene, ro, rd, None, cfg, pid=pid, bounce_keys=words[:, 2:])


def _requires_grad(*trees) -> bool:
    """Whether any tensor in these (nested tuples of) tensors requires grad."""
    for x in trees:
        if isinstance(x, torch.Tensor):
            if x.requires_grad:
                return True
        elif isinstance(x, tuple) and _requires_grad(*x):
            return True
    return False


def render_tile_radiance(scene: SceneData, camera: camera_mod.CameraParams,
                         width: int, height: int, px: torch.Tensor,
                         py: torch.Tensor, key: torch.Tensor, cfg: RenderConfig,
                         spp: int | None = None, replay: bool = True,
                         first: int = 0) -> torch.Tensor:
    """Radiance summed over `spp` samples for pixels (px, py) [R] (f32
    pixel coordinates), [R, 3].  The pixels run in blocks, each through
    every sample before the next block starts, so live state stays bounded
    by the block.  While autograd records a graph a block is PIXEL_CHUNK
    pixels, otherwise (a forward render keeps no graph) FRAME_CHUNK
    pixels.  Either block's (pixel, sample) pairs run in passes of at most
    FRAME_CHUNK lanes, since fewer, wider passes launch fewer kernels: a
    block of B pixels runs k = min(samples left, FRAME_CHUNK // B), at
    least 1, samples a pass over k * B sample-major lanes (1 for a 1080p
    frame, 32 for a 256 x 256 one or a 384 x 128 train step).  Every sample's
    keys are derived on the host and sent to the device once per call
    (`_key_words`); each pass, and its replay, reads its rows.  Each
    pixel adds its samples in order, s = 0, 1, ..., and each lane's path
    is its own, its noise keyed by pixel id and sample, so the radiance
    does not depend on the cut.  Under autograd each pass is replayed in
    the backward (module docstring) unless `replay=False`, which keeps
    every pass's graph alive until the backward instead.  `first` is
    px[0]'s index in a longer pixel list that is rendered in parts (a
    shard's rows): blocks are cut at multiples of the block size of that
    list, so each part runs the whole list's blocks (one cut by a part's
    edge runs as two), and a gradient summed over the parts adds the same
    per-block sums."""
    spp = cfg.spp if spp is None else spp
    records = torch.is_grad_enabled() and _requires_grad(scene, camera)
    replay = replay and records
    chunk = PIXEL_CHUNK if records else FRAME_CHUNK
    r = px.shape[0]
    cuts = sorted({0, *range(-first % chunk, r, chunk)}) + [r]
    words = _key_words(key, cfg, spp, px.device)
    blocks = []
    for b, (c0, c1) in enumerate(zip(cuts[:-1], cuts[1:])):
        px_c, py_c, size = px[c0:c1], py[c0:c1], c1 - c0
        acc = torch.zeros((size, 3), dtype=torch.float32, device=px.device)
        k = max(1, min(spp, FRAME_CHUNK // max(size, 1)))
        for s in range(0, spp, k):
            n = min(k, spp - s)
            args = (scene, cfg, camera, width, height, px_c, py_c, words[s:s + n], s, b)
            if replay:
                sample = checkpoint(_sample_pass, *args, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                sample = _sample_pass(*args)
            # one unbind, not n slices: each slice's backward would fill
            # and copy a zero gradient the size of the whole pass
            for part in sample.view(n, size, 3).unbind(0):
                acc = acc + part
        blocks.append(acc)
    return torch.cat(blocks, dim=0)


def built_scene(scene, device=DEFAULT_DEVICE):
    """(SceneData, its device): a SceneData as given, on its own device, or
    a Scene built on `device`."""
    if isinstance(scene, SceneData):
        return scene, scene.tris.v0.device
    device = resolve_device(device)
    return scene.build(device), device


def camera_params(camera, width: int, height: int, device=DEFAULT_DEVICE):
    """A host PerspectiveCamera (aspect set from the film size) or
    ready-made CameraParams."""
    if isinstance(camera, camera_mod.CameraParams):
        return camera
    return dataclasses.replace(camera, aspect=width / height).params(device)


@spanned("mcpt::render")
def render(scene, camera, width: int, height: int,
           cfg: RenderConfig = RenderConfig(), key: torch.Tensor | None = None,
           device=DEFAULT_DEVICE) -> Film:
    """Render a full frame.  `scene` is a Scene (built on `device`, the card
    unless device="cpu") or a SceneData (rendered on its own device).
    Pixels are traced in 32x16 tile-major order and scattered back to image
    layout."""
    _check_supported(cfg)
    scene_data, device = built_scene(scene, device)
    if key is None:
        key = rng.prng_key(0)
    cam = camera_params(camera, width, height, device)
    pxi, pyi = tile_order(width, height)
    px = torch.from_numpy(pxi.astype(np.float32)).to(device)
    py = torch.from_numpy(pyi.astype(np.float32)).to(device)
    acc = render_tile_radiance(scene_data, cam, width, height, px, py, key, cfg)
    with span("mcpt::film"):
        img = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
        img[torch.from_numpy(pyi).long().to(device),
            torch.from_numpy(pxi).long().to(device)] = acc
        return Film(ld=img, samples=torch.full((height, width), float(cfg.spp),
                                               dtype=torch.float32, device=device))


def _tile_pass(scene: SceneData, cam, x0: int, y0: int, key: torch.Tensor, tw: int,
               th: int, width: int, height: int, cfg: RenderConfig,
               spp: int) -> torch.Tensor:
    """One progressive pass over the tile (x0, y0, tw, th): radiance summed
    over `spp` samples, [th, tw, 3]."""
    device = scene.tris.v0.device
    ys, xs = torch.meshgrid(torch.arange(th, device=device),
                            torch.arange(tw, device=device), indexing="ij")
    px = (xs.reshape(-1) + x0).to(torch.float32)
    py = (ys.reshape(-1) + y0).to(torch.float32)
    acc = render_tile_radiance(scene, cam, width, height, px, py, key, cfg, spp)
    return acc.reshape(th, tw, 3)


def render_progressive(scene, camera, width: int, height: int,
                       cfg: RenderConfig = RenderConfig(), key: torch.Tensor | None = None,
                       tile: int = 256, spp_per_pass: int = 1, device=DEFAULT_DEVICE):
    """Progressive generator: yields a new Film after each (pass, tile) step,
    one tile per step in round-robin order.  Pass p's samples are keyed by
    fold_in(key, p), so the final film equals the sum of `render` frames of
    spp_per_pass samples with keys fold_in(key, p).  Re-invoking after a
    scene edit restarts accumulation."""
    _check_supported(cfg)
    scene_data, device = built_scene(scene, device)
    if key is None:
        key = rng.prng_key(0)
    cam = camera_params(camera, width, height, device)
    film = make_film(width, height, device)
    passes = (cfg.spp + spp_per_pass - 1) // spp_per_pass
    for p in range(passes):
        kp = rng.fold_in(key, p)
        for x0, y0, tw, th in tile_grid(width, height, tile):
            # noise is keyed by pixel id: tiles need no fold of their own
            acc = _tile_pass(scene_data, cam, x0, y0, kp, tw, th, width, height, cfg,
                             spp_per_pass)
            ld, samples = film.ld.clone(), film.samples.clone()
            ld[y0 : y0 + th, x0 : x0 + tw] += acc
            samples[y0 : y0 + th, x0 : x0 + tw] += float(spp_per_pass)
            film = Film(ld=ld, samples=samples)
            yield film
