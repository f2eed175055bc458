"""Light models: environment (HDRI or colour), directional lights and the
emissive-triangle area light (port of mc_path_tracer_tpu/models/lights.py).

The light table is [environment, directional_0 .. directional_D-1, area?];
per-ray light ids select behaviour with `where`s.
  - Directional: delta light, fixed direction, L = ls * color, pdf 1.
  - Env Color mode: uniform-sphere direction, L = color * ls, pdf 1/(4 pi).
  - Env HDRI mode: CDF-sampled direction, L = bilinear texture fetch (ls is
    not applied, as in the reference), pdf per ops/envmap.pdf.
  - Area: every emissive triangle of the scene as one light entity, the
    last id of the table: a triangle picked by an area-weighted CDF, a
    uniform point on it, one-sided emission, solid-angle
    pdf = dist^2 / (cos_light * total_area).  `sample_area` and
    `area_eval_hit` return its terms; the integrator merges them in.
  - PointLight: a host-only stub that `Scene.add_point_light` stores and
    that never illuminates, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mc_path_tracer_tpu_torch.ops import envmap
from mc_path_tracer_tpu_torch.ops.math import INV_4PI, dot


class EnvLight(NamedTuple):
    """Environment light; its mode (envmap.COLOR_MODE or HDRI_MODE) follows
    from the texture's shape (env_is_hdri)."""

    color: torch.Tensor                 # [3]
    ls: torch.Tensor                    # [] radiance scale (Color mode only)
    tex: torch.Tensor                   # [H, W, 3] HDR ([1, 1, 3] in Color mode)
    dist: envmap.EnvMapDistribution
    # quad-packed radiance table [H, W, 12] attached by with_packed()
    packed: torch.Tensor | None = None


class DirectionalLights(NamedTuple):
    direction: torch.Tensor  # [D, 3] unit, from the surface toward the light
    color: torch.Tensor      # [D, 3]
    ls: torch.Tensor         # [D]


class AreaLights(NamedTuple):
    """All emissive triangles of the scene, as one area-sampled light."""

    tri_idx: torch.Tensor     # [E] int32 into the leaf-order TriangleSoA
    emission: torch.Tensor    # [E, 3]
    area: torch.Tensor        # [E]
    cdf: torch.Tensor         # [E] area-weighted selection CDF (ends at 1)
    total_area: torch.Tensor  # []

    @property
    def count(self) -> int:
        return self.tri_idx.shape[0]


class LightSet(NamedTuple):
    env: EnvLight
    directional: DirectionalLights
    area: AreaLights


@dataclass
class PointLight:
    """Host-only parity stub: stored by `Scene.add_point_light` and never
    illuminates (the reference's PointLight has no device implementation,
    and the JAX package keeps it as a stub too)."""

    position: np.ndarray
    color: np.ndarray
    ls: float = 1.0


def _dev(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=resolve_device(device))


def make_env_color(color=(1.0, 1.0, 1.0), ls=1.0, device=DEFAULT_DEVICE) -> EnvLight:
    dummy = np.ones((1, 1, 3), np.float32)
    return EnvLight(
        color=_dev(color, device),
        ls=_dev(ls, device),
        tex=_dev(dummy, device),
        dist=envmap.build_distribution(dummy, device),
    )


def make_env_hdri(tex, ls=1.0, device=DEFAULT_DEVICE) -> EnvLight:
    """HDRI env light; `ls` is stored but not applied (reference parity)."""
    tex = np.asarray(tex, np.float32)
    return EnvLight(
        color=_dev(np.ones(3), device),
        ls=_dev(ls, device),
        tex=_dev(tex, device),
        dist=envmap.build_distribution(tex, device),
    )


def env_is_hdri(env: EnvLight) -> bool:
    """Mode check from the texture's shape."""
    return env.tex.shape[0] > 1 or env.tex.shape[1] > 1


def make_directional(directions, colors, ls, device=DEFAULT_DEVICE) -> DirectionalLights:
    d = np.atleast_2d(np.asarray(directions, np.float32))
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    c = np.broadcast_to(np.atleast_2d(np.asarray(colors, np.float32)), d.shape)
    s = np.broadcast_to(np.asarray(ls, np.float32).reshape(-1), (d.shape[0],))
    return DirectionalLights(
        direction=_dev(d, device), color=_dev(c, device), ls=_dev(s, device)
    )


def empty_directional(device=DEFAULT_DEVICE) -> DirectionalLights:
    return DirectionalLights(
        direction=_dev(np.zeros((0, 3)), device),
        color=_dev(np.zeros((0, 3)), device),
        ls=_dev(np.zeros(0), device),
    )


def empty_area(device=DEFAULT_DEVICE) -> AreaLights:
    return AreaLights(
        tri_idx=torch.zeros((0,), dtype=torch.int32, device=resolve_device(device)),
        emission=_dev(np.zeros((0, 3)), device),
        area=_dev(np.zeros(0), device),
        cdf=_dev(np.zeros(0), device),
        total_area=_dev(0.0, device),
    )


def make_area_lights(tris, emissive_mask, emission_table,
                     device=DEFAULT_DEVICE) -> AreaLights:
    """Collect emissive triangles into an AreaLights table, on the host.

    tris: the leaf-order TriangleSoA (the ids index it); emissive_mask [T]
    bool; emission_table [T, 3] per-triangle emission."""
    idx = np.nonzero(np.asarray(emissive_mask))[0].astype(np.int32)
    if idx.size == 0:
        return empty_area(device)
    e1 = tris.e1.cpu().numpy()[idx]
    e2 = tris.e2.cpu().numpy()[idx]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    total = float(area.sum())
    cdf = np.cumsum(area) / max(total, 1e-20)
    return AreaLights(
        tri_idx=torch.from_numpy(idx).to(resolve_device(device)),
        emission=_dev(np.asarray(emission_table)[idx], device),
        area=_dev(area, device),
        cdf=_dev(cdf, device),
        total_area=_dev(total, device),
    )


def sample_area(area: AreaLights, tris, pos: torch.Tensor, u3: torch.Tensor):
    """A point on the area light toward each shading point.

    Returns (wi [R,3], dist [R], li [R,3], pdf_sa [R]): direction, distance
    to the light point (for the bounded shadow ray), emitted radiance and
    the solid-angle pdf.  One-sided: the light emits from its face-normal
    side only."""
    e = torch.clamp(torch.searchsorted(area.cdf, u3[..., 0].contiguous(), right=True),
                    0, area.count - 1)
    tid = area.tri_idx[e].long()
    # uniform point on the triangle: p = v0 + u*e1 + v*e2 with the sqrt warp
    su = torch.sqrt(torch.clamp(u3[..., 1], min=0.0))
    ub = 1.0 - su
    vb = u3[..., 2] * su
    p = tris.v0[tid] + ub[..., None] * tris.e1[tid] + vb[..., None] * tris.e2[tid]
    delta = p - pos
    dist2 = torch.clamp(dot(delta, delta), min=1e-12)
    dist = torch.sqrt(dist2)
    wi = delta / dist[..., None]
    cos_l = torch.clamp(dot(tris.face_normal[tid], -wi), min=0.0)
    li = torch.where((cos_l > 0.0)[..., None], area.emission[e], 0.0)
    pdf_sa = torch.where(
        cos_l > 1e-6, dist2 / torch.clamp(cos_l * area.total_area, min=1e-12), 0.0)
    return wi, dist, li, pdf_sa


def area_eval_hit(area: AreaLights, tris, hit, ray_o: torch.Tensor):
    """The area light seen by the closest-hit record of a BRDF-sampled ray:
    (li [R,3], pdf_sa [R], on_light [R]), pdf in sample_area's measure so
    the power heuristic combines the two.  Misses index the sentinel row T
    of the per-triangle tables."""
    if area.count == 0:
        z = torch.zeros(hit.t.shape, dtype=torch.float32, device=hit.t.device)
        return z[..., None].expand(*hit.t.shape, 3), z, torch.zeros_like(hit.hit)
    n_tris = tris.v0.shape[0]
    idx = area.tri_idx.long()
    is_emissive = torch.zeros(n_tris + 1, dtype=torch.bool, device=idx.device)
    is_emissive[idx] = True
    emission_of = torch.zeros((n_tris + 1, 3), dtype=torch.float32, device=idx.device)
    emission_of[idx] = area.emission
    tid = torch.where(hit.hit, hit.tri_id, n_tris).long()
    n_l = tris.face_normal[torch.clamp(hit.tri_id, min=0).long()]
    d = hit.position - ray_o
    dist2 = torch.clamp(dot(d, d), min=1e-12)
    wi = d / torch.sqrt(dist2)[..., None]
    cos_l = torch.clamp(dot(n_l, -wi), min=0.0)
    on_light = hit.hit & is_emissive[tid] & (cos_l > 1e-6)
    li = torch.where(on_light[..., None], emission_of[tid], 0.0)
    pdf_sa = torch.where(
        on_light, dist2 / torch.clamp(cos_l * area.total_area, min=1e-12), 0.0)
    return li, pdf_sa, on_light


def num_lights(lights: LightSet) -> int:
    """Light table size: [env, dir_0, ..., dir_D-1, area?]."""
    return 1 + lights.directional.direction.shape[0] + (1 if lights.area.count else 0)


def area_light_id(lights: LightSet) -> int:
    """Table id of the area light (num_lights - 1), or -1 if there is none."""
    return 1 + lights.directional.direction.shape[0] if lights.area.count else -1


def _dir_field(lights: LightSet, light_id: torch.Tensor, values: torch.Tensor):
    """Gather a directional-light field by table id (id 0, the env, reads
    directional 0 and is masked by the caller)."""
    d = lights.directional.direction.shape[0]
    return values[torch.clamp(light_id - 1, 0, d - 1)]


def sample_dir(lights: LightSet, light_id: torch.Tensor, u2: torch.Tensor,
               env_importance: bool = True) -> torch.Tensor:
    """Light-sampling direction for each ray's chosen light;
    `env_importance=False` samples an HDRI env uniformly over the sphere."""
    if env_is_hdri(lights.env) and env_importance:
        wi_env, _ = envmap.sample_direction(lights.env.dist, u2)
    else:
        wi_env = envmap.sample_color_mode(u2)
    if lights.directional.direction.shape[0] == 0:
        return wi_env
    wi_dir = _dir_field(lights, light_id, lights.directional.direction)
    return torch.where((light_id == 0)[..., None], wi_env, wi_dir)


def with_packed(lights: LightSet) -> LightSet:
    """Attach the one-gather bilinear radiance table to an HDRI env light
    (skipped above ~2M texels, where radiance() reads four texels)."""
    if not env_is_hdri(lights.env) or lights.env.packed is not None:
        return lights
    h, w = lights.env.tex.shape[0], lights.env.tex.shape[1]
    if h * w > 2 * 1024 * 1024:
        return lights
    return lights._replace(
        env=lights.env._replace(packed=envmap.pack_bilinear(lights.env.tex))
    )


def radiance(lights: LightSet, light_id: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """L(wi) for each ray's chosen light."""
    if env_is_hdri(lights.env):
        if lights.env.packed is not None:
            l_env = envmap.radiance_packed(lights.env.packed, wi)
        else:
            l_env = envmap.radiance(lights.env.tex, wi)
    else:
        l_env = (lights.env.color * lights.env.ls).expand(wi.shape)
    if lights.directional.direction.shape[0] == 0:
        return l_env
    c = _dir_field(lights, light_id, lights.directional.color)
    s = _dir_field(lights, light_id, lights.directional.ls[:, None])
    return torch.where((light_id == 0)[..., None], l_env, c * s)


def pdf(lights: LightSet, light_id: torch.Tensor, wi: torch.Tensor,
        env_importance: bool = True) -> torch.Tensor:
    """Solid-angle pdf for each ray's chosen light."""
    if env_is_hdri(lights.env) and env_importance:
        p_env = envmap.pdf(lights.env.dist, wi)
    else:
        p_env = torch.full(wi.shape[:-1], INV_4PI, dtype=torch.float32, device=wi.device)
    if lights.directional.direction.shape[0] == 0:
        return p_env
    return torch.where(light_id == 0, p_env, 1.0)


def is_delta(lights: LightSet, light_id: torch.Tensor) -> torch.Tensor:
    """Delta flag per chosen light: env and area False, directional True."""
    delta = light_id != 0
    aid = area_light_id(lights)
    return delta & (light_id != aid) if aid >= 0 else delta
