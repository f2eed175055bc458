"""Light models: environment (HDRI or colour) and directional lights (port of
mc_path_tracer_tpu/models/lights.py without the emissive-mesh area light).

The light table is [environment, directional_0 .. directional_D-1]; per-ray
light ids select behaviour with `where`s.
  - Directional: delta light, fixed direction, L = ls * color, pdf 1.
  - Env Color mode: uniform-sphere direction, L = color * ls, pdf 1/(4 pi).
  - Env HDRI mode: CDF-sampled direction, L = bilinear texture fetch (ls is
    not applied, as in the reference), pdf per ops/envmap.pdf.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mc_path_tracer_tpu_torch.ops import envmap
from mc_path_tracer_tpu_torch.ops.math import INV_4PI


class EnvLight(NamedTuple):
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


class LightSet(NamedTuple):
    env: EnvLight
    directional: DirectionalLights


def _dev(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def make_env_color(color=(1.0, 1.0, 1.0), ls=1.0, device=None) -> EnvLight:
    dummy = np.ones((1, 1, 3), np.float32)
    return EnvLight(
        color=_dev(color, device),
        ls=_dev(ls, device),
        tex=_dev(dummy, device),
        dist=envmap.build_distribution(dummy, device),
    )


def make_env_hdri(tex, ls=1.0, device=None) -> EnvLight:
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


def make_directional(directions, colors, ls, device=None) -> DirectionalLights:
    d = np.atleast_2d(np.asarray(directions, np.float32))
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    c = np.broadcast_to(np.atleast_2d(np.asarray(colors, np.float32)), d.shape)
    s = np.broadcast_to(np.asarray(ls, np.float32).reshape(-1), (d.shape[0],))
    return DirectionalLights(
        direction=_dev(d, device), color=_dev(c, device), ls=_dev(s, device)
    )


def empty_directional(device=None) -> DirectionalLights:
    return DirectionalLights(
        direction=torch.zeros((0, 3), device=device),
        color=torch.zeros((0, 3), device=device),
        ls=torch.zeros((0,), device=device),
    )


def num_lights(lights: LightSet) -> int:
    """Light table size: [env, dir_0, ..., dir_D-1]."""
    return 1 + lights.directional.direction.shape[0]


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
    """Delta flag per chosen light: env False, directional True."""
    return light_id != 0
