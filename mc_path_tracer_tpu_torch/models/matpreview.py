"""Material preview: one material on a preview sphere (port of
mc_path_tracer_tpu/models/matpreview.py).  `preview_material` builds the
studio scene (a 9,216-triangle sphere on a neutral floor under a soft
gradient sky with a warm key light), applies the material and renders it
with the fast preview or the path tracer.
"""

from __future__ import annotations

import numpy as np

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE
from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera
from mc_path_tracer_tpu_torch.models.film import Film
from mc_path_tracer_tpu_torch.models.integrator import RenderConfig, render
from mc_path_tracer_tpu_torch.models.preview import render_preview
from mc_path_tracer_tpu_torch.models.primitives import plane, uv_sphere
from mc_path_tracer_tpu_torch.models.scene import Scene


def _studio_env(h=32, w=64):
    """Soft gradient sky and a warm key-light patch (procedural, used when
    no HDR is given)."""
    v = np.linspace(0, 1, h)[:, None]
    base = (1.2 - 0.8 * v) * np.ones((h, w))
    tex = np.stack([base * 0.9, base * 0.95, base * 1.1], axis=-1)
    tex[h // 4 : h // 3, w // 6 : w // 4] = [18.0, 16.0, 14.0]  # key light
    return tex.astype(np.float32)


def build_preview_scene(
    albedo=(0.8, 0.3, 0.2), roughness=0.4, metallic=0.0,
    fresnel=(0.04, 0.04, 0.04), env_hdr=None, env_ls=1.0,
) -> Scene:
    s = Scene()
    s.set_environment_hdr(_studio_env() if env_hdr is None else env_hdr, ls=env_ls)
    floor = s.add_material(albedo=(0.5, 0.5, 0.5), roughness=0.95)
    p, n, uv, idx = plane(20.0, center=(0, -1.0, 0))
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=floor)
    m = s.add_material(albedo=albedo, roughness=roughness, metallic=metallic,
                       fresnel=fresnel)
    p, n, uv, idx = uv_sphere(1.0, center=(0, 0, 0), rings=48, segments=96)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=m)
    return s


def preview_material(
    albedo=(0.8, 0.3, 0.2), roughness=0.4, metallic=0.0,
    fresnel=(0.04, 0.04, 0.04), size=256, spp=16, path_traced=False,
    env_hdr=None, key=None, device=DEFAULT_DEVICE,
) -> Film:
    """Render the material ball; path_traced=False uses the fast preview."""
    s = build_preview_scene(albedo, roughness, metallic, fresnel, env_hdr)
    cam = PerspectiveCamera(
        position=np.array([0.0, 0.6, 3.2]), target=np.array([0.0, 0.0, 0.0]),
        fov_deg=40.0,
    )
    if path_traced:
        return render(s, cam, size, size, RenderConfig(spp=spp, max_depth=4),
                      key=key, device=device)
    return render_preview(s, cam, size, size, "shaded", device=device)
