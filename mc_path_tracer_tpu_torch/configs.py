"""Verification configs of the port (port of mc_path_tracer_tpu/configs.py).

Each builder returns (scene, camera, render_config, (width, height)) with
the JAX builder's arguments, built from the port's Scene, PerspectiveCamera
and RenderConfig.  Ported so far:
  2. cube + sphere with an emissive-quad area light (MIS), 256x256, 64 spp,
     depth 3.
Configs 1 and 3 load glTF assets when present and wait for `Scene.load`
(ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np

from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera
from mc_path_tracer_tpu_torch.models.integrator import RenderConfig
from mc_path_tracer_tpu_torch.models.primitives import box, plane, uv_sphere
from mc_path_tracer_tpu_torch.models.scene import Scene


def config2_mis_area_light():
    """Cube + sphere with an emissive-quad area light: MIS of BRDF vs light
    sampling (2 + 12 + 2,304 + 2 = 2,320 triangles)."""
    s = Scene()
    s.set_environment_color((0.02, 0.02, 0.03), ls=1.0)
    floor = s.add_material(albedo=(0.6, 0.6, 0.6), roughness=0.8)
    p, n, uv, idx = plane(20.0)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=floor)
    mcube = s.add_material(albedo=(0.7, 0.2, 0.2), roughness=0.4)
    p, n, uv, idx = box((1.2, 1.2, 1.2), center=(-1.0, 0.6, 0.0))
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=mcube)
    msph = s.add_material(albedo=(0.2, 0.4, 0.8), roughness=0.15, metallic=0.3)
    p, n, uv, idx = uv_sphere(0.7, center=(1.0, 0.7, 0.3), rings=24, segments=48)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=msph)
    em = s.add_material(albedo=(0, 0, 0), emissive=(12.0, 11.0, 9.0))
    q = np.array([[-0.8, 3, -0.8], [0.8, 3, -0.8], [0.8, 3, 0.8], [-0.8, 3, 0.8]],
                 np.float32)
    s.add_mesh(q, np.array([[0, 1, 2], [0, 2, 3]]),
               normals=np.tile([[0, -1, 0]], (4, 1)).astype(np.float32),
               material_id=em)
    cam = PerspectiveCamera(position=np.array([0.3, 2.2, 5.0]),
                            target=np.array([0.0, 0.7, 0.0]), fov_deg=40.0)
    return s, cam, RenderConfig(spp=64, max_depth=3), (256, 256)

