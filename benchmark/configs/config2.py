"""config2, area lights with MIS: a 20 m floor, a box and a 24 x 48 UV
sphere under one emissive quad (2,320 triangles) and a constant-colour
environment; a frozen copy of the port's configs.config2_mis_area_light."""

from __future__ import annotations

import numpy as np

from benchmark.harness.area_scene import AreaSceneSpec, box
from benchmark.harness.scene import plane, uv_sphere


def scene(cfg: dict) -> AreaSceneSpec:
    s = AreaSceneSpec(camera=dict(cfg["camera"]), env_color=(0.02, 0.02, 0.03), env_ls=1.0)
    floor = s.add_material((0.6, 0.6, 0.6), roughness=0.8)
    s.add_mesh(plane(20.0), floor)
    cube = s.add_material((0.7, 0.2, 0.2), roughness=0.4)
    s.add_mesh(box((1.2, 1.2, 1.2), center=(-1.0, 0.6, 0.0)), cube)
    ball = s.add_material((0.2, 0.4, 0.8), roughness=0.15, metallic=0.3)
    s.add_mesh(uv_sphere(0.7, center=(1.0, 0.7, 0.3), rings=24, segments=48), ball)
    light = s.add_material((0.0, 0.0, 0.0), roughness=1.0, emissive=(12.0, 11.0, 9.0))
    quad = np.array([[-0.8, 3, -0.8], [0.8, 3, -0.8], [0.8, 3, 0.8], [-0.8, 3, 0.8]],
                    np.float32)
    s.add_mesh((quad, np.tile([[0, -1, 0]], (4, 1)).astype(np.float32),
                np.zeros((4, 2), np.float32), np.array([[0, 1, 2], [0, 2, 3]], np.int64)), light)
    return s
