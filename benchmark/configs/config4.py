"""config4, the GGX roughness sweep: six spheres of roughness 0.05..0.95
on a floor under a 32 x 64 HDR environment drawn from seed 1 (13,826
triangles); a frozen copy of the port's configs.config4_roughness_sweep."""

from __future__ import annotations

import numpy as np

from benchmark.harness.scene import SceneSpec, plane, uv_sphere


def scene(cfg: dict) -> SceneSpec:
    s = SceneSpec(camera=dict(cfg["camera"]))
    rng = np.random.default_rng(1)
    s.env = (rng.uniform(0.1, 1.2, (32, 64, 3)) ** 2).astype(np.float32)
    floor = s.add_material((0.5, 0.5, 0.5), roughness=0.9)
    s.add_mesh(plane(40.0), floor)
    for i in range(6):
        m = s.add_material((0.9, 0.3, 0.2), roughness=0.05 + 0.18 * i, metallic=0.0)
        s.add_mesh(uv_sphere(0.6, center=(1.5 * (i - 2.5), 0.6, 0.0), rings=24, segments=48), m)
    return s
