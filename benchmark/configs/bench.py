"""The bench scene: a 40 m plane and a 5 x 3 grid of UV spheres (48,002
triangles), a 64 x 128 HDR environment drawn from seed 0 and one
directional light; a frozen copy of the port's bench.build_bench_scene."""

from __future__ import annotations

import numpy as np

from benchmark.harness.scene import SceneSpec, plane, uv_sphere


def scene(cfg: dict) -> SceneSpec:
    s = SceneSpec(camera=dict(cfg["camera"]))
    rng = np.random.default_rng(0)
    s.env = (rng.uniform(0.1, 2.0, size=(64, 128, 3)) ** 2).astype(np.float32)
    s.directional.append(((0.4, 1.0, 0.2), (1.0, 0.95, 0.8), 3.0))
    floor = s.add_material((0.7, 0.7, 0.7), roughness=0.9)
    s.add_mesh(plane(40.0), floor)
    for i in range(5):
        for j in range(3):
            m = s.add_material((0.2 + 0.15 * i, 0.3 + 0.2 * j, 0.8 - 0.1 * i),
                               roughness=0.1 + 0.2 * j, metallic=0.3 * j)
            s.add_mesh(uv_sphere(0.7, center=(1.8 * (i - 2), 0.7, 1.8 * (j - 1)),
                                 rings=32, segments=50), m)
    return s
