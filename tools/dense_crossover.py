"""Dense kernel against traversal kernel as the scene grows, on a CUDA GPU:
where the crossover lies that DENSE_ACCEL_MAX_TRIS (2048, the TPU's choice)
assumes.

Each scene is config2's layout (floor, emissive quad, a box) with a UV
sphere of growing tessellation in place of config2's sphere; config2
itself is the 2,320-triangle row.  For each scene: 65,536 camera rays of a
256x256 frame (closest hit) and 65,536 bounded shadow rays from their hits
toward points sampled on the quad (any-hit), each timed with CUDA events
over 20 launches on both kernels and by their device time
(torch.profiler), and the kernels' outputs held against each other.
Prints one JSON line per scene.

    python3 tools/dense_crossover.py

Imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SIZE = 256
# (rings, segments) of the sphere: 2*rings*segments triangles
SPHERES = ((2, 3), (4, 6), (8, 12), (12, 24), (16, 32), (20, 40), (24, 48), (32, 64),
           (48, 96))


def scene_with_sphere(rings: int, segments: int):
    from mc_path_tracer_tpu_torch import configs
    from mc_path_tracer_tpu_torch.models.primitives import uv_sphere
    from mc_path_tracer_tpu_torch.models.scene import ObjectEntry

    scene, cam, _, _ = configs.config2_mis_area_light()
    p, n, uv, idx = uv_sphere(0.7, center=(1.0, 0.7, 0.3), rings=rings, segments=segments)
    sphere = 2   # config2's third mesh: the sphere
    scene.objects[sphere] = ObjectEntry(p, n, uv, idx, scene.objects[sphere].material_id)
    scene.notify()
    return scene, cam


def main() -> int:
    from mc_path_tracer_tpu_torch.models import lights as lights_mod
    from mc_path_tracer_tpu_torch.models.film import tile_order
    from mc_path_tracer_tpu_torch.models.integrator import SHADOW_OFFSET
    from mc_path_tracer_tpu_torch.ops import intersect
    from mc_path_tracer_tpu_torch.ops.kernels import dense, traversal

    name_limit = cs.phase_device()
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(1)
    pxi, pyi = tile_order(SIZE, SIZE)
    px = torch.from_numpy(pxi.astype(np.float32)).to(device)
    py = torch.from_numpy(pyi.astype(np.float32)).to(device)
    for rings, segments in SPHERES:
        scene, cam = scene_with_sphere(rings, segments)
        sd = scene.build(device)
        geo, bvh = sd.tris.geo, sd.bvh
        ro, rd = cs._camera_rays(cam, SIZE, SIZE, px, py, device)
        camera_rays = intersect.pack_rays(ro, rd)
        _, tri_id = dense.dense_closest(camera_rays, geo)
        h = intersect.finish_closest(sd.tris, tri_id, ro, rd)
        u3 = torch.rand((ro.shape[0], 3), generator=gen, device=device)
        wl, dist, _, _ = lights_mod.sample_area(sd.lights.area, sd.tris, h.position, u3)
        shadow_rays = intersect.pack_rays(h.position + h.normal * SHADOW_OFFSET, wl, h.hit,
                                          dist * (1.0 - 1e-3) - 2.0 * SHADOW_OFFSET)
        row = {"triangles": geo.shape[0], "nodes": sd.bvh.num_nodes, "card": name_limit}
        for kind, rays, dense_fn, trav_fn in (
            ("closest", camera_rays, dense.dense_closest, traversal.trace_closest),
            ("anyhit", shadow_rays, dense.dense_anyhit, traversal.trace_anyhit),
        ):
            d_ms, d_out = cs._time_ms(lambda: dense_fn(rays, geo), 20)
            t_ms, t_out = cs._time_ms(lambda: trav_fn(rays, bvh, geo), 20)
            d_id = d_out[1] if kind == "closest" else d_out
            t_id = t_out[1] if kind == "closest" else t_out
            row[f"{kind}_dense_ms"] = d_ms
            row[f"{kind}_traversal_ms"] = t_ms
            row[f"{kind}_dense_device_ms"] = cs._device_ms(lambda: dense_fn(rays, geo), 20)
            row[f"{kind}_traversal_device_ms"] = cs._device_ms(
                lambda: trav_fn(rays, bvh, geo), 20)
            row[f"{kind}_agreement"] = (d_id == t_id).float().mean().item()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
