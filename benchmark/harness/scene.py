"""The benchmark's scene description, made once per run and handed to both
sides: the program builds its Scene from it (`to_program`), the reference
its own arrays (reference/scene.py).  Host numpy only.

The primitives are frozen copies of the port's models/primitives.py
(which are the JAX package's), so a configuration's geometry does not
move when the program changes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SceneSpec:
    meshes: list = field(default_factory=list)       # dicts: positions, normals, uvs, indices, material
    materials: list = field(default_factory=list)    # dicts: albedo, roughness, metallic[, fresnel]
    env: np.ndarray | None = None                    # HDR texels [H, W, 3]
    directional: list = field(default_factory=list)  # (direction, color, ls)
    camera: dict = field(default_factory=dict)       # position, target, fov_deg[, up, z_near, z_far]

    def add_material(self, albedo, roughness, metallic=0.0) -> int:
        self.materials.append({"albedo": tuple(float(a) for a in albedo),
                               "roughness": float(roughness), "metallic": float(metallic)})
        return len(self.materials) - 1

    def add_mesh(self, mesh, material: int) -> None:
        p, n, uv, idx = mesh
        self.meshes.append({"positions": p, "normals": n, "uvs": uv, "indices": idx,
                            "material": material})

    @property
    def num_triangles(self) -> int:
        return sum(int(np.asarray(m["indices"]).shape[0]) for m in self.meshes)


def uv_sphere(radius=1.0, center=(0, 0, 0), rings=32, segments=64):
    """Latitude/longitude sphere with CCW (outward) winding."""
    c = np.asarray(center, np.float32)
    theta = (np.pi * np.arange(rings + 1) / rings)[:, None]
    phi = (2 * np.pi * np.arange(segments + 1) / segments)[None, :]
    n = np.stack(np.broadcast_arrays(
        np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)),
        axis=-1).astype(np.float32).reshape(-1, 3)
    j, i = np.meshgrid(np.arange(segments + 1), np.arange(rings + 1))
    uv = np.stack([j / segments, i / rings], axis=-1).reshape(-1, 2)
    stride = segments + 1
    a = (np.arange(rings)[:, None] * stride + np.arange(segments)[None, :]).reshape(-1)
    b = a + stride
    idx = np.stack([np.stack([a, a + 1, b], -1), np.stack([a + 1, b + 1, b], -1)], axis=1)
    return ((c + radius * n).astype(np.float32), n, uv.astype(np.float32),
            idx.reshape(-1, 3).astype(np.int64))


def plane(size=20.0):
    """Two-triangle quad on y = 0 facing +y."""
    h = size / 2
    p = np.array([[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]], np.float32)
    n = np.tile([[0, 1, 0]], (4, 1)).astype(np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2]], np.int64)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return p, n, uv, idx


def to_program(spec: SceneSpec):
    """The port's host Scene holding the description, in its order."""
    from mc_path_tracer_tpu_torch.models.scene import Scene

    s = Scene()
    if spec.env is not None:
        s.set_environment_hdr(np.asarray(spec.env, np.float32), ls=1.0)
    for direction, color, ls in spec.directional:
        s.add_directional_light(direction, color=color, ls=ls)
    for m in spec.materials:
        s.add_material(albedo=m["albedo"], roughness=m["roughness"], metallic=m["metallic"],
                       fresnel=m.get("fresnel", (0.04, 0.04, 0.04)))
    for m in spec.meshes:
        s.add_mesh(m["positions"], m["indices"], normals=m["normals"], uvs=m["uvs"],
                   material_id=m["material"])
    return s


def program_camera(cam: dict, width: int, height: int, device):
    """The port's CameraParams for the description's camera."""
    from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera

    pc = PerspectiveCamera(
        position=np.asarray(cam["position"], np.float64),
        target=np.asarray(cam["target"], np.float64),
        up=np.asarray(cam.get("up", (0.0, 1.0, 0.0)), np.float64),
        fov_deg=float(cam["fov_deg"]), aspect=width / height,
        z_near=float(cam.get("z_near", 0.1)), z_far=float(cam.get("z_far", 1000.0)))
    return pc.params(device)
