"""Scene: host-side assembly of flat arrays + BVH, moved to a device once
(port of mc_path_tracer_tpu/models/scene.py).

`Scene` keeps the JAX package's editing calls for meshes, untextured
materials, directional lights and the environment; `build(device)` bakes
the meshes, builds the BVH, reorders the triangles into leaf order, turns
the triangles of emissive materials into the area light, and returns a
`SceneData` of tensors on `device` (the card unless device="cpu").  The
light table is [environment, directionals..., area?], and a default
Color-mode environment always exists.

`scene_data_from_arrays` takes a built scene flattened to numpy arrays by
dotted field path (see `scene_arrays`) and returns the port's SceneData, so
the port and the JAX package can compute on identical scene arrays.

Not ported yet (ROADMAP Queue 1): textures, object transforms and glTF
loading.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dataclass_field
from typing import NamedTuple

import numpy as np
import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mc_path_tracer_tpu_torch.models import lights as lights_mod
from mc_path_tracer_tpu_torch.models.materials import (
    TEXTURE_FIELDS,
    MaterialTable,
    make_material_table,
)
from mc_path_tracer_tpu_torch.ops import envmap
from mc_path_tracer_tpu_torch.ops.bvh import build_bvh, collapse_wide
from mc_path_tracer_tpu_torch.ops.intersect import BVHArrays, TriangleSoA
from mc_path_tracer_tpu_torch.utils import native
from mc_path_tracer_tpu_torch.utils.image import load_hdr
from mc_path_tracer_tpu_torch.utils.mesh import compute_tangents, smooth_normals

TEXTURES_TODO = "textured materials are not ported yet: ROADMAP Queue 1, textures"


class SceneData(NamedTuple):
    """Device scene: everything the integrator needs."""

    tris: TriangleSoA
    bvh: BVHArrays
    materials: MaterialTable
    lights: lights_mod.LightSet


def _mesh_to_soa(positions, normals, uvs, indices, material_id, tangents=None):
    """Host triangle arrays of one mesh (keys of TriangleSoA + tan0..2)."""
    p = np.asarray(positions, np.float32)
    n = np.asarray(normals, np.float32)
    uv = np.asarray(uvs, np.float32)
    idx = np.asarray(indices, np.int64)
    if tangents is None:
        tangents = compute_tangents(p, n, uv, idx)
    tan = np.asarray(tangents, np.float32)
    v0, v1, v2 = p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]
    e1, e2 = v1 - v0, v2 - v0
    fn = np.cross(e1, e2)
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    return {
        "v0": v0, "e1": e1.astype(np.float32), "e2": e2.astype(np.float32),
        "n0": n[idx[:, 0]], "n1": n[idx[:, 1]], "n2": n[idx[:, 2]],
        "uv0": uv[idx[:, 0]], "uv1": uv[idx[:, 1]], "uv2": uv[idx[:, 2]],
        "material_id": np.full(idx.shape[0], material_id, np.int32),
        "face_normal": fn.astype(np.float32),
        "tan0": tan[idx[:, 0]], "tan1": tan[idx[:, 1]], "tan2": tan[idx[:, 2]],
    }


def _concat(parts: list[dict]) -> dict:
    return {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}


@dataclass
class Scene:
    """Mutable host scene; `build(device)` compiles it to a SceneData."""

    meshes: list = dataclass_field(default_factory=list)
    material_albedo: list = dataclass_field(default_factory=list)
    material_roughness: list = dataclass_field(default_factory=list)
    material_metallic: list = dataclass_field(default_factory=list)
    material_emissive: list = dataclass_field(default_factory=list)
    material_fresnel: list = dataclass_field(default_factory=list)
    env_tex: np.ndarray | None = None     # HDRI [H, W, 3]; None = Color mode
    env_color: tuple = (1.0, 1.0, 1.0)
    env_ls: float = 1.0
    directional: list = dataclass_field(default_factory=list)  # (dir, color, ls)
    bvh_method: int = native.SAH
    max_leaf: int = 4
    builder: str | None = None  # "native" or "numpy" after build()

    def add_material(self, albedo=(1, 1, 1), roughness=1.0, metallic=0.0,
                     emissive=(0, 0, 0), fresnel=(0.04, 0.04, 0.04)) -> int:
        self.material_albedo.append(np.asarray(albedo, np.float32)[:3])
        self.material_roughness.append(float(roughness))
        self.material_metallic.append(float(metallic))
        self.material_emissive.append(np.asarray(emissive, np.float32)[:3])
        self.material_fresnel.append(np.asarray(fresnel, np.float32)[:3])
        return len(self.material_albedo) - 1

    def add_mesh(self, positions, indices, normals=None, uvs=None,
                 material_id=0, tangents=None) -> int:
        positions = np.asarray(positions, np.float32)
        indices = np.asarray(indices)
        if normals is None:
            normals = smooth_normals(positions, np.asarray(indices, np.int64))
        if uvs is None:
            uvs = np.zeros((positions.shape[0], 2), np.float32)
        self.meshes.append((positions, np.asarray(normals, np.float32),
                            np.asarray(uvs, np.float32), indices, material_id,
                            tangents))
        return len(self.meshes) - 1

    def set_environment_color(self, color=(1, 1, 1), ls=1.0):
        self.env_tex, self.env_color, self.env_ls = None, tuple(color), float(ls)

    def set_environment_hdr(self, path_or_array, ls=1.0):
        """Equirect HDRI env from a .hdr path or a float [H, W, 3] array."""
        self.env_tex = (
            load_hdr(path_or_array) if isinstance(path_or_array, str)
            else np.asarray(path_or_array, np.float32)
        )
        self.env_ls = float(ls)

    def add_directional_light(self, direction, color=(1, 1, 1), ls=1.0):
        self.directional.append((np.asarray(direction, np.float32),
                                 np.asarray(color, np.float32), float(ls)))

    def build(self, device=DEFAULT_DEVICE) -> SceneData:
        if not self.meshes:
            raise ValueError("Scene has no geometry")
        device = resolve_device(device)
        if not self.material_albedo:
            self.add_material()
        bvh, tris, builder = build_bvh(
            _concat([_mesh_to_soa(*m) for m in self.meshes]),
            max_leaf=self.max_leaf, method=self.bvh_method, device=device,
        )
        self.builder = builder
        materials = make_material_table(
            np.stack(self.material_albedo),
            np.asarray(self.material_roughness, np.float32),
            np.asarray(self.material_metallic, np.float32),
            fresnel=np.stack(self.material_fresnel),
            emissive=np.stack(self.material_emissive),
            device=device,
        )
        if self.env_tex is not None:
            env = lights_mod.make_env_hdri(self.env_tex, self.env_ls, device)
        else:
            env = lights_mod.make_env_color(self.env_color, self.env_ls, device)
        if self.directional:
            dl = lights_mod.make_directional(
                np.stack([d for d, _, _ in self.directional]),
                np.stack([c for _, c, _ in self.directional]),
                np.asarray([s for _, _, s in self.directional], np.float32),
                device,
            )
        else:
            dl = lights_mod.empty_directional(device)
        # emissive triangles -> the area light, indexed in leaf order
        tri_emission = np.stack(self.material_emissive)[tris.material_id.cpu().numpy()]
        area = lights_mod.make_area_lights(
            tris, tri_emission.sum(axis=-1) > 0.0, tri_emission, device)
        return SceneData(tris=tris, bvh=bvh, materials=materials,
                         lights=lights_mod.LightSet(env=env, directional=dl, area=area))


def scene_arrays(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten a nested NamedTuple of arrays (a SceneData of either
    package) to {dotted field path: numpy array}; None leaves are left out."""
    out: dict[str, np.ndarray] = {}
    for name, value in zip(tree._fields, tree):
        key = f"{prefix}{name}"
        if value is None:
            continue
        if hasattr(value, "_fields"):
            out.update(scene_arrays(value, key + "."))
        elif isinstance(value, torch.Tensor):
            out[key] = value.detach().cpu().numpy()
        else:
            out[key] = np.asarray(value)
    return out


def scene_data_from_arrays(arrays: dict[str, np.ndarray],
                          device=DEFAULT_DEVICE) -> SceneData:
    """SceneData on `device` from a built scene flattened by scene_arrays.
    Fields the port has no use for (the TPU layouts `wide` and `leaf`) are
    ignored; the port's own 4-wide table is collapsed from the binary BVH
    arrays; a scene with textures is refused."""
    device = resolve_device(device)

    def get(key):
        return torch.tensor(arrays[key], device=device)

    def opt(key):
        return get(key) if key in arrays else None

    if any((arrays[f"materials.{f}"] >= 0).any() for f in TEXTURE_FIELDS
           if f"materials.{f}" in arrays):
        raise NotImplementedError(TEXTURES_TODO)

    tris = TriangleSoA(
        **{f: get(f"tris.{f}") for f in TriangleSoA._fields
           if f not in ("attrs", "tan0", "tan1", "tan2", "geo")},
        attrs=get("tris.attrs"),
        tan0=opt("tris.tan0"), tan1=opt("tris.tan1"), tan2=opt("tris.tan2"),
        geo=torch.cat([get("tris.v0"), get("tris.e1"), get("tris.e2")], dim=1)
        .to(torch.float32).contiguous(),
    )
    binary = ("bmin", "bmax", "first", "count", "skip")
    wide, depth = collapse_wide(*(arrays[f"bvh.{f}"] for f in binary))
    bvh = BVHArrays(**{f: get(f"bvh.{f}") for f in (*binary, "packed")},
                    wide=torch.from_numpy(wide).to(device), wide_depth=depth)
    materials = MaterialTable(**{f: get(f"materials.{f}") for f in MaterialTable._fields})
    env = lights_mod.EnvLight(
        color=get("lights.env.color"),
        ls=get("lights.env.ls"),
        tex=get("lights.env.tex"),
        dist=envmap.EnvMapDistribution(
            **{f: get(f"lights.env.dist.{f}") for f in envmap.EnvMapDistribution._fields}
        ),
    )
    dl = lights_mod.DirectionalLights(
        **{f: get(f"lights.directional.{f}") for f in lights_mod.DirectionalLights._fields}
    )
    area = (
        lights_mod.AreaLights(
            **{f: get(f"lights.area.{f}") for f in lights_mod.AreaLights._fields})
        if "lights.area.tri_idx" in arrays else lights_mod.empty_area(device)
    )
    return SceneData(tris=tris, bvh=bvh, materials=materials,
                     lights=lights_mod.LightSet(env=env, directional=dl, area=area))
