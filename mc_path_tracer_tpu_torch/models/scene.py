"""Scene: host-side assembly of flat arrays + BVH, moved to a device once
(port of mc_path_tracer_tpu/models/scene.py).

`Scene` keeps the JAX package's editing API: materials with texture ids,
textures, meshes, glTF loading (`load`), object transforms about the mesh
centroid (`set_transform`, `apply_transform`), directional lights, point-
light stubs and the environment.  Every edit calls `notify`, which bumps
`version` (progressive sessions restart on it); content edits also bump
`edit_version`, which keys the build cache.  `build(device)` bakes the
objects, builds the BVH, reorders the triangles into leaf order, turns the
triangles of emissive materials into the area light, packs the textures
into the atlas, and returns a `SceneData` of tensors on `device` (the card
unless device="cpu").  The light table is [environment, directionals...,
area?], and a default Color-mode environment always exists.  Everything
stays host numpy until `build(device)`.

`scene_data_from_arrays` takes a built scene flattened to numpy arrays by
dotted field path (see `scene_arrays`) and returns the port's SceneData, so
the port and the JAX package can compute on identical scene arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dataclass_field
from typing import NamedTuple

import numpy as np
import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mc_path_tracer_tpu_torch.models import lights as lights_mod
from mc_path_tracer_tpu_torch.models.materials import MaterialTable, make_material_table
from mc_path_tracer_tpu_torch.ops import envmap
from mc_path_tracer_tpu_torch.ops.bvh import build_bvh, collapse_wide
from mc_path_tracer_tpu_torch.ops.intersect import BVHArrays, TriangleSoA
from mc_path_tracer_tpu_torch.utils import native
from mc_path_tracer_tpu_torch.utils.gltf import load_gltf
from mc_path_tracer_tpu_torch.utils.image import load_hdr
from mc_path_tracer_tpu_torch.utils.mesh import compute_tangents, smooth_normals
from mc_path_tracer_tpu_torch.utils.profiling import span
from mc_path_tracer_tpu_torch.utils.texture import TextureAtlas, build_atlas, empty_atlas


class SceneData(NamedTuple):
    """Device scene: everything the integrator needs."""

    tris: TriangleSoA
    bvh: BVHArrays
    materials: MaterialTable
    lights: lights_mod.LightSet
    atlas: TextureAtlas | None = None  # None or empty: factor-only materials


def _mesh_to_soa(positions, normals, uvs, indices, material_id,
                 tangents=None) -> TriangleSoA:
    """Host triangle arrays (numpy) of one mesh, tangents included; `attrs`
    and `geo` are left to the BVH reorder."""
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
    return TriangleSoA(
        v0=v0, e1=e1.astype(np.float32), e2=e2.astype(np.float32),
        n0=n[idx[:, 0]], n1=n[idx[:, 1]], n2=n[idx[:, 2]],
        uv0=uv[idx[:, 0]], uv1=uv[idx[:, 1]], uv2=uv[idx[:, 2]],
        material_id=np.full(idx.shape[0], material_id, np.int32),
        face_normal=fn.astype(np.float32),
        tan0=tan[idx[:, 0]], tan1=tan[idx[:, 1]], tan2=tan[idx[:, 2]],
    )


def concat_soa(parts: list[TriangleSoA]) -> TriangleSoA:
    """Host triangle arrays of several meshes as one TriangleSoA of numpy
    arrays, in part order.  `attrs` and `geo` are left to the BVH reorder;
    tangents are kept only when every part has them."""
    fields = [f for f in TriangleSoA._fields if f not in ("attrs", "geo")]
    if any(p.tan0 is None for p in parts):
        fields = [f for f in fields if not f.startswith("tan")]
    return TriangleSoA(**{
        f: np.concatenate([np.asarray(getattr(p, f)) for p in parts], axis=0)
        for f in fields
    })


def _center_of_mass(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Centroid by signed tetrahedra: each face forms a tetrahedron with the
    origin; com = sum(V_f * c_f) / sum(V_f).  Open or degenerate meshes
    (|total volume| ~ 0) take the vertex mean."""
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    vol = np.einsum("ij,ij->i", v0, np.cross(v1, v2)) / 6.0
    total = vol.sum()
    if abs(total) < 1e-9:
        return positions.mean(axis=0).astype(np.float32)
    c = (v0 + v1 + v2) / 4.0
    return ((vol[:, None] * c).sum(axis=0) / total).astype(np.float32)


def _euler_matrix(rotation_deg) -> np.ndarray:
    """XYZ Euler angles in degrees -> rotation matrix Rz Ry Rx."""
    rx, ry, rz = np.radians(np.asarray(rotation_deg, np.float64))
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (mz @ my @ mx).astype(np.float32)


@dataclass
class ObjectEntry:
    """One render object: its source arrays and a TRS about the mesh
    centroid, baked lazily into host triangle arrays."""

    positions: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    indices: np.ndarray
    material_id: int
    tangents: np.ndarray | None = None
    name: str = ""
    translation: np.ndarray = dataclass_field(
        default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = dataclass_field(
        default_factory=lambda: np.eye(3, dtype=np.float32))
    scale: np.ndarray = dataclass_field(
        default_factory=lambda: np.ones(3, np.float32))
    _centroid: np.ndarray | None = None
    _baked: TriangleSoA | None = None

    @property
    def centroid(self) -> np.ndarray:
        if self._centroid is None:
            self._centroid = _center_of_mass(
                np.asarray(self.positions, np.float32),
                np.asarray(self.indices, np.int64),
            )
        return self._centroid

    def bake(self) -> TriangleSoA:
        """world = T + C + R S (v - C); normals by the inverse-transpose
        R S^-1, tangents by R S (w kept)."""
        if self._baked is not None:
            return self._baked
        r = np.asarray(self.rotation, np.float32)
        s = np.asarray(self.scale, np.float32)
        c = self.centroid
        t = np.asarray(self.translation, np.float32)
        p = np.asarray(self.positions, np.float32)
        n = np.asarray(self.normals, np.float32)
        identity = (np.allclose(r, np.eye(3)) and np.allclose(s, 1.0)
                    and np.allclose(t, 0.0))
        if identity:
            pw, nw, tanw = p, n, self.tangents
        else:
            pw = (p - c) * s @ r.T + c + t
            nw = (n / np.maximum(s, 1e-12)) @ r.T
            nw = nw / np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-12)
            tanw = self.tangents
            if tanw is not None:
                txyz = (np.asarray(tanw, np.float32)[:, :3] * s) @ r.T
                tl = np.linalg.norm(txyz, axis=-1, keepdims=True)
                txyz = txyz / np.maximum(tl, 1e-12)
                tanw = np.concatenate([txyz, np.asarray(tanw, np.float32)[:, 3:4]], axis=1)
        self._baked = _mesh_to_soa(pw.astype(np.float32), nw.astype(np.float32), self.uvs,
                                   self.indices, self.material_id, tangents=tanw)
        return self._baked


@dataclass
class Scene:
    """Mutable host scene; `build(device)` compiles it to a SceneData."""

    objects: list[ObjectEntry] = dataclass_field(default_factory=list)
    material_albedo: list = dataclass_field(default_factory=list)
    material_roughness: list = dataclass_field(default_factory=list)
    material_metallic: list = dataclass_field(default_factory=list)
    material_emissive: list = dataclass_field(default_factory=list)
    material_fresnel: list = dataclass_field(default_factory=list)
    material_albedo_tex: list = dataclass_field(default_factory=list)
    material_mr_tex: list = dataclass_field(default_factory=list)
    material_emissive_tex: list = dataclass_field(default_factory=list)
    material_normal_tex: list = dataclass_field(default_factory=list)
    material_ao_tex: list = dataclass_field(default_factory=list)
    textures: list = dataclass_field(default_factory=list)  # linear f32 [H, W, 3]
    env_tex: np.ndarray | None = None     # HDRI [H, W, 3]; None = Color mode
    env_color: tuple = (1.0, 1.0, 1.0)
    env_ls: float = 1.0
    directional: list = dataclass_field(default_factory=list)  # (dir, color, ls)
    point_lights: list = dataclass_field(default_factory=list)  # parity stubs
    bvh_method: int = native.SAH
    max_leaf: int = 4
    version: int = 0        # bumped by every notify (progressive restart)
    edit_version: int = 0   # bumped by content edits (invalidates the build)
    builder: str | None = None  # "native" or "numpy" after build()
    _build_cache: tuple | None = dataclass_field(default=None, repr=False)

    # -- editing API: each edit notifies -----------------------------------

    def notify(self, content: bool = True) -> None:
        """Bump `version` (progressive sessions restart on it).  Content
        edits, the default, also bump `edit_version` and drop the built
        SceneData; camera-only observers pass content=False."""
        self.version += 1
        if content:
            self.edit_version += 1
            self._build_cache = None

    def add_texture(self, image) -> int:
        """Register a linear float [H, W, 3] texture; returns its atlas id."""
        self.textures.append(np.asarray(image, np.float32)[..., :3])
        self.notify()
        return len(self.textures) - 1

    def add_material(self, albedo=(1, 1, 1), roughness=1.0, metallic=0.0,
                     emissive=(0, 0, 0), fresnel=(0.04, 0.04, 0.04),
                     albedo_tex=-1, mr_tex=-1, emissive_tex=-1, normal_tex=-1,
                     ao_tex=-1) -> int:
        self.material_albedo.append(np.asarray(albedo, np.float32)[:3])
        self.material_roughness.append(float(roughness))
        self.material_metallic.append(float(metallic))
        self.material_emissive.append(np.asarray(emissive, np.float32)[:3])
        self.material_fresnel.append(np.asarray(fresnel, np.float32)[:3])
        self.material_albedo_tex.append(int(albedo_tex))
        self.material_mr_tex.append(int(mr_tex))
        self.material_emissive_tex.append(int(emissive_tex))
        self.material_normal_tex.append(int(normal_tex))
        self.material_ao_tex.append(int(ao_tex))
        self.notify()
        return len(self.material_albedo) - 1

    def add_mesh(self, positions, indices, normals=None, uvs=None,
                 material_id=0, tangents=None) -> int:
        positions = np.asarray(positions, np.float32)
        indices = np.asarray(indices)
        if normals is None:
            normals = smooth_normals(positions, np.asarray(indices, np.int64))
        if uvs is None:
            uvs = np.zeros((positions.shape[0], 2), np.float32)
        self.objects.append(ObjectEntry(
            positions=positions, normals=np.asarray(normals, np.float32),
            uvs=np.asarray(uvs, np.float32), indices=indices,
            material_id=material_id, tangents=tangents,
        ))
        self.notify()
        return len(self.objects) - 1

    def load(self, path: str, reference_material_quirk: bool = False) -> "Scene":
        """Import a .glb baked to world space (utils/gltf.load_gltf); its
        textures and materials are appended to the scene's, its primitives
        become objects."""
        data = load_gltf(path, reference_material_quirk=reference_material_quirk)
        tex_base = len(self.textures)
        for tex in data.textures:
            self.add_texture(tex)

        def shift(t):
            return tex_base + t if t >= 0 else -1

        base = len(self.material_albedo)
        for m in data.materials:
            self.add_material(
                albedo=m.base_color[:3], roughness=m.roughness, metallic=m.metallic,
                emissive=m.emissive, albedo_tex=shift(m.base_color_tex),
                mr_tex=shift(m.metallic_roughness_tex), emissive_tex=shift(m.emissive_tex),
                normal_tex=shift(m.normal_tex), ao_tex=shift(m.ao_tex),
            )
        for mesh in data.meshes:
            self.objects.append(ObjectEntry(
                positions=mesh.positions, normals=mesh.normals, uvs=mesh.uvs,
                indices=mesh.indices, material_id=base + mesh.material,
                tangents=mesh.tangents, name=mesh.name,
            ))
        self.notify()
        return self

    def set_environment_color(self, color=(1, 1, 1), ls=1.0):
        self.env_tex, self.env_color, self.env_ls = None, tuple(color), float(ls)
        self.notify()

    def set_environment_hdr(self, path_or_array, ls=1.0):
        """Equirect HDRI env from a .hdr path or a float [H, W, 3] array."""
        self.env_tex = (
            load_hdr(path_or_array) if isinstance(path_or_array, str)
            else np.asarray(path_or_array, np.float32)
        )
        self.env_ls = float(ls)
        self.notify()

    def add_directional_light(self, direction, color=(1, 1, 1), ls=1.0):
        self.directional.append((np.asarray(direction, np.float32),
                                 np.asarray(color, np.float32), float(ls)))
        self.notify()

    def set_transform(self, obj_id: int, translation=None, rotation_deg=None,
                      rotation=None, scale=None):
        """Set an object's absolute TRS about its centroid; the object is
        re-baked at the next build."""
        o = self.objects[obj_id]
        if translation is not None:
            o.translation = np.asarray(translation, np.float32)
        if rotation is not None:
            o.rotation = np.asarray(rotation, np.float32).reshape(3, 3)
        elif rotation_deg is not None:
            o.rotation = _euler_matrix(rotation_deg)
        if scale is not None:
            o.scale = np.broadcast_to(np.asarray(scale, np.float32).reshape(-1), (3,)).copy()
        o._baked = None
        self.notify()

    def apply_transform(self, obj_id: int, translation=(0, 0, 0),
                        rotation_deg=(0, 0, 0), scale=(1, 1, 1)):
        """Compose an incremental TRS onto the object's current one."""
        o = self.objects[obj_id]
        o.translation = o.translation + np.asarray(translation, np.float32)
        o.rotation = (_euler_matrix(rotation_deg) @ o.rotation).astype(np.float32)
        o.scale = o.scale * np.broadcast_to(np.asarray(scale, np.float32).reshape(-1), (3,))
        o._baked = None
        self.notify()

    def add_point_light(self, position, color=(1, 1, 1), ls=1.0):
        """Parity stub: stored, never illuminates (lights.PointLight)."""
        self.point_lights.append(lights_mod.PointLight(
            np.asarray(position, np.float32), np.asarray(color, np.float32), ls))
        self.notify()

    # -- compilation ---------------------------------------------------------

    def build(self, device=DEFAULT_DEVICE) -> SceneData:
        """The SceneData on `device`; cached until the next content edit
        (keyed by edit_version and device)."""
        device = resolve_device(device)
        cache = self._build_cache
        if cache is not None and cache[0] == self.edit_version and cache[1] == device:
            return cache[2]
        if not self.objects:
            raise ValueError("Scene has no geometry")
        if not self.material_albedo:
            self.add_material()
        with span("mcpt::scene.build", keep=True):
            bvh, tris, builder = build_bvh(
                concat_soa([o.bake() for o in self.objects])._asdict(),
                max_leaf=self.max_leaf, method=self.bvh_method, device=device,
            )
            self.builder = builder
            with span("mcpt::scene.env", keep=True):
                if self.env_tex is not None:
                    env = lights_mod.make_env_hdri(self.env_tex, self.env_ls, device)
                else:
                    env = lights_mod.make_env_color(self.env_color, self.env_ls, device)
            with span("mcpt::scene.upload", keep=True):
                materials = make_material_table(
                    np.stack(self.material_albedo),
                    np.asarray(self.material_roughness, np.float32),
                    np.asarray(self.material_metallic, np.float32),
                    fresnel=np.stack(self.material_fresnel),
                    emissive=np.stack(self.material_emissive),
                    device=device,
                    albedo_tex=np.asarray(self.material_albedo_tex, np.int32),
                    mr_tex=np.asarray(self.material_mr_tex, np.int32),
                    emissive_tex=np.asarray(self.material_emissive_tex, np.int32),
                    normal_tex=np.asarray(self.material_normal_tex, np.int32),
                    ao_tex=np.asarray(self.material_ao_tex, np.int32),
                )
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
                atlas = build_atlas(self.textures, device)
        data = SceneData(tris=tris, bvh=bvh, materials=materials,
                         lights=lights_mod.LightSet(env=env, directional=dl, area=area),
                         atlas=atlas)
        self._build_cache = (self.edit_version, device, data)
        return data


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
    arrays; the texture atlas is carried (empty when absent)."""
    device = resolve_device(device)

    def get(key):
        return torch.tensor(arrays[key], device=device)

    def opt(key):
        return get(key) if key in arrays else None

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
    atlas = (TextureAtlas(data=get("atlas.data").to(torch.float32),
                          sizes=get("atlas.sizes").to(torch.int32))
             if "atlas.data" in arrays else empty_atlas(device))
    return SceneData(tris=tris, bvh=bvh, materials=materials,
                     lights=lights_mod.LightSet(env=env, directional=dl, area=area),
                     atlas=atlas)
