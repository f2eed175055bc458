"""Dependency-free glTF 2.0 binary (.glb) loader (port of
mc_path_tracer_tpu/utils/gltf.py).

  - Recursive node walk accumulating transforms; vertices are baked to
    world space at load (positions by the accumulated matrix, normals by
    its inverse-transpose, TANGENT xyz by the matrix).
  - Triangle primitives only (mode 4); smooth normals where NORMAL is
    absent; tangents computed from UV gradients where TANGENT is absent
    (`compute_tangents`, which lives in utils/mesh and is importable from
    here, as in the JAX package).
  - UV v-flip.
  - PBR metallic-roughness materials with their five texture slots;
    `reference_material_quirk` overrides roughness / metallic to 1 / 0.
  - Embedded PNG and JPEG images are decoded by `utils.image.read_png` and
    `utils.jpeg.read_jpeg` (no PIL) to what PIL's convert("RGB") gives,
    then to linear float [H, W, 3]; sRGB slots (base colour, emissive) are
    linearised.  A texture is decoded once per (image, sRGB) pair.

Returns plain numpy arrays; `models.scene.Scene.load` turns them into
scene objects.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field

import numpy as np

from mc_path_tracer_tpu_torch.utils.image import PNG_SIGNATURE, read_png
from mc_path_tracer_tpu_torch.utils.jpeg import JPEG_SIGNATURE, read_jpeg
from mc_path_tracer_tpu_torch.utils.mesh import compute_tangents, smooth_normals

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclass
class MeshData:
    """One primitive, baked to world space."""

    positions: np.ndarray  # [V, 3] f32 world space
    normals: np.ndarray    # [V, 3] f32 world space (normalized)
    uvs: np.ndarray        # [V, 2] f32 (v flipped)
    indices: np.ndarray    # [F, 3] uint32
    material: int          # index into GLTFScene.materials
    name: str = ""
    tangents: np.ndarray | None = None  # [V, 4] f32 world xyz + handedness w


@dataclass
class MaterialData:
    base_color: np.ndarray                   # [4] f32
    emissive: np.ndarray                     # [3] f32
    metallic: float
    roughness: float
    name: str = ""
    base_color_tex: int = -1                 # indices into GLTFScene.textures
    metallic_roughness_tex: int = -1
    emissive_tex: int = -1
    normal_tex: int = -1                     # tangent-space normal map
    ao_tex: int = -1                         # ambient-occlusion map


@dataclass
class GLTFScene:
    meshes: list[MeshData] = field(default_factory=list)
    materials: list[MaterialData] = field(default_factory=list)
    textures: list[np.ndarray] = field(default_factory=list)  # linear f32 [H,W,3]


def _read_glb(path: str) -> tuple[dict, bytes]:
    with open(path, "rb") as f:
        data = f.read()
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError(f"{path}: not a GLB file")
    if version != 2:
        raise ValueError(f"{path}: unsupported GLB version {version}")
    offset = 12
    gltf_json, binary = None, b""
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset : offset + chunk_len]
        offset += chunk_len
        if chunk_type == 0x4E4F534A:  # 'JSON'
            gltf_json = json.loads(chunk.decode("utf-8"))
        elif chunk_type == 0x004E4942:  # 'BIN'
            binary = chunk
    if gltf_json is None:
        raise ValueError(f"{path}: GLB missing JSON chunk")
    return gltf_json, binary


def _accessor(gltf: dict, binary: bytes, idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride and stride != itemsize:
        raw = np.frombuffer(binary, np.uint8, count * stride, start)
        raw = raw.reshape(count, stride)[:, :itemsize]
        arr = raw.reshape(-1).view(dtype).reshape(count, ncomp)
    else:
        arr = np.frombuffer(binary, dtype, count * ncomp, start).reshape(count, ncomp)
    return np.array(arr)


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], np.float32).reshape(4, 4).T  # column-major
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = np.diag(list(node["scale"]) + [1.0]).astype(np.float32) @ m
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
                [0, 0, 0, 1],
            ],
            np.float32,
        )
        m = r @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _to_rgb(img: np.ndarray) -> np.ndarray:
    """[H, W, C] of read_png as uint8 [H, W, 3], as PIL's convert("RGB"):
    grey replicated, alpha dropped; 16-bit samples keep their high byte,
    except 16-bit grey, which PIL opens as mode I;16 and clips to 255."""
    if img.dtype == np.uint16:
        img = np.minimum(img, 255) if img.shape[-1] == 1 else img >> 8
        img = img.astype(np.uint8)
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def _decode_image(gltf: dict, binary: bytes, image_idx: int, srgb: bool):
    """Decode an embedded glTF image (a PNG or JPEG in a bufferView) to
    linear float32 [H, W, 3]; None for an image outside the binary chunk."""
    img = gltf["images"][image_idx]
    if "bufferView" not in img:
        return None
    view = gltf["bufferViews"][img["bufferView"]]
    start = view.get("byteOffset", 0)
    raw = binary[start : start + view["byteLength"]]
    name = f"image {image_idx} ({img.get('name') or img.get('mimeType', 'no type')})"
    if raw.startswith(PNG_SIGNATURE):
        arr = _to_rgb(read_png(raw, name))
    elif raw.startswith(JPEG_SIGNATURE):
        arr = read_jpeg(raw, name)
    else:
        raise ValueError(f"{name}: {img.get('mimeType', 'unknown')} image: the port decodes "
                         "PNG and JPEG, the glTF core formats")
    arr = arr.astype(np.float32) / 255.0
    if srgb:
        arr = _srgb_to_linear(arr).astype(np.float32)
    return arr


def load_gltf(path: str, reference_material_quirk: bool = False,
              load_textures: bool = True) -> GLTFScene:
    """Load a .glb file into world-space baked mesh + material lists."""
    gltf, binary = _read_glb(path)
    out = GLTFScene()

    tex_cache: dict[tuple[int, bool], int] = {}

    def texture_id(tex_index: int | None, srgb: bool) -> int:
        if not load_textures or tex_index is None:
            return -1
        src = gltf["textures"][tex_index].get("source")
        if src is None:
            return -1
        key = (src, srgb)
        if key not in tex_cache:
            arr = _decode_image(gltf, binary, src, srgb)
            if arr is None:
                return -1
            out.textures.append(arr)
            tex_cache[key] = len(out.textures) - 1
        return tex_cache[key]

    # a file without a "materials" key gets one material of glTF defaults
    # (metallic 1); an empty list gets the "default" material below
    for mat in gltf.get("materials", [{}]):
        pbr = mat.get("pbrMetallicRoughness", {})
        rough = float(pbr.get("roughnessFactor", 1.0))
        metal = float(pbr.get("metallicFactor", 1.0))
        if reference_material_quirk:
            rough, metal = 1.0, 0.0
        out.materials.append(
            MaterialData(
                base_color=np.array(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32),
                emissive=np.array(mat.get("emissiveFactor", [0, 0, 0]), np.float32),
                metallic=metal,
                roughness=rough,
                name=mat.get("name", ""),
                base_color_tex=texture_id(
                    pbr.get("baseColorTexture", {}).get("index"), srgb=True),
                metallic_roughness_tex=texture_id(
                    pbr.get("metallicRoughnessTexture", {}).get("index"), srgb=False),
                emissive_tex=texture_id(
                    mat.get("emissiveTexture", {}).get("index"), srgb=True),
                normal_tex=texture_id(
                    mat.get("normalTexture", {}).get("index"), srgb=False),
                ao_tex=texture_id(
                    mat.get("occlusionTexture", {}).get("index"), srgb=False),
            )
        )
    if not out.materials:
        out.materials.append(
            MaterialData(
                base_color=np.array([1, 1, 1, 1], np.float32),
                emissive=np.zeros(3, np.float32),
                metallic=0.0,
                roughness=1.0,
                name="default",
            )
        )

    scene_idx = gltf.get("scene", 0)
    roots = gltf.get("scenes", [{"nodes": list(range(len(gltf.get("nodes", []))))}])[
        scene_idx
    ].get("nodes", [])

    def walk(node_idx: int, parent: np.ndarray):
        node = gltf["nodes"][node_idx]
        acc = parent @ _node_matrix(node)
        if "mesh" in node:
            mesh = gltf["meshes"][node["mesh"]]
            for prim in mesh.get("primitives", []):
                if prim.get("mode", 4) != 4:
                    continue  # triangles only
                attrs = prim["attributes"]
                pos = _accessor(gltf, binary, attrs["POSITION"]).astype(np.float32)
                if "indices" in prim:
                    idx = _accessor(gltf, binary, prim["indices"]).reshape(-1, 3)
                    idx = idx.astype(np.uint32)
                else:
                    idx = np.arange(len(pos), dtype=np.uint32).reshape(-1, 3)
                pos_w = (acc[:3, :3] @ pos.T).T + acc[:3, 3]
                nrm_mat = np.linalg.inv(acc[:3, :3]).T
                if "NORMAL" in attrs:
                    nrm = _accessor(gltf, binary, attrs["NORMAL"]).astype(np.float32)
                    nrm_w = (nrm_mat @ nrm.T).T
                    nl = np.linalg.norm(nrm_w, axis=-1, keepdims=True)
                    nrm_w = nrm_w / np.maximum(nl, 1e-12)
                else:
                    nrm_w = smooth_normals(pos_w.astype(np.float32), idx)
                if "TEXCOORD_0" in attrs:
                    uv = _accessor(gltf, binary, attrs["TEXCOORD_0"]).astype(np.float32)
                    uv = uv.copy()
                    uv[:, 1] = 1.0 - uv[:, 1]  # v flip
                else:
                    uv = np.zeros((len(pos), 2), np.float32)
                if "TANGENT" in attrs:
                    # vec4: xyz baked to world by the node matrix, w kept
                    tan = _accessor(gltf, binary, attrs["TANGENT"]).astype(np.float32)
                    txyz = (acc[:3, :3] @ tan[:, :3].T).T
                    tl = np.linalg.norm(txyz, axis=-1, keepdims=True)
                    txyz = txyz / np.maximum(tl, 1e-12)
                    tan_w = np.concatenate([txyz, tan[:, 3:4]], axis=1).astype(np.float32)
                else:
                    tan_w = compute_tangents(
                        pos_w.astype(np.float32), nrm_w.astype(np.float32),
                        uv, idx.astype(np.int64),
                    )
                out.meshes.append(
                    MeshData(
                        positions=pos_w.astype(np.float32),
                        normals=nrm_w.astype(np.float32),
                        uvs=uv,
                        indices=idx,
                        material=int(prim.get("material", 0)),
                        name=mesh.get("name", node.get("name", "")),
                        tangents=tan_w,
                    )
                )
        for child in node.get("children", []):
            walk(child, acc)

    for r in roots:
        walk(r, np.eye(4, dtype=np.float32))
    return out
