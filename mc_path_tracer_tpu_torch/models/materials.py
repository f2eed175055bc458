"""Material table: flat [M]-indexed material factors and texture bindings
(port of mc_path_tracer_tpu/models/materials.py).

Texture ids index the scene's TextureAtlas (utils/texture.py; -1 =
untextured slot, factor only).  `albedo_tex` modulates the base colour,
`mr_tex` holds glTF metallic-roughness (G = roughness, B = metallic),
`emissive_tex` modulates emission, `normal_tex` is a tangent-space normal
map and `ao_tex` an ambient-occlusion map (R channel).  Without an atlas,
or with an empty one, every call is the factor-only path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mc_path_tracer_tpu_torch.ops.brdf import MaterialParams
from mc_path_tracer_tpu_torch.utils.texture import TextureAtlas, sample_atlas

TEXTURE_FIELDS = ("albedo_tex", "mr_tex", "emissive_tex", "normal_tex", "ao_tex")


class MaterialTable(NamedTuple):
    albedo: torch.Tensor     # [M, 3] base color
    roughness: torch.Tensor  # [M]
    metallic: torch.Tensor   # [M]
    fresnel: torch.Tensor    # [M, 3] F0 (reference default 0.04)
    emissive: torch.Tensor   # [M, 3]
    albedo_tex: torch.Tensor    # [M] int32, -1 = untextured
    mr_tex: torch.Tensor        # [M] int32
    emissive_tex: torch.Tensor  # [M] int32
    normal_tex: torch.Tensor    # [M] int32
    ao_tex: torch.Tensor        # [M] int32

    @property
    def num_materials(self) -> int:
        return self.albedo.shape[0]

    def gather(self, material_id: torch.Tensor, uv=None,
               atlas: TextureAtlas | None = None) -> MaterialParams:
        """Per-ray material parameters, textured where `uv` and a non-empty
        `atlas` are given: one row gather from the [M, 8] concatenation of
        the factors (built per call, so autograd reaches the factor
        tensors), times the texture fetches."""
        packed = torch.cat(
            [self.albedo, self.roughness[:, None], self.metallic[:, None], self.fresnel],
            dim=1,
        )
        row = packed[material_id]
        albedo = row[..., 0:3]
        roughness = row[..., 3]
        metallic = row[..., 4]
        if _textured(uv, atlas):
            albedo = albedo * sample_atlas(atlas, self.albedo_tex[material_id], uv)
            mr = sample_atlas(atlas, self.mr_tex[material_id], uv)
            roughness = roughness * mr[..., 1]
            metallic = metallic * mr[..., 2]
        return MaterialParams(albedo=albedo, roughness=roughness, metallic=metallic,
                              fresnel=row[..., 5:8])

    def emission(self, material_id: torch.Tensor, uv=None,
                 atlas: TextureAtlas | None = None) -> torch.Tensor:
        e = self.emissive[material_id]
        if _textured(uv, atlas):
            e = e * sample_atlas(atlas, self.emissive_tex[material_id], uv)
        return e

    def perturb_normal(self, material_id, uv, atlas: TextureAtlas | None,
                       n: torch.Tensor, tangent, bitangent) -> torch.Tensor:
        """Shading normal after tangent-space normal mapping: the texel c
        (linear, [0, 1]) maps to v = 2c - 1 and the normal to
        normalize(T v.x + B v.y + N v.z).  Untextured materials keep n."""
        if atlas is None or atlas.count == 0:
            return n
        tid = self.normal_tex[material_id]
        v = 2.0 * sample_atlas(atlas, tid, uv) - 1.0
        perturbed = tangent * v[..., 0:1] + bitangent * v[..., 1:2] + n * v[..., 2:3]
        norm = torch.sqrt(torch.clamp(
            torch.sum(perturbed * perturbed, dim=-1, keepdim=True), min=1e-20))
        return torch.where((tid >= 0)[..., None], perturbed / norm, n)

    def ambient_occlusion(self, material_id, uv=None,
                          atlas: TextureAtlas | None = None) -> torch.Tensor:
        """AO factor: R channel of the occlusion texture, 1 untextured."""
        if not _textured(uv, atlas):
            return torch.ones(material_id.shape, dtype=torch.float32,
                              device=material_id.device)
        return sample_atlas(atlas, self.ao_tex[material_id], uv)[..., 0]


def _textured(uv, atlas) -> bool:
    return uv is not None and atlas is not None and atlas.count > 0


def make_material_table(albedo, roughness, metallic, fresnel=None, emissive=None,
                        device=DEFAULT_DEVICE, **tex) -> MaterialTable:
    """Table from host arrays; `tex` takes the TEXTURE_FIELDS id arrays."""
    unknown = set(tex) - set(TEXTURE_FIELDS)
    if unknown:
        raise TypeError(f"unknown texture fields {sorted(unknown)}")
    device = resolve_device(device)
    albedo_np = np.atleast_2d(np.asarray(albedo, np.float32))
    m = albedo_np.shape[0]

    def col(x, shape, fill):
        if x is None:
            return np.full(shape, fill, np.float32)
        return np.broadcast_to(np.asarray(x, np.float32), shape)

    def ids(t):
        if t is None:
            return np.full(m, -1, np.int32)
        return np.broadcast_to(np.asarray(t, np.int32), (m,))

    def dev(a):
        return torch.tensor(a, device=device)

    return MaterialTable(
        dev(albedo_np),
        dev(col(roughness, (m,), 1.0)),
        dev(col(metallic, (m,), 0.0)),
        dev(col(fresnel, (m, 3), 0.04)),
        dev(col(emissive, (m, 3), 0.0)),
        *(dev(ids(tex.get(name))) for name in TEXTURE_FIELDS),
    )


def default_material(device=DEFAULT_DEVICE) -> MaterialTable:
    """Reference defaults: white albedo, roughness 1, metallic 0, F0 0.04."""
    return make_material_table([[1.0, 1.0, 1.0]], 1.0, 0.0, device=device)
