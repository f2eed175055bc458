"""Material table: flat [M]-indexed material factors (port of
mc_path_tracer_tpu/models/materials.py, untextured materials only).

Texture bindings are carried so a scene can say it has them; textured
shading is not ported yet (ROADMAP Queue 1) and the scene build refuses it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mc_path_tracer_tpu_torch.ops.brdf import MaterialParams

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

    def gather(self, material_id: torch.Tensor) -> MaterialParams:
        """Per-ray material parameters: one row gather from the [M, 8]
        concatenation of the factors (built per call, so autograd reaches
        the factor tensors)."""
        packed = torch.cat(
            [self.albedo, self.roughness[:, None], self.metallic[:, None], self.fresnel],
            dim=1,
        )
        row = packed[material_id]
        return MaterialParams(
            albedo=row[..., 0:3],
            roughness=row[..., 3],
            metallic=row[..., 4],
            fresnel=row[..., 5:8],
        )

    def emission(self, material_id: torch.Tensor) -> torch.Tensor:
        return self.emissive[material_id]

    def perturb_normal(self, material_id, n: torch.Tensor) -> torch.Tensor:
        """Shading normal after normal mapping: untextured materials keep n."""
        return n


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
