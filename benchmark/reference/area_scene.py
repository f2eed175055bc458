"""The reference's own arrays for a scene lit by emitters, worked out again
from the benchmark's description (harness/area_scene.AreaSceneSpec):
the triangles and materials as reference/scene.py builds them, each
triangle's face normal and emission, the constant-colour environment,
and the area table, the emissive triangles with their areas and
selection CDF.

The area table's order is the one input taken from the program
(reference/area_frame.py says why): `order` lists the description's
indices of the emissive triangles in the order the program selects them.
`build` checks that it is a permutation of the description's own
emissive triangles and computes everything else from the description, in
float32 numpy in the port's order of operations (models/scene.py,
models/lights.make_area_lights), so that areas and CDF round alike.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import scene as ref_scene


class AreaRefScene(NamedTuple):
    base: ref_scene.RefScene   # triangles in description order, materials
    face_normal: torch.Tensor  # [T, 3] unit e1 x e2
    mat_emission: torch.Tensor  # [M, 3]
    emission_of: torch.Tensor  # [T, 3] each triangle's material's emission
    is_emissive: torch.Tensor  # [T] bool
    env: torch.Tensor          # [3] the environment's radiance, colour x ls
    emit_tri: torch.Tensor     # [E] int64 description indices, selection order
    emit_cdf: torch.Tensor     # [E] area-weighted CDF (ends at 1)
    total_area: torch.Tensor   # []


class _Surfaces(NamedTuple):
    """What reference/scene.build reads of a description, with a 1 x 1
    placeholder for the texels it expects (the environment here is a
    colour, kept in AreaRefScene.env)."""
    meshes: list
    materials: list
    env: np.ndarray
    directional: list


def build(spec, order, device) -> AreaRefScene:
    """The reference scene of the description `spec`, with the program's
    emitter order `order` (description triangle indices)."""
    if spec.directional or spec.env is not None:
        raise ValueError("the area reference handles a constant-colour environment and "
                         "area lights only")
    base = ref_scene.build(_Surfaces(spec.meshes, spec.materials,
                                     np.ones((1, 1, 3), np.float32), []), device)
    e1, e2, mat = [], [], []
    for m in spec.meshes:
        p = np.asarray(m["positions"], np.float32)
        idx = np.asarray(m["indices"], np.int64)
        e1.append(p[idx[:, 1]] - p[idx[:, 0]])
        e2.append(p[idx[:, 2]] - p[idx[:, 0]])
        mat.append(np.full(idx.shape[0], m["material"], np.int64))
    e1, e2, mat = np.concatenate(e1), np.concatenate(e2), np.concatenate(mat)
    fn = np.cross(e1, e2)
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    emission = np.asarray([m.get("emissive", (0.0, 0.0, 0.0)) for m in spec.materials],
                          np.float32)
    tri_emission = emission[mat]
    emissive = tri_emission.sum(axis=-1) > 0.0
    order = np.asarray(order, np.int64)
    if sorted(order.tolist()) != np.nonzero(emissive)[0].tolist():
        raise ValueError(f"the emitter order {order.tolist()} is not a permutation of the "
                         f"description's emissive triangles {np.nonzero(emissive)[0].tolist()}")
    area = 0.5 * np.linalg.norm(np.cross(e1[order], e2[order]), axis=-1)
    total = float(area.sum())
    cdf = np.cumsum(area) / max(total, 1e-20)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    env = dev(spec.env_color) * dev(spec.env_ls)
    return AreaRefScene(base=base, face_normal=dev(fn), mat_emission=dev(emission),
                        emission_of=dev(tri_emission), is_emissive=dev(emissive, torch.bool),
                        env=env, emit_tri=dev(order, torch.int64), emit_cdf=dev(cdf),
                        total_area=dev(total))
