"""The description of a scene lit by emitters (config2): harness/scene.py's
SceneSpec with an emission per material and a constant-colour
environment in place of HDR texels, the frozen box primitive, the port's
Scene built from it, and the one thing the plain reference takes from the
built program: the order of its emitter triangles.  Host numpy only.

The program picks an emitter triangle by a CDF over the emitters in its
BVH's leaf order (models/scene.Scene.build -> lights.make_area_lights),
which the reference cannot work out without building that BVH; so
`emitter_order` reads the order from the built scene's
`lights.area.tri_idx` and maps each entry back to the description's
triangle by its vertices.  The reference checks that it is a permutation
of its own emitters and computes areas, CDF, points and pdfs itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.harness.scene import SceneSpec


@dataclass
class AreaSceneSpec(SceneSpec):
    env_color: tuple = (1.0, 1.0, 1.0)   # the constant-colour environment (no texels)
    env_ls: float = 1.0

    def add_material(self, albedo, roughness, metallic=0.0, emissive=(0.0, 0.0, 0.0)) -> int:
        i = super().add_material(albedo, roughness, metallic)
        self.materials[i]["emissive"] = tuple(float(e) for e in emissive)
        return i


def box(size=(1, 1, 1), center=(0, 0, 0)):
    """Axis-aligned box with outward faces (per-face normals): a frozen
    copy of the port's models/primitives.box."""
    sx, sy, sz = [s / 2 for s in size]
    c = np.asarray(center, np.float32)
    faces = [
        ((1, 0, 0), [(sx, -sy, -sz), (sx, sy, -sz), (sx, sy, sz), (sx, -sy, sz)]),
        ((-1, 0, 0), [(-sx, -sy, sz), (-sx, sy, sz), (-sx, sy, -sz), (-sx, -sy, -sz)]),
        ((0, 1, 0), [(-sx, sy, -sz), (-sx, sy, sz), (sx, sy, sz), (sx, sy, -sz)]),
        ((0, -1, 0), [(-sx, -sy, sz), (-sx, -sy, -sz), (sx, -sy, -sz), (sx, -sy, sz)]),
        ((0, 0, 1), [(-sx, -sy, sz), (sx, -sy, sz), (sx, sy, sz), (-sx, sy, sz)]),
        ((0, 0, -1), [(sx, -sy, -sz), (-sx, -sy, -sz), (-sx, sy, -sz), (sx, sy, -sz)]),
    ]
    vs, ns, uvs, idx = [], [], [], []
    for n, corners in faces:
        base = len(vs)
        for k, p in enumerate(corners):
            vs.append(c + np.asarray(p, np.float32))
            ns.append(np.asarray(n, np.float32))
            uvs.append([float(k in (1, 2)), float(k in (2, 3))])
        idx.append([base, base + 1, base + 2])
        idx.append([base, base + 2, base + 3])
    return (np.asarray(vs, np.float32), np.asarray(ns, np.float32),
            np.asarray(uvs, np.float32), np.asarray(idx, np.int64))


def to_program(spec: AreaSceneSpec):
    """The port's host Scene holding the description, in its order."""
    from mc_path_tracer_tpu_torch.models.scene import Scene

    s = Scene()
    s.set_environment_color(spec.env_color, ls=spec.env_ls)
    for m in spec.materials:
        s.add_material(albedo=m["albedo"], roughness=m["roughness"], metallic=m["metallic"],
                       emissive=m["emissive"], fresnel=m.get("fresnel", (0.04, 0.04, 0.04)))
    for m in spec.meshes:
        s.add_mesh(m["positions"], m["indices"], normals=m["normals"], uvs=m["uvs"],
                   material_id=m["material"])
    return s


def triangle_rows(spec: SceneSpec) -> np.ndarray:
    """[T, 9] float32: each description triangle's v0, e1, e2 in mesh
    order, as the program and the reference compute them."""
    rows = []
    for m in spec.meshes:
        p = np.asarray(m["positions"], np.float32)
        idx = np.asarray(m["indices"], np.int64)
        v0, v1, v2 = p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]
        rows.append(np.concatenate([v0, v1 - v0, v2 - v0], axis=1))
    return np.concatenate(rows).astype(np.float32)


def emitter_order(sd, spec: SceneSpec) -> np.ndarray:
    """The description's indices [E] int64 of the program's emitter
    triangles in the order its area light selects them (module
    docstring): each of `sd.lights.area.tri_idx` matched to the one
    description triangle with the same v0, e1 and e2."""
    idx = sd.lights.area.tri_idx.long().cpu()
    built = np.concatenate([sd.tris.v0[idx].cpu().numpy(), sd.tris.e1[idx].cpu().numpy(),
                            sd.tris.e2[idx].cpu().numpy()], axis=1)
    rows = triangle_rows(spec)
    order = []
    for row in built:
        match = np.nonzero((rows == row).all(axis=1))[0]
        if match.size != 1:
            raise ValueError(f"emitter {row} matches {match.size} description triangles")
        order.append(int(match[0]))
    return np.asarray(order, np.int64)
