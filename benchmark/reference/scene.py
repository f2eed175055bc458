"""The reference's own scene, worked out again from the benchmark's scene
description (harness.scene.SceneSpec: meshes, materials, environment
texels, directional lights): triangle arrays in object order with each
object's box, the material table, the environment's CDF and the
directional lights.  It takes nothing the program built."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import core

BOX_PAD = 1e-3   # relative padding of the culling boxes


class RefScene(NamedTuple):
    tris: core.Triangles
    albedo: torch.Tensor     # [M, 3]
    roughness: torch.Tensor  # [M]
    metallic: torch.Tensor   # [M]
    fresnel: torch.Tensor    # [M, 3]
    env_tex: torch.Tensor    # [H, W, 3]
    env_dist: core.EnvDist
    dir_dir: torch.Tensor    # [D, 3] unit, toward the light
    dir_color: torch.Tensor  # [D, 3]
    dir_ls: torch.Tensor     # [D]

    def material(self, ids) -> core.Material:
        return core.Material(self.albedo[ids], self.roughness[ids], self.metallic[ids],
                             self.fresnel[ids])

    def with_materials(self, albedo, roughness, metallic) -> "RefScene":
        return self._replace(albedo=albedo, roughness=roughness, metallic=metallic)


def build(spec, device) -> RefScene:
    parts = {k: [] for k in ("v0", "e1", "e2", "n0", "n1", "n2", "mat")}
    ranges, lo, hi, first = [], [], [], 0
    for m in spec.meshes:
        p = np.asarray(m["positions"], np.float32)
        n = np.asarray(m["normals"], np.float32)
        idx = np.asarray(m["indices"], np.int64)
        v0, v1, v2 = p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]
        parts["v0"].append(v0)
        parts["e1"].append((v1 - v0).astype(np.float32))
        parts["e2"].append((v2 - v0).astype(np.float32))
        for k in range(3):
            parts[f"n{k}"].append(n[idx[:, k]])
        parts["mat"].append(np.full(idx.shape[0], m["material"], np.int64))
        corners = p[idx.reshape(-1)]
        b_lo, b_hi = corners.min(axis=0), corners.max(axis=0)
        pad = BOX_PAD * (1.0 + np.maximum(np.abs(b_lo), np.abs(b_hi)))
        lo.append(b_lo - pad)
        hi.append(b_hi + pad)
        ranges.append((first, first + idx.shape[0]))
        first += idx.shape[0]

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    cat = {k: np.concatenate(v, axis=0) for k, v in parts.items()}
    tris = core.Triangles(
        v0=dev(cat["v0"]), e1=dev(cat["e1"]), e2=dev(cat["e2"]),
        n0=dev(cat["n0"]), n1=dev(cat["n1"]), n2=dev(cat["n2"]),
        material=dev(cat["mat"], torch.int64), ranges=tuple(ranges),
        box_lo=dev(np.stack(lo)), box_hi=dev(np.stack(hi)))
    mats = spec.materials
    if spec.directional:
        d = np.stack([np.asarray(x[0], np.float32) for x in spec.directional])
        d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        color = np.stack([np.asarray(x[1], np.float32) for x in spec.directional])
        ls = np.asarray([x[2] for x in spec.directional], np.float32)
    else:
        d, color, ls = np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0)
    env = np.asarray(spec.env, np.float32)
    return RefScene(
        tris=tris,
        albedo=dev([m["albedo"] for m in mats]),
        roughness=dev([m["roughness"] for m in mats]),
        metallic=dev([m["metallic"] for m in mats]),
        fresnel=dev([m.get("fresnel", (0.04, 0.04, 0.04)) for m in mats]),
        env_tex=dev(env), env_dist=core.env_distribution(env, device),
        dir_dir=dev(d), dir_color=dev(color), dir_ls=dev(ls))


def camera(spec, width: int, height: int, device, cam: dict | None = None) -> core.Camera:
    c = spec.camera if cam is None else cam
    return core.camera(c["position"], c["target"], c.get("up", (0.0, 1.0, 0.0)),
                       c["fov_deg"], c.get("z_near", 0.1), c.get("z_far", 1000.0),
                       width, height, device)
