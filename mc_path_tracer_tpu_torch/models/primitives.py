"""Procedural mesh primitives (port of mc_path_tracer_tpu/models/primitives.py).

Host numpy, identical arrays to the JAX package's: each returns
(positions [V,3] f32, normals [V,3] f32, uvs [V,2] f32, indices [F,3] i64)
for `Scene.add_mesh`.
"""

from __future__ import annotations

import numpy as np


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
    return (
        (c + radius * n).astype(np.float32),
        n,
        uv.astype(np.float32),
        idx.reshape(-1, 3).astype(np.int64),
    )


def box(size=(1, 1, 1), center=(0, 0, 0)):
    """Axis-aligned box with outward faces (per-face normals)."""
    sx, sy, sz = [s / 2 for s in size]
    c = np.asarray(center, np.float32)
    faces = [
        # (normal, corner offsets in CCW order seen from outside)
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
    return (
        np.asarray(vs, np.float32),
        np.asarray(ns, np.float32),
        np.asarray(uvs, np.float32),
        np.asarray(idx, np.int64),
    )


def plane(size=20.0, center=(0, 0, 0), normal_axis="y"):
    """Two-triangle quad facing +axis."""
    h = size / 2
    c = np.asarray(center, np.float32)
    if normal_axis == "y":
        p = np.array([[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]], np.float32) + c
        n = np.tile([[0, 1, 0]], (4, 1)).astype(np.float32)
        idx = np.array([[0, 2, 1], [0, 3, 2]], np.int64)
    elif normal_axis == "z":
        p = np.array([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]], np.float32) + c
        n = np.tile([[0, 0, 1]], (4, 1)).astype(np.float32)
        idx = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    else:
        raise ValueError(normal_axis)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return p, n, uv, idx
