"""Per-vertex mesh attributes for `Scene.add_mesh` (the port's copy of
`_smooth_normals` and `compute_tangents` from mc_path_tracer_tpu/utils/gltf.py;
host numpy, identical arrays)."""

from __future__ import annotations

import numpy as np


def smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth normals (aiProcess_GenSmoothNormals equivalent)."""
    n = np.zeros_like(positions)
    tri = positions[indices]  # [F, 3, 3]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    for k in range(3):
        np.add.at(n, indices[:, k], fn)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


def compute_tangents(positions: np.ndarray, normals: np.ndarray,
                     uvs: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Per-vertex xyzw tangents from uv gradients
    (aiProcess_CalcTangentSpace equivalent).

    Accumulates the uv-gradient face tangent per vertex, Gram-Schmidts
    against the vertex normal, handedness w = sign(dot(cross(n, t), b)).
    Uv-less vertices keep a zero tangent; the hit shading then falls back
    to a normal-aligned frame (intersect._tangent_frame)."""
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    w0 = uvs[indices[:, 0]]
    w1 = uvs[indices[:, 1]]
    w2 = uvs[indices[:, 2]]
    e1, e2 = v1 - v0, v2 - v0
    du1, dv1 = w1[:, 0] - w0[:, 0], w1[:, 1] - w0[:, 1]
    du2, dv2 = w2[:, 0] - w0[:, 0], w2[:, 1] - w0[:, 1]
    det = du1 * dv2 - du2 * dv1
    ok = np.abs(det) > 1e-12
    r = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)[:, None]
    t_face = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r
    b_face = (e2 * du1[:, None] - e1 * du2[:, None]) * r
    t_acc = np.zeros_like(positions)
    b_acc = np.zeros_like(positions)
    for k in range(3):
        np.add.at(t_acc, indices[:, k], t_face)
        np.add.at(b_acc, indices[:, k], b_face)
    # Gram-Schmidt vs the vertex normal
    t_ortho = t_acc - normals * np.sum(normals * t_acc, axis=-1, keepdims=True)
    tl = np.linalg.norm(t_ortho, axis=-1, keepdims=True)
    t_unit = t_ortho / np.maximum(tl, 1e-20)
    hand = np.sign(np.sum(np.cross(normals, t_unit) * b_acc, axis=-1, keepdims=True))
    hand = np.where(hand == 0.0, 1.0, hand)
    t_unit = np.where(tl > 1e-12, t_unit, 0.0)
    return np.concatenate([t_unit, hand], axis=1).astype(np.float32)
