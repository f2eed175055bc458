"""Vector-math conventions of the reference renderer, as batched torch ops
(port of mc_path_tracer_tpu/ops/math.py; same formulas, same constants).

All functions operate on tensors whose last axis is the vector axis and
broadcast over leading batch axes.  Three-component dot products are written
out left to right, so the CUDA kernel (compiled with --fmad=false) and the
plain versions round identically on the card.
"""

from __future__ import annotations

import math

import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device

K_EPSILON = 1e-6
K_HUGE = 1e32
PI = math.pi
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI
INV_2PI = 1.0 / TWO_PI
INV_4PI = 1.0 / (4.0 * PI)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last (3-wide) axis, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(v, v), min=0.0))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Normalize over the last axis; safe at ~zero length."""
    return v * torch.reciprocal(torch.sqrt(torch.clamp(dot(v, v), min=eps)))[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.cross's component formula."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """glm-style reflect: incident direction i about normal n."""
    return i - 2.0 * dot(n, i)[..., None] * n


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.601 luminance (jek::luminance)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=rgb.dtype, device=rgb.device)
    return torch.sum(rgb * w, dim=-1)


def mix(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return a * (1.0 - t) + b * t


def build_onb(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic branchless orthonormal basis around unit normal n
    (Duff et al. 2017); returns (tangent, bitangent)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def frame_to_world(local: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Map a local-frame vector (x=t, y=n, z=b; the reference's y-up frame)
    to world space around normal n."""
    t, b = build_onb(n)
    return normalize(
        t * local[..., 0:1] + n * local[..., 1:2] + b * local[..., 2:3]
    )


def equirect_uv(d: torch.Tensor) -> torch.Tensor:
    """Direction -> equirect uv (jek::sample_spherical_map)."""
    u = 0.5 + torch.atan2(d[..., 2], d[..., 0]) * INV_2PI
    v = 0.5 - torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) * INV_PI
    return torch.stack([u, v], dim=-1)


def equirect_dir(uv: torch.Tensor) -> torch.Tensor:
    """Equirect uv -> direction (jek::sample_spherical_direction)."""
    phi = TWO_PI * (uv[..., 0] - 0.5)
    theta = PI * uv[..., 1]
    st = torch.sin(theta)
    return torch.stack(
        [torch.cos(phi) * st, torch.cos(theta), torch.sin(phi) * st], dim=-1
    )


# ---------------------------------------------------------------------------
# 4x4 matrices (glm conventions), row-major; points transform as M @ [p, 1].
# ---------------------------------------------------------------------------


def perspective(fovy_rad: float, aspect: float, z_near: float, z_far: float,
                device=DEFAULT_DEVICE) -> torch.Tensor:
    """glm::perspective (right-handed, NDC z in [-1, 1])."""
    f = 1.0 / torch.tan(torch.tensor(fovy_rad / 2.0, dtype=torch.float32))
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (z_far + z_near) / (z_near - z_far)
    m[2, 3] = 2.0 * z_far * z_near / (z_near - z_far)
    m[3, 2] = -1.0
    return m.to(resolve_device(device))


def look_at(eye, center, up, device=DEFAULT_DEVICE) -> torch.Tensor:
    """glm::lookAt equivalent (view matrix, right-handed)."""
    eye = torch.as_tensor(eye, dtype=torch.float32)
    f = normalize(torch.as_tensor(center, dtype=torch.float32) - eye)
    s = normalize(cross(f, torch.as_tensor(up, dtype=torch.float32)))
    u = cross(s, f)
    m = torch.eye(4, dtype=torch.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -torch.dot(s, eye)
    m[1, 3] = -torch.dot(u, eye)
    m[2, 3] = torch.dot(f, eye)
    return m.to(resolve_device(device))


def transform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Homogeneous transform of points p [..., 3] by m [4, 4] with the
    w-divide, in full f32 (keep TF32 matmuls off on the card)."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    out = ph @ m.T
    return out[..., :3] / out[..., 3:4]


def transform_dir(m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Transform directions d [..., 3] by the linear part of m [4, 4]."""
    return d @ m[:3, :3].T
