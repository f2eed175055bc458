"""Perspective thin-lens camera (port of mc_path_tracer_tpu/models/camera.py).

  - ray generation by NDC unprojection: pixel center -> NDC (y flipped) ->
    unproject near (z=-1) and far (z=+1) through inv(proj @ view);
    origin = near point, direction = normalize(far - near).
  - thin lens when lens_radius > 0: focal point at focal_distance along the
    ray, concentric-disk lens sample mapped to world by inv(view).
  - projection = glm::perspective(fov, aspect, near, far).

The far-plane w is a fine cancellation (~1/z_far): the 4x4 products must run
in full f32, so callers on the card keep TF32 matmuls off.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mc_path_tracer_tpu_torch.ops.math import normalize
from mc_path_tracer_tpu_torch.ops.sampling import sample_concentric_disk


class CameraParams(NamedTuple):
    inv_view_proj: torch.Tensor   # [4, 4]
    inv_view: torch.Tensor        # [4, 4]
    lens_radius: torch.Tensor     # []
    focal_distance: torch.Tensor  # []


def gen_camera_rays(params: CameraParams, width: int, height: int,
                    px: torch.Tensor, py: torch.Tensor, lens_u: torch.Tensor):
    """dCamera::gen_ray, over pixels (px, py) with lens uniforms [R, 2]."""
    ndc_x = 2.0 * ((px + 0.5) / width) - 1.0
    ndc_y = 1.0 - 2.0 * ((py + 0.5) / height)
    ones = torch.ones_like(ndc_x)
    near_h = torch.stack([ndc_x, ndc_y, -ones, ones], dim=-1)
    far_h = torch.stack([ndc_x, ndc_y, ones, ones], dim=-1)
    near = near_h @ params.inv_view_proj.T
    far = far_h @ params.inv_view_proj.T
    origin = near[:, :3] / near[:, 3:4]
    direction = normalize(far[:, :3] / far[:, 3:4] - origin)

    p_focal = origin + direction * params.focal_distance
    lens = sample_concentric_disk(lens_u) * params.lens_radius
    lens_h = torch.cat(
        [lens, torch.zeros_like(lens[..., :1]), torch.ones_like(lens[..., :1])],
        dim=-1,
    )
    p_lens_h = lens_h @ params.inv_view.T
    p_lens = p_lens_h[:, :3] / p_lens_h[:, 3:4]
    use_lens = params.lens_radius > 0.0
    origin = torch.where(use_lens, p_lens, origin)
    direction = torch.where(use_lens, normalize(p_focal - origin), direction)
    return origin, direction


@dataclass
class PerspectiveCamera:
    position: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 5.0]))
    target: np.ndarray = field(default_factory=lambda: np.zeros(3))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    fov_deg: float = 60.0
    aspect: float = 1.0
    z_near: float = 0.1
    z_far: float = 1000.0
    lens_radius: float = 0.0
    focal_distance: float = 1.0
    exposure: float = 1.0

    def matrices(self):
        """View/projection matrices in host numpy f64 (glm lookAt /
        perspective conventions)."""
        eye = np.asarray(self.position, np.float64)
        f = np.asarray(self.target, np.float64) - eye
        f = f / np.linalg.norm(f)
        up = np.asarray(self.up, np.float64)
        s = np.cross(f, up)
        s = s / np.linalg.norm(s)
        u = np.cross(s, f)
        view = np.eye(4)
        view[0, :3] = s
        view[1, :3] = u
        view[2, :3] = -f
        view[0, 3] = -s @ eye
        view[1, 3] = -u @ eye
        view[2, 3] = f @ eye
        fov = float(np.deg2rad(self.fov_deg))
        t = 1.0 / np.tan(fov / 2.0)
        proj = np.zeros((4, 4))
        proj[0, 0] = t / self.aspect
        proj[1, 1] = t
        proj[2, 2] = (self.z_far + self.z_near) / (self.z_near - self.z_far)
        proj[2, 3] = 2.0 * self.z_far * self.z_near / (self.z_near - self.z_far)
        proj[3, 2] = -1.0
        return view, proj, proj @ view

    def params(self, device=DEFAULT_DEVICE) -> CameraParams:
        """CameraParams on `device`: f64 inverses on the host, then f32."""
        device = resolve_device(device)
        view, _, view_proj = self.matrices()
        inv_vp = np.linalg.inv(view_proj).astype(np.float32)
        inv_v = np.linalg.inv(view).astype(np.float32)
        return CameraParams(
            inv_view_proj=torch.from_numpy(inv_vp).to(device),
            inv_view=torch.from_numpy(inv_v).to(device),
            lens_radius=torch.tensor(self.lens_radius, dtype=torch.float32, device=device),
            focal_distance=torch.tensor(self.focal_distance, dtype=torch.float32,
                                        device=device),
        )
