"""Texture atlas: every material texture in one padded tensor (port of
mc_path_tracer_tpu/utils/texture.py).

All images are packed on the host into one [n, Hmax, Wmax, 3] float array
(per-texture true sizes kept) and moved to the device once; `sample_atlas`
fetches bilinearly with wrap addressing.  Factors multiply the fetch, as
glTF does.  An empty atlas is the factor-only path: sampling it returns the
neutral 1.0 without a gather.

Sampling is plain PyTorch on every device: the JAX package computes it in
XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device


class TextureAtlas(NamedTuple):
    data: torch.Tensor   # [n, Hmax, Wmax, 3] f32
    sizes: torch.Tensor  # [n, 2] int32 (h, w)

    @property
    def count(self) -> int:
        return self.data.shape[0]


def empty_atlas(device=DEFAULT_DEVICE) -> TextureAtlas:
    device = resolve_device(device)
    return TextureAtlas(data=torch.zeros((0, 1, 1, 3), dtype=torch.float32, device=device),
                        sizes=torch.zeros((0, 2), dtype=torch.int32, device=device))


def build_atlas(images: list[np.ndarray], device=DEFAULT_DEVICE) -> TextureAtlas:
    """Pack images (float [H, W, 3], already linear) into one atlas."""
    if not images:
        return empty_atlas(device)
    device = resolve_device(device)
    hmax = max(i.shape[0] for i in images)
    wmax = max(i.shape[1] for i in images)
    data = np.zeros((len(images), hmax, wmax, 3), np.float32)
    sizes = np.zeros((len(images), 2), np.int32)
    for k, img in enumerate(images):
        h, w = img.shape[0], img.shape[1]
        data[k, :h, :w] = img[..., :3]
        sizes[k] = (h, w)
    return TextureAtlas(data=torch.from_numpy(data).to(device),
                        sizes=torch.from_numpy(sizes).to(device))


def sample_atlas(atlas: TextureAtlas, tex_id: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear wrap-addressed fetch of texture `tex_id` [R] at `uv` [R, 2],
    [R, 3]; lanes with tex_id < 0 return 1.0 (the neutral multiplier)."""
    if atlas.count == 0:
        return torch.ones((*uv.shape[:-1], 3), dtype=torch.float32, device=uv.device)
    tid = torch.clamp(tex_id, min=0).long()
    hi = atlas.sizes[tid, 0]
    wi = atlas.sizes[tid, 1]
    x = uv[..., 0] * wi.float() - 0.5
    y = uv[..., 1] * hi.float() - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.int(), wi).long()
    x1i = torch.remainder(x0i + 1, wi)
    y0i = torch.remainder(y0.int(), hi).long()
    y1i = torch.remainder(y0i + 1, hi)
    t00 = atlas.data[tid, y0i, x0i]
    t01 = atlas.data[tid, y0i, x1i]
    t10 = atlas.data[tid, y1i, x0i]
    t11 = atlas.data[tid, y1i, x1i]
    out = (t00 * (1 - fx) * (1 - fy) + t01 * fx * (1 - fy)
           + t10 * (1 - fx) * fy + t11 * fx * fy)
    return torch.where((tex_id >= 0)[..., None], out, 1.0)
