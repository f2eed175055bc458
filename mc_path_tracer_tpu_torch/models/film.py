"""Film: accumulated radiance and per-pixel sample counts, the progressive
tile schedule and the traversal tile order (port of
mc_path_tracer_tpu/models/film.py).  A Film is a snapshot: progressive
rendering yields a new one per step.  `to_uint8` and `save_png` of a film
on the card go through the tone-map kernel (ops/kernels/tonemap.py); a film
on the CPU through its plain version.  view="heatmap" selects the luminance
heat map (ops/tonemap.heatmap), plain torch on either device."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mc_path_tracer_tpu_torch.ops import tonemap
from mc_path_tracer_tpu_torch.ops.kernels import tonemap as tonemap_kernel
from mc_path_tracer_tpu_torch.utils.image import write_png

DEFAULT_TILE = 256  # progressive tile edge

class Film(NamedTuple):
    ld: torch.Tensor       # [H, W, 3] accumulated radiance
    samples: torch.Tensor  # [H, W] per-pixel sample counts

    @property
    def height(self) -> int:
        return self.ld.shape[0]

    @property
    def width(self) -> int:
        return self.ld.shape[1]

    def to_display(self, exposure: float = 1.0, view: str = "color") -> torch.Tensor:
        if view == "heatmap":
            return tonemap.heatmap(self.ld, self.samples, exposure)
        return tonemap.reinhard(self.ld, self.samples, exposure)

    def to_uint8(self, exposure: float = 1.0, view: str = "color") -> np.ndarray:
        """The display image in 8 bits: the colour view through the tone-map
        kernel (its plain version for a film on the CPU), the heat map in
        plain torch."""
        if view == "heatmap":
            return tonemap.quantize(self.to_display(exposure, view)).cpu().numpy()
        return tonemap_kernel.tonemap(
            self.ld.contiguous(), self.samples.contiguous(), exposure).cpu().numpy()

    def save_png(self, path: str, exposure: float = 1.0, view: str = "color") -> None:
        write_png(path, self.to_uint8(exposure, view))

    def radiance_mean(self) -> torch.Tensor:
        """Linear HDR image (Ld / samples)."""
        return self.ld / torch.clamp(self.samples, min=1.0)[..., None]


def make_film(width: int, height: int, device=DEFAULT_DEVICE) -> Film:
    device = resolve_device(device)
    return Film(ld=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
                samples=torch.zeros((height, width), dtype=torch.float32, device=device))


def tile_grid(width: int, height: int, tile: int = DEFAULT_TILE):
    """Round-robin progressive tile schedule: (x0, y0, w, h) covering the
    film row by row, edge tiles clipped."""
    for y0 in range(0, height, tile):
        for x0 in range(0, width, tile):
            yield (x0, y0, min(tile, width - x0), min(tile, height - y0))


# traversal-block tile shape: 32x16 = 512 pixels, so consecutive rays of a
# block cover a spatially tight frustum
TRAV_TILE_W = 32
TRAV_TILE_H = 16


def tile_order(width: int, height: int, tw: int = TRAV_TILE_W,
               th: int = TRAV_TILE_H):
    """Pixel enumeration in tile-major order (host numpy): (px, py) int32
    arrays of length width*height whose consecutive runs of tw*th pixels
    form one 2-D tile; edge tiles are clipped."""
    ty, tx = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
    xs, ys = [], []
    for y0 in range(0, height, th):
        for x0 in range(0, width, tw):
            x = x0 + tx
            y = y0 + ty
            keep = (x < width) & (y < height)
            xs.append(x[keep].ravel())
            ys.append(y[keep].ravel())
    return (
        np.concatenate(xs).astype(np.int32),
        np.concatenate(ys).astype(np.int32),
    )
