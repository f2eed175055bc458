"""Film checkpoints for progressive renders (port of the film half of
mc_path_tracer_tpu/utils/checkpoint.py).

The accumulator (radiance sums and per-pixel sample counts) and any scalar
or array metadata round-trip through one .npz in the JAX package's format
(keys `version`, `ld`, `samples`, `meta_<name>`), so a film saved by either
package loads in the other.  `save_params` / `load_params` wait for
gradients (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mc_path_tracer_tpu_torch.models.film import Film

FORMAT_VERSION = 1


def save_film(path: str, film: Film, meta: dict | None = None) -> None:
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        ld=film.ld.detach().cpu().numpy(),
        samples=film.samples.detach().cpu().numpy(),
        **{f"meta_{k}": v for k, v in (meta or {}).items()},
    )


def load_film(path: str, device=DEFAULT_DEVICE) -> tuple[Film, dict]:
    """(Film on `device`, metadata) from a checkpoint of either package."""
    device = resolve_device(device)
    data = np.load(path, allow_pickle=False)
    if int(data["version"]) != FORMAT_VERSION:
        raise ValueError(f"unsupported film checkpoint version {data['version']}")
    film = Film(ld=torch.from_numpy(np.asarray(data["ld"], np.float32)).to(device),
                samples=torch.from_numpy(np.asarray(data["samples"], np.float32)).to(device))
    meta = {
        k[len("meta_"):]: data[k].item() if data[k].shape == () else data[k]
        for k in data.files
        if k.startswith("meta_")
    }
    return film, meta
