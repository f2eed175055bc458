"""Film and parameter checkpoints (port of
mc_path_tracer_tpu/utils/checkpoint.py).

The accumulator of a progressive render (radiance sums and per-pixel sample
counts) and any scalar or array metadata round-trip through one .npz in the
JAX package's format (keys `version`, `ld`, `samples`, `meta_<name>`).  The
parameters of an optimisation, (MaterialGrads, directional ls, env tex) or
any nesting of tuples of tensors, are saved as `version`, `treedef` and
`leaf_<i>` in the order of `jax.tree.flatten` (depth first, fields in
order).  A checkpoint saved by either package loads in the other.
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


def _flatten(tree) -> list:
    """Leaves of nested tuples (NamedTuples included), depth first, as
    jax.tree.flatten orders them."""
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in _flatten(x)]
    return [tree]


def _describe(tree) -> str:
    if isinstance(tree, tuple):
        inner = ", ".join(_describe(x) for x in tree)
        return f"{type(tree).__name__}({inner})" if hasattr(tree, "_fields") else f"({inner})"
    return "*"


def _unflatten(like, leaves):
    if isinstance(like, tuple):
        items = [_unflatten(x, leaves) for x in like]
        return type(like)(*items) if hasattr(like, "_fields") else tuple(items)
    return next(leaves)


def save_params(path: str, params) -> None:
    """Save a tree of optimisable parameters (tensors or arrays in nested
    tuples) as flat npz arrays `leaf_<i>`.  `treedef` records the nesting
    as free text, e.g. "(MaterialGrads(*, *, *, *, *), *, *)": neither
    package's load_params reads it (each takes the structure from `like`),
    so it need not be the JAX PyTreeDef string."""
    leaves = _flatten(params)
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        treedef=_describe(params),
        **{f"leaf_{i}": (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
                         else np.asarray(leaf)) for i, leaf in enumerate(leaves)},
    )


def load_params(path: str, like):
    """Restore parameters into the structure of `like`: leaf i of the file
    becomes a tensor of like's leaf i dtype and device."""
    data = np.load(path, allow_pickle=False)
    if int(data["version"]) != FORMAT_VERSION:
        raise ValueError(f"unsupported params checkpoint version {data['version']}")
    like_leaves = _flatten(like)
    count = len([k for k in data.files if k.startswith("leaf_")])
    if count != len(like_leaves):
        raise ValueError(f"checkpoint holds {count} leaves, `like` has {len(like_leaves)}")
    leaves = [torch.as_tensor(data[f"leaf_{i}"]).to(dtype=ref.dtype, device=ref.device)
              for i, ref in enumerate(like_leaves)]
    return _unflatten(like, iter(leaves))
