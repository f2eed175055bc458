"""Binary threaded BVH build and leaf-order triangle reorder (port of the
numpy parts of mc_path_tracer_tpu/ops/bvh.py).

Per-triangle world bounds -> the native C++ builder (csrc/bvh.cpp through
utils/native) or, where it cannot be built, the numpy median builder ->
threaded depth-first node arrays, the packed [N, 8] node table, and the
triangles reordered into leaf order with their packed shading rows.  All
host numpy; tensors move to the device once, at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mc_path_tracer_tpu_torch.ops.intersect import BVHArrays, TriangleSoA
from mc_path_tracer_tpu_torch.utils import native

_TRI_FIELDS = (
    "v0", "e1", "e2", "n0", "n1", "n2",
    "uv0", "uv1", "uv2", "material_id", "face_normal",
)


def triangle_bounds(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """World AABBs per triangle."""
    v1 = v0 + e1
    v2 = v0 + e2
    bmin = np.minimum(np.minimum(v0, v1), v2)
    bmax = np.maximum(np.maximum(v0, v1), v2)
    return bmin, bmax


def _numpy_build(bmin, bmax, max_leaf):
    """Median (EqualCounts) recursive builder in pure numpy: the fallback
    when the native library is unavailable."""
    n = bmin.shape[0]
    centroid = 0.5 * (bmin + bmax)
    nodes = []
    ordered: list[int] = []

    def build(idx: np.ndarray):
        me = len(nodes)
        nodes.append({"bmin": bmin[idx].min(axis=0), "bmax": bmax[idx].max(axis=0),
                      "first": 0, "count": 0, "size": 1})
        if idx.shape[0] <= max_leaf:
            nodes[me]["first"] = len(ordered)
            nodes[me]["count"] = idx.shape[0]
            ordered.extend(idx.tolist())
            return me
        c = centroid[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = idx.shape[0] // 2
        left = build(idx[order[:half]])
        right = build(idx[order[half:]])
        nodes[me]["size"] = 1 + nodes[left]["size"] + nodes[right]["size"]
        return me

    build(np.arange(n))
    out_bmin = np.stack([nd["bmin"] for nd in nodes]).astype(np.float32)
    out_bmax = np.stack([nd["bmax"] for nd in nodes]).astype(np.float32)
    first = np.array([nd["first"] for nd in nodes], np.int32)
    count = np.array([nd["count"] for nd in nodes], np.int32)
    skip = np.array([i + nd["size"] for i, nd in enumerate(nodes)], np.int32)
    return out_bmin, out_bmax, first, count, skip, np.array(ordered, np.int32)


def _pack_attrs(n0, n1, n2, uv0, uv1, uv2, material_id,
                tan0=None, tan1=None, tan2=None) -> np.ndarray:
    """Per-triangle shading attributes in one gatherable row [T, 16]
    (n0 n1 n2 | uv0 uv1 uv2 | material_id), [T, 28] with xyzw tangents."""
    cols = [n0, n1, n2, uv0, uv1, uv2, np.asarray(material_id)[:, None]]
    if tan0 is not None:
        cols += [tan0, tan1, tan2]
    return np.concatenate([np.asarray(c, np.float32) for c in cols], axis=1)


def _packed_nodes(nb_min, nb_max, first, count, skip) -> np.ndarray:
    """[N, 8] f32 node rows; meta and skip are int32 bit patterns."""
    meta = (first.astype(np.int32) * 16 + count.astype(np.int32)).view(np.float32)
    return np.concatenate(
        [
            nb_min.astype(np.float32),
            nb_max.astype(np.float32),
            meta[:, None],
            skip.astype(np.int32).view(np.float32)[:, None],
        ],
        axis=1,
    )


def build_bvh(tris: dict[str, np.ndarray], max_leaf: int = 4,
              method: int = native.SAH, device=DEFAULT_DEVICE):
    """Build the threaded BVH over host triangle arrays (keys of
    TriangleSoA, optional tan0..tan2) and reorder the triangles into leaf
    order.  Returns (BVHArrays, TriangleSoA, builder) on `device`, with
    builder "native" or "numpy"."""
    if max_leaf > 15:
        raise ValueError("packed node meta reserves 4 bits for the leaf count")
    device = resolve_device(device)
    v0 = np.asarray(tris["v0"], np.float32)
    e1 = np.asarray(tris["e1"], np.float32)
    e2 = np.asarray(tris["e2"], np.float32)
    bmin, bmax = triangle_bounds(v0, e1, e2)
    result = native.bvh_build_native(bmin, bmax, max_leaf=max_leaf, method=method)
    builder = "native"
    if result is None:
        result = _numpy_build(bmin, bmax, max_leaf)
        builder = "numpy"
    nb_min, nb_max, first, count, skip, order = result

    names = list(_TRI_FIELDS)
    if tris.get("tan0") is not None:
        names += ["tan0", "tan1", "tan2"]
    cols = {name: np.asarray(tris[name])[order] for name in names}
    attrs = _pack_attrs(
        cols["n0"], cols["n1"], cols["n2"],
        cols["uv0"], cols["uv1"], cols["uv2"], cols["material_id"],
        cols.get("tan0"), cols.get("tan1"), cols.get("tan2"),
    )
    geo = np.concatenate([cols["v0"], cols["e1"], cols["e2"]], axis=1)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    new_tris = TriangleSoA(
        **{k: dev(v) for k, v in cols.items()},
        attrs=dev(attrs),
        geo=dev(geo.astype(np.float32)),
    )
    bvh = BVHArrays(
        bmin=dev(nb_min), bmax=dev(nb_max), first=dev(first), count=dev(count),
        skip=dev(skip), packed=dev(_packed_nodes(nb_min, nb_max, first, count, skip)),
    )
    return bvh, new_tris, builder
