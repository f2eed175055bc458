"""Binary threaded BVH build, its 4-wide collapse, and leaf-order triangle
reorder (port of the numpy parts of mc_path_tracer_tpu/ops/bvh.py).

Per-triangle world bounds -> the native C++ builder (csrc/bvh.cpp through
utils/native) or, where it cannot be built, the numpy median builder ->
threaded depth-first node arrays, the packed [N, 8] node table, the 4-wide
node table the traversal kernel walks (`collapse_wide`), and the triangles
reordered into leaf order with their packed shading rows.  All host numpy;
tensors move to the device once, at the end.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mc_path_tracer_tpu_torch.ops.intersect import TriangleSoA, _host, pack_bvh
from mc_path_tracer_tpu_torch.ops.wide_bvh import WideBVH
from mc_path_tracer_tpu_torch.utils import native
from mc_path_tracer_tpu_torch.utils.profiling import span, spanned

log = logging.getLogger(__name__)

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


# wide-table child boxes are padded outward by this fraction of the scene's
# largest absolute coordinate, so that a ray the triangle test finds never
# misses a box by f32 rounding (a zero-thickness box of a floor or a quad)
BOX_PAD = 2.0 ** -18
WIDE = 4                # children per wide node
WIDE_ROW = 32           # f32 slots per wide node row (128 bytes)
EMPTY_REF = -1          # ref of an unused child slot


def leaf_ref(first, count):
    """Wide-table ref of a leaf: ~(first * 16 + count), negative and never
    EMPTY_REF (count >= 1); inner nodes are refs >= 0."""
    return ~(np.asarray(first, np.int64) * 16 + np.asarray(count, np.int64))


def _pad_boxes(lo: np.ndarray, hi: np.ndarray, pad: np.float32):
    """Boxes grown outward by `pad` and by at least one ulp, in f32."""
    lo = lo.astype(np.float32)
    hi = hi.astype(np.float32)
    lo_p = np.minimum(lo - pad, np.nextafter(lo, np.float32(-np.inf)))
    hi_p = np.maximum(hi + pad, np.nextafter(hi, np.float32(np.inf)))
    return lo_p, hi_p


@spanned("mcpt::scene.collapse", keep=True)
def collapse_wide(nb_min, nb_max, first, count, skip):
    """Collapse the binary threaded tree into 4-wide nodes; returns the
    [W, 32] f32 table and the tree's depth (wide nodes on the longest
    root-to-leaf path).

    Each wide node starts from a binary inner node's two children and opens
    the child of largest surface area that is an inner node, twice, so it
    holds up to four children in the binary tree's depth-first order.
    Leaves stay the binary leaves (same first/count, same leaf order).
    Nodes are numbered level by level from the root (row 0).  Row layout,
    one 128-byte row per node read as eight float4:
      [0:4] lo.x  [4:8] hi.x  [8:12] lo.y  [12:16] hi.y  [16:20] lo.z
      [20:24] hi.z of the four children (boxes padded by BOX_PAD),
      [24:28] child refs as int32 bits (inner node row >= 0, leaf_ref < -1,
      EMPTY_REF), [28:32] zero."""
    n = count.shape[0]
    first = np.asarray(first, np.int64)
    count = np.asarray(count, np.int64)
    if n and (count.max() > 15 or (first * 16 + count).max() >= 2**31):
        raise ValueError("leaf refs hold first * 16 + count in int32, count <= 15")
    inner = count == 0
    left = np.arange(n) + 1
    right = np.where(inner, skip[np.minimum(left, n - 1)], -1)
    ext = np.maximum(nb_max - nb_min, 0.0).astype(np.float64)
    area = np.where(inner, ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                    + ext[:, 2] * ext[:, 0], -1.0)
    scale = max(float(np.abs(nb_min[:1]).max(initial=0.0)),
                float(np.abs(nb_max[:1]).max(initial=0.0)))
    lo_all, hi_all = _pad_boxes(nb_min, nb_max, np.float32(scale * BOX_PAD))

    cols = np.arange(WIDE)
    levels = []   # per level: binary children [m, 4] of its wide nodes
    frontier = np.zeros(1, np.int64)
    while frontier.size:
        m = frontier.size
        kids = np.full((m, WIDE), -1, np.int64)
        f_inner = inner[frontier]
        kids[f_inner, 0] = left[frontier[f_inner]]
        kids[f_inner, 1] = right[frontier[f_inner]]
        kids[~f_inner, 0] = frontier[~f_inner]        # a root that is a leaf
        for _ in range(WIDE - 2):
            a = np.where(kids >= 0, area[np.maximum(kids, 0)], -1.0)
            pos = a.argmax(axis=1)
            grow = a.max(axis=1) >= 0.0
            c = kids[np.arange(m), pos]
            p = pos[:, None]
            opened = np.take_along_axis(kids, np.clip(np.where(cols < p, cols, cols - 1),
                                                      0, WIDE - 1), axis=1)
            opened = np.where(cols == p, left[c][:, None], opened)
            opened = np.where(cols == p + 1, right[c][:, None], opened)
            kids = np.where(grow[:, None], opened, kids)
        levels.append(kids)
        frontier = kids[(kids >= 0) & inner[np.maximum(kids, 0)]]

    rows, offset = [], 1
    for kids in levels:
        valid = kids >= 0
        k = np.maximum(kids, 0)
        is_inner = valid & inner[k]
        refs = np.where(is_inner, 0, np.where(valid, leaf_ref(first[k], count[k]), EMPTY_REF))
        refs[is_inner] = offset + np.arange(int(is_inner.sum()))
        offset += int(is_inner.sum())
        lo = np.where(valid[..., None], lo_all[k], 0.0)
        hi = np.where(valid[..., None], hi_all[k], 0.0)
        row = np.zeros((kids.shape[0], WIDE_ROW), np.float32)
        for axis in range(3):
            row[:, 8 * axis:8 * axis + 4] = lo[..., axis]
            row[:, 8 * axis + 4:8 * axis + 8] = hi[..., axis]
        row[:, 24:28] = refs.astype(np.int32).view(np.float32)
        rows.append(row)
    return np.concatenate(rows), len(levels)


def build_bvh(tris, max_leaf: int = 4, method: int = native.SAH, device=DEFAULT_DEVICE):
    """Build the threaded BVH over host triangle arrays (a dict with the
    keys of TriangleSoA and optional tan0..tan2, or a TriangleSoA) and
    reorder the triangles into leaf order.  Returns (BVHArrays,
    TriangleSoA, builder) on `device`, with builder "native" or "numpy";
    the BVH carries both the binary table (`packed`) and its 4-wide
    collapse (`wide`, `wide_depth`)."""
    if max_leaf > 15:
        raise ValueError("packed node meta reserves 4 bits for the leaf count")
    device = resolve_device(device)
    if isinstance(tris, TriangleSoA):
        tris = {k: _host(v) for k, v in tris._asdict().items() if v is not None}
    v0 = np.asarray(tris["v0"], np.float32)
    e1 = np.asarray(tris["e1"], np.float32)
    e2 = np.asarray(tris["e2"], np.float32)
    bmin, bmax = triangle_bounds(v0, e1, e2)
    with span("mcpt::scene.bvh", keep=True):
        result = native.bvh_build_native(bmin, bmax, max_leaf=max_leaf, method=method)
        builder = "native"
        if result is None:
            # kept for parity with the JAX package, which falls back the same way
            log.warning("native BVH builder unavailable (%s did not build or load): "
                        "%d triangles go to the numpy median builder, whatever `method`",
                        native.library_path().name, v0.shape[0])
            result = _numpy_build(bmin, bmax, max_leaf)
            builder = "numpy"
    log.info("BVH over %d triangles built by the %s builder (method %d, max_leaf %d)",
             v0.shape[0], builder, method, max_leaf)
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

    with span("mcpt::scene.upload", keep=True):
        new_tris = TriangleSoA(
            **{k: dev(v) for k, v in cols.items()},
            attrs=dev(attrs),
            geo=dev(geo.astype(np.float32)),
        )
    return pack_bvh(nb_min, nb_max, first, count, skip, device), new_tris, builder


def build_accel(tris, max_leaf: int = 4, method: int = native.SAH, device=DEFAULT_DEVICE):
    """The JAX package's full accelerator build: (bvh, wide,
    reordered_tris), where `wide` is ops/wide_bvh's WideBVH over the same
    tree (its 4-wide table and the leaf-order geometry) rather than the
    TPU's 16-wide row table."""
    bvh, new_tris, _ = build_bvh(tris, max_leaf, method, device)
    return bvh, WideBVH(bvh, new_tris.geo), new_tris
