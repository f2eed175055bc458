"""Ray-triangle intersection contract and hit shading (port of
mc_path_tracer_tpu/ops/intersect.py).

  - Moller-Trumbore with backface culling: det < K_EPSILON or t < 0 is a
    miss (Triangle.cu TEST_CULL path).
  - Barycentric attributes u*a1 + v*a2 + (1-u-v)*a0.
  - The binary BVH is threaded (skip-link) and depth-first: node i hit ->
    i+1, miss or leaf done -> skip; leaves own contiguous triangle ranges of
    the leaf-order triangle arrays.  The traversal kernel walks its 4-wide
    collapse (ops/bvh.collapse_wide), which keeps the same leaves.

Traversal itself lives in ops/kernels/traversal.py: the CUDA kernel and
its plain (brute-force) version share the packed contract below.
`intersect_bvh` / `occluded_bvh` (the JAX package's BVH routes, which the
integrator's traversal dispatches and ops/wide_bvh share) launch that
kernel on CUDA tensors; the JAX package's XLA walk (`_traverse`) is not
ported.
  rays   [R, 8] f32: o.xyz, d.xyz, live (> 0.5), t_max
  packed [N, 8] f32: bmin, bmax, bitcast(first*16 + count), bitcast(skip)
  wide   [W, 32] f32: per node the SoA boxes of 4 children and their refs
         (layout in ops/bvh.collapse_wide)
  geo    [T, 9] f32: v0, e1, e2 in leaf order
Every intersection is outside autograd: geometry is not differentiated.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mc_path_tracer_tpu_torch.ops.math import (
    K_EPSILON,
    K_HUGE,
    build_onb,
    cross,
    dot,
    normalize,
)
from mc_path_tracer_tpu_torch.utils.profiling import span, spanned


class TriangleSoA(NamedTuple):
    """Flat world-space triangle arrays."""

    v0: torch.Tensor          # [T, 3]
    e1: torch.Tensor          # [T, 3] v1 - v0
    e2: torch.Tensor          # [T, 3] v2 - v0
    n0: torch.Tensor          # [T, 3] shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor         # [T, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    material_id: torch.Tensor  # [T] int32
    face_normal: torch.Tensor  # [T, 3]
    # packed shading rows [T, 16] (n0 n1 n2 uv0 uv1 uv2 mat) or [T, 28]
    # with xyzw tangents (tan0 tan1 tan2); built by the BVH reorder
    attrs: torch.Tensor | None = None
    tan0: torch.Tensor | None = None  # [T, 4] xyz tangent + w handedness
    tan1: torch.Tensor | None = None
    tan2: torch.Tensor | None = None
    # traversal geometry [T, 9] (v0 e1 e2), built by the BVH reorder
    geo: torch.Tensor | None = None

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]


class BVHArrays(NamedTuple):
    """Threaded (skip-link) BVH in depth-first order, its [N, 8] node table
    `packed` (the JAX package's), and the 4-wide table `wide` the traversal
    kernel walks, with its depth (see module docstring)."""

    bmin: torch.Tensor   # [N, 3] f32
    bmax: torch.Tensor   # [N, 3] f32
    first: torch.Tensor  # [N] int32
    count: torch.Tensor  # [N] int32 (0 for inner nodes)
    skip: torch.Tensor   # [N] int32
    packed: torch.Tensor  # [N, 8] f32
    wide: torch.Tensor   # [W, 32] f32
    wide_depth: int      # wide nodes on the longest root-to-leaf path

    @property
    def num_nodes(self) -> int:
        return self.bmin.shape[0]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pack_bvh(bmin, bmax, first, count, skip, device=None) -> BVHArrays:
    """BVHArrays from the threaded depth-first node arrays (numpy or
    tensors): the JAX package's [N, 8] node table and its 4-wide collapse
    (ops/bvh.collapse_wide), which the traversal kernel walks.  Requires
    count < 16.  On `device`: by default the inputs' device where they are
    tensors, else the card."""
    from mc_path_tracer_tpu_torch.ops.bvh import _packed_nodes, collapse_wide

    if device is None:
        device = bmin.device if isinstance(bmin, torch.Tensor) else DEFAULT_DEVICE
    device = resolve_device(device)
    nb_min, nb_max = (_host(x).astype(np.float32) for x in (bmin, bmax))
    first, count, skip = (_host(x).astype(np.int32) for x in (first, count, skip))
    wide, depth = collapse_wide(nb_min, nb_max, first, count, skip)
    packed = _packed_nodes(nb_min, nb_max, first, count, skip)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    with span("mcpt::scene.upload", keep=True):
        return BVHArrays(
            bmin=dev(nb_min), bmax=dev(nb_max), first=dev(first), count=dev(count),
            skip=dev(skip), packed=dev(packed), wide=dev(wide), wide_depth=depth,
        )


class Hit(NamedTuple):
    """Intersection record (reference Isect)."""

    hit: torch.Tensor          # [R] bool
    t: torch.Tensor            # [R]
    tri_id: torch.Tensor       # [R] int32 (-1 on miss)
    position: torch.Tensor     # [R, 3]
    normal: torch.Tensor       # [R, 3] interpolated shading normal
    uv: torch.Tensor           # [R, 2]
    material_id: torch.Tensor  # [R] int64
    tangent: torch.Tensor      # [R, 3]
    bitangent: torch.Tensor    # [R, 3]


def moller_trumbore(ray_o, ray_d, v0, e1, e2):
    """Batched Moller-Trumbore with backface culling; inputs broadcast.
    Returns (valid, t, u, v).  The operation order is the JAX package's and
    the CUDA kernel's."""
    pvec = cross(ray_d, e2)
    det = dot(e1, pvec)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, 1.0)
    tvec = ray_o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(ray_d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (
        (det >= K_EPSILON)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= 0.0)
    )
    return valid, t, u, v


# csrc/mt.cuh kUSlack, kUFloor: a u numerator above det * U_SLACK proves
# u > 1, one below -det * U_FLOOR proves u < 0
U_SLACK = 1.0 + 2.0**-20
U_FLOOR = 2.0**-100


def early_exits(ray_o, ray_d, v0, e1, e2):
    """Where csrc/mt.cuh's test stops before the division; inputs
    broadcast.  Returns (det_exit, u_exit, det, tvec, u_num): det_exit
    where !(det >= K_EPSILON) (back-facing, grazing, NaN), u_exit where the
    test passes the det split and its u numerator proves u < 0 or u > 1."""
    pvec = cross(ray_d, e2)
    det = dot(e1, pvec)
    tvec = ray_o - v0
    u_num = dot(tvec, pvec)
    det_exit = ~(det >= K_EPSILON)
    u_exit = ~det_exit & ((u_num < -det * U_FLOOR) | (u_num > det * U_SLACK))
    return det_exit, u_exit, det, tvec, u_num


def winner_uvt(tris: TriangleSoA, tri_id, ray_o, ray_d):
    """Exact Moller-Trumbore on each ray's known winning triangle: one row
    gather + MT.  Miss lanes (tri_id < 0) read triangle 0; the caller
    sanitizes them."""
    idx = torch.clamp(tri_id, min=0).long()
    _, t, u, v = moller_trumbore(ray_o, ray_d, tris.v0[idx], tris.e1[idx], tris.e2[idx])
    return u, v, t


def _tangent_frame(n, tan4):
    """Orthonormal shading frame from an interpolated xyzw tangent:
    Gram-Schmidt against n, bitangent = (n x t) * w."""
    t_raw = tan4[..., 0:3]
    t_ortho = t_raw - n * dot(n, t_raw)[..., None]
    bad = dot(t_ortho, t_ortho)[..., None] < 1e-12
    t_fb, _ = build_onb(n)
    t_vec = normalize(torch.where(bad, t_fb, t_ortho))
    b_vec = cross(n, t_vec) * tan4[..., 3:4]
    return t_vec, b_vec


def _shade_attrs(tris: TriangleSoA, tri_id, u, v, ray_o, ray_d, t, hit) -> Hit:
    """Interpolate hit attributes from the packed `attrs` rows with the
    barycentric convention u*a1 + v*a2 + (1-u-v)*a0."""
    tid = torch.clamp(tri_id, min=0).long()
    w = (1.0 - u - v)[..., None]
    uu, vv = u[..., None], v[..., None]
    a = tris.attrs[tid]                    # one wide row gather
    n = normalize(uu * a[..., 3:6] + vv * a[..., 6:9] + w * a[..., 0:3])
    uv = uu * a[..., 11:13] + vv * a[..., 13:15] + w * a[..., 9:11]
    mat = torch.where(hit, a[..., 15].to(torch.int64), 0)
    if a.shape[-1] >= 28:
        tan4 = uu * a[..., 20:24] + vv * a[..., 24:28] + w * a[..., 16:20]
        t_vec, b_vec = _tangent_frame(n, tan4)
    else:
        t_vec, b_vec = build_onb(n)
    pos = ray_o + t[..., None] * ray_d
    return Hit(
        hit=hit,
        t=t,
        tri_id=torch.where(hit, tri_id, -1),
        position=pos,
        normal=n,
        uv=uv,
        material_id=mat,
        tangent=t_vec,
        bitangent=b_vec,
    )


def pack_rays(ray_o, ray_d, mask=None, t_max=None) -> torch.Tensor:
    """Rays as the traversal's [R, 8] rows: o.xyz, d.xyz, live, t_max
    (live = 1 and t_max = 1e32 where not given)."""
    r = ray_o.shape[0]
    live = (
        torch.ones(r, dtype=torch.float32, device=ray_o.device)
        if mask is None else mask.to(torch.float32)
    )
    tm = (
        torch.full((r,), K_HUGE, dtype=torch.float32, device=ray_o.device)
        if t_max is None else t_max.to(torch.float32)
    )
    return torch.cat([ray_o, ray_d, live[:, None], tm[:, None]], dim=1).to(torch.float32)


@spanned("mcpt::finish_closest")
def finish_closest(tris: TriangleSoA, tri_id, ray_o, ray_d) -> Hit:
    """Hit record from a traversal's winning tri_id: recompute the winner's
    exact (u, v, t), sanitize misses to u = v = 0 and t = K_HUGE (dead-lane
    origins near 1e32 would otherwise give NaN normals that reach the next
    bounce's origins), then shade."""
    hit = tri_id >= 0
    u, v, t_exact = winner_uvt(tris, tri_id, ray_o, ray_d)
    u = torch.where(hit, u, 0.0)
    v = torch.where(hit, v, 0.0)
    t = torch.where(hit, t_exact, K_HUGE)
    return _shade_attrs(tris, tri_id, u, v, ray_o, ray_d, t, hit)


def intersect_brute(tris: TriangleSoA, ray_o: torch.Tensor, ray_d: torch.Tensor) -> Hit:
    """Closest hit of rays [R, 3] against all triangles: the "brute"
    route's plain version (ties to the lowest index), shaded as a
    traversal's winner is (finish_closest).  Needs the leaf-order `geo`
    rows of a built scene."""
    # imported here: ops.kernels.traversal imports this module
    from mc_path_tracer_tpu_torch.ops.kernels.traversal import closest_plain

    _, tri_id = closest_plain(pack_rays(ray_o, ray_d), tris.geo)
    return finish_closest(tris, tri_id, ray_o, ray_d)


def occluded_brute(tris: TriangleSoA, ray_o: torch.Tensor, ray_d: torch.Tensor,
                   t_max: torch.Tensor | None = None) -> torch.Tensor:
    """Any-hit [R] bool: some triangle hit with t <= t_max (unbounded when
    t_max is None), the "brute" route's plain version."""
    from mc_path_tracer_tpu_torch.ops.kernels.traversal import anyhit_plain

    return anyhit_plain(pack_rays(ray_o, ray_d, t_max=t_max), tris.geo)


def _unsorted(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x of sorted lanes back in caller order: one scatter."""
    out = torch.empty_like(x)
    out[perm] = x
    return out


def _trace(bvh: BVHArrays, geo: torch.Tensor, ray_o, ray_d, any_hit: bool,
           mask=None, t_max=None, sort: bool = False) -> torch.Tensor:
    """The traversal kernel (ops/kernels/traversal) on the rays: the
    closest hits' tri_id [R] int32, or occ [R] bool.  With `sort` the
    kernel runs over the lanes sorted by direction octant, dead lanes last
    (traversal.sort_perm), and the results return in caller order."""
    from mc_path_tracer_tpu_torch.ops.kernels import traversal

    rays = pack_rays(ray_o, ray_d, mask, t_max)
    trace = traversal.trace_anyhit if any_hit else traversal.trace_closest
    perm = traversal.sort_perm(ray_d, mask) if sort else None
    out = trace(rays if perm is None else rays[perm], bvh, geo)
    out = out if any_hit else out[1]
    return out if perm is None else _unsorted(out, perm)


def intersect_bvh(bvh: BVHArrays, tris: TriangleSoA, ray_o: torch.Tensor,
                  ray_d: torch.Tensor, max_leaf_prims: int = 4, mask=None, *,
                  sort: bool = False) -> Hit:
    """Closest hit per ray through the traversal kernel, shaded
    (finish_closest).  `max_leaf_prims` is for JAX parity only: the kernel
    reads each leaf's own triangle count.  `sort`: octant-sorted lanes
    (RenderConfig.sort_rays); the hits do not change."""
    tri_id = _trace(bvh, tris.geo, ray_o, ray_d, False, mask=mask, sort=sort)
    return finish_closest(tris, tri_id, ray_o, ray_d)


def occluded_bvh(bvh: BVHArrays, tris: TriangleSoA, ray_o: torch.Tensor,
                 ray_d: torch.Tensor, max_leaf_prims: int = 4, mask=None, t_max=None, *,
                 sort: bool = False) -> torch.Tensor:
    """Any-hit [R] bool through the traversal kernel: some triangle hit
    with t <= t_max (unbounded when None); False on masked lanes."""
    return _trace(bvh, tris.geo, ray_o, ray_d, True, mask=mask, t_max=t_max, sort=sort)
