"""BVH traversal: the CUDA kernel's wrappers (`trace_closest`,
`trace_anyhit`) and their plain PyTorch versions (`closest_plain`,
`anyhit_plain`).

The kernel (csrc/traversal.cu) replaces the TPU arena traversal kernel,
mc_path_tracer_tpu/ops/pallas/traversal_kernel.py `_make_arena_kernel`.
Contract (see ops/intersect.py for the layouts):
  trace_closest(rays [R,8], nodes [N,8], geo [T,9]) -> (t [R] f32, tri_id [R] i32)
      K_HUGE and -1 on a miss or a dead lane.
  trace_anyhit(rays, nodes, geo) -> occ [R] bool: some triangle hit with
      t <= t_max; False on a dead lane.

The plain versions are the dense kernel's (ops/kernels/dense.py) too: they
are all rays x all triangles with lowest-index ties.  A wrapper runs the
plain version only because its tensors lie on the CPU; on a CUDA tensor it
launches the kernel or raises.  LAUNCHES (ops/kernels) counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from mc_path_tracer_tpu_torch.ops import intersect
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES, build, check_rows, launch
from mc_path_tracer_tpu_torch.ops.math import K_HUGE

# ray x triangle pairs per chunk of the plain versions: bounds their
# [chunk, T] temporaries (~64 MB each) instead of materializing R x T
PLAIN_PAIRS = 1 << 24

_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    lib, _ = build.load("traversal")
    if not getattr(lib, "_mcpt_bound", False):
        lib.mcpt_closest.argtypes = [_P, _I, _P, _I, _P, _I, _P, _P, _P]
        lib.mcpt_closest.restype = _I
        lib.mcpt_anyhit.argtypes = [_P, _I, _P, _I, _P, _I, _P, _P]
        lib.mcpt_anyhit.restype = _I
        lib._mcpt_bound = True
    return lib


def trace_closest(rays: torch.Tensor, nodes: torch.Tensor, geo: torch.Tensor):
    """Closest hit per ray: (t [R] f32, tri_id [R] int32)."""
    check_rows(("rays", rays, 8), ("nodes", nodes, 8), ("geo", geo, 9))
    if rays.device.type == "cpu":
        return closest_plain(rays, geo)
    r = rays.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=rays.device)
    tri_id = torch.empty(r, dtype=torch.int32, device=rays.device)
    if r:
        lib = _library()
        with torch.cuda.device(rays.device):
            stream = torch.cuda.current_stream().cuda_stream
            launch(lib.mcpt_closest, "closest", rays.data_ptr(), r,
                   nodes.data_ptr(), nodes.shape[0], geo.data_ptr(), geo.shape[0],
                   t.data_ptr(), tri_id.data_ptr(), stream)
    return t, tri_id


def trace_anyhit(rays: torch.Tensor, nodes: torch.Tensor, geo: torch.Tensor):
    """Occlusion per ray: occ [R] bool (a hit with t <= t_max)."""
    check_rows(("rays", rays, 8), ("nodes", nodes, 8), ("geo", geo, 9))
    if rays.device.type == "cpu":
        return anyhit_plain(rays, geo)
    r = rays.shape[0]
    occ = torch.empty(r, dtype=torch.bool, device=rays.device)
    if r:
        lib = _library()
        with torch.cuda.device(rays.device):
            stream = torch.cuda.current_stream().cuda_stream
            launch(lib.mcpt_anyhit, "anyhit", rays.data_ptr(), r,
                   nodes.data_ptr(), nodes.shape[0], geo.data_ptr(), geo.shape[0],
                   occ.data_ptr(), stream)
    return occ


def _chunks(rays: torch.Tensor, geo: torch.Tensor):
    """Ray slices of the plain versions, each tested against all
    triangles: (start, end, valid [c, T], t [c, T])."""
    step = max(1, PLAIN_PAIRS // max(geo.shape[0], 1))
    v0, e1, e2 = geo[None, :, 0:3], geo[None, :, 3:6], geo[None, :, 6:9]
    for s in range(0, rays.shape[0], step):
        c = rays[s : s + step]
        valid, t, _, _ = intersect.moller_trumbore(
            c[:, None, 0:3], c[:, None, 3:6], v0, e1, e2
        )
        yield s, s + c.shape[0], valid, t


def closest_plain(rays: torch.Tensor, geo: torch.Tensor):
    """Brute-force closest hit: every ray against every triangle
    (intersect_brute's argmin, so ties go to the lowest index), honouring
    the live column."""
    LAUNCHES["plain"] += 1
    r = rays.shape[0]
    t_out = torch.full((r,), K_HUGE, dtype=torch.float32, device=rays.device)
    id_out = torch.full((r,), -1, dtype=torch.int32, device=rays.device)
    live = rays[:, 6] > 0.5
    for s, e, valid, t in _chunks(rays, geo):
        t_masked = torch.where(valid, t, K_HUGE)
        best = torch.argmin(t_masked, dim=-1)
        t_best = t_masked.gather(-1, best[:, None])[:, 0]
        hit = (t_best < K_HUGE) & live[s:e]
        t_out[s:e] = torch.where(hit, t_best, K_HUGE)
        id_out[s:e] = torch.where(hit, best.to(torch.int32), -1)
    return t_out, id_out


def anyhit_plain(rays: torch.Tensor, geo: torch.Tensor) -> torch.Tensor:
    """Brute-force occlusion: some triangle hit with t <= t_max, on live
    lanes (occluded_brute plus the live column)."""
    LAUNCHES["plain"] += 1
    occ = torch.zeros(rays.shape[0], dtype=torch.bool, device=rays.device)
    live = rays[:, 6] > 0.5
    for s, e, valid, t in _chunks(rays, geo):
        blocked = (valid & (t <= rays[s:e, 7:8])).any(dim=-1)
        occ[s:e] = blocked & live[s:e]
    return occ
