"""Dense intersection: the CUDA kernel's wrappers (`dense_closest`,
`dense_anyhit`), every ray against every triangle.

The kernel (csrc/dense.cu) replaces the TPU dense intersector,
mc_path_tracer_tpu/ops/pallas/intersect_kernel.py `_run` with
`_closest_kernel` / `_anyhit_kernel`.  Contract (the traversal's layouts,
ops/intersect.py):
  dense_closest(rays [R,8], geo [T,9]) -> (t [R] f32, tri_id [R] i32)
      ties to the lowest index; K_HUGE and -1 on a miss or a dead lane.
  dense_anyhit(rays, geo) -> occ [R] bool: some triangle hit with
      t <= t_max; False on a dead lane.

The kernel splits the triangles over slices of a second grid dimension;
dense_closest merges the slices' hits through a scratch of one 64-bit key
per ray, which the wrapper allocates.  Its plain versions are the
traversal's `closest_plain` / `anyhit_plain`, which are exactly this
function.  On CPU tensors the wrappers run them; on CUDA tensors they
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from mc_path_tracer_tpu_torch.ops.kernels import build, check_rows, launch
from mc_path_tracer_tpu_torch.ops.kernels.traversal import anyhit_plain, closest_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
# the C entry points of csrc/dense.cu: pointers and the stream as void*
ARGTYPES = {
    "mcpt_dense_closest": [_P, _I, _P, _I, _P, _P, _P, _P],
    "mcpt_dense_anyhit": [_P, _I, _P, _I, _P, _P],
}


def dense_closest(rays: torch.Tensor, geo: torch.Tensor):
    """Closest hit per ray over all triangles: (t [R] f32, tri_id [R] int32)."""
    check_rows(("rays", rays, 8), ("geo", geo, 9))
    if rays.device.type == "cpu":
        return closest_plain(rays, geo)
    r = rays.shape[0]
    t = torch.empty(r, dtype=torch.float32, device=rays.device)
    tri_id = torch.empty(r, dtype=torch.int32, device=rays.device)
    # one 64-bit (bits(t) << 32 | id) key per ray, merged across slices
    keys = torch.empty(r, dtype=torch.int64, device=rays.device)
    if r:
        lib = build.bind("dense", ARGTYPES)
        with torch.cuda.device(rays.device):
            stream = torch.cuda.current_stream().cuda_stream
            launch(lib.mcpt_dense_closest, "dense_closest", rays.data_ptr(), r,
                   geo.data_ptr(), geo.shape[0], keys.data_ptr(), t.data_ptr(),
                   tri_id.data_ptr(), stream)
    return t, tri_id


def dense_anyhit(rays: torch.Tensor, geo: torch.Tensor) -> torch.Tensor:
    """Occlusion per ray over all triangles: occ [R] bool (a hit with
    t <= t_max)."""
    check_rows(("rays", rays, 8), ("geo", geo, 9))
    if rays.device.type == "cpu":
        return anyhit_plain(rays, geo)
    r = rays.shape[0]
    occ = torch.empty(r, dtype=torch.bool, device=rays.device)
    if r:
        lib = build.bind("dense", ARGTYPES)
        with torch.cuda.device(rays.device):
            stream = torch.cuda.current_stream().cuda_stream
            launch(lib.mcpt_dense_anyhit, "dense_anyhit", rays.data_ptr(), r,
                   geo.data_ptr(), geo.shape[0], occ.data_ptr(), stream)
    return occ
