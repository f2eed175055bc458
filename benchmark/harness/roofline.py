"""The card's published peaks and the operation and byte counts of the
program's hand-written kernels, computed from shapes.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the full 700 W power
limit; a run's card name and power limit stand beside every share.
"""

from __future__ import annotations

import re

H100_HBM_BYTES_PER_S = 3.35e12

RAY_ROW_BYTES = 32       # a ray row: o.xyz, d.xyz, live, t_max, f32
CLOSEST_OUT_BYTES = 8    # t f32 + tri_id i32
ANYHIT_OUT_BYTES = 1     # occ bool
TRIANGLE_BYTES = 36      # v0, e1, e2 f32


def traversal_bytes(rays_closest: int, rays_anyhit: int, dispatches: int,
                    triangles: int) -> int:
    """Least bytes the closest-hit and any-hit traversals move, whatever
    walks the tree: every nominal ray read once and answered once, and the
    scene's triangles read once per nominal dispatch.  Node tables and
    visits are not counted: they depend on the walk."""
    return (rays_closest * (RAY_ROW_BYTES + CLOSEST_OUT_BYTES)
            + rays_anyhit * (RAY_ROW_BYTES + ANYHIT_OUT_BYTES)
            + dispatches * triangles * TRIANGLE_BYTES)


def least_seconds_bytes(nbytes: int) -> float:
    return nbytes / H100_HBM_BYTES_PER_S


def kernel_named(name: str, kernel: str) -> bool:
    """Whether a profiler kernel name (demangled, perhaps with "void ", a
    namespace such as "(anonymous namespace)::" and its arguments) is the
    __global__ function `kernel`."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    head = re.split(r"[(<]", name, maxsplit=1)[0].strip()
    return head.rsplit("::", 1)[-1] == kernel
