"""The wide-BVH routes (port of mc_path_tracer_tpu/ops/wide_bvh.py's public
names): the JAX module's contract, not its TPU layout.

The JAX module builds a 16-ary row table with 128 triangles inline per
leaf row, component-major [10, 128] rows that the TPU's lane width forced,
and walks it with an XLA trail-stack loop and straggler rescue.  Here
`WideBVH` is the scene's BVHArrays, whose 4-wide table
(ops/bvh.collapse_wide, the binary tree's leaves kept) is what the
traversal kernel (csrc/traversal.cu) walks, plus the leaf-order triangle
geometry that any-hit needs without the rest of the triangles.
`intersect_wide` / `occluded_wide` give the JAX outputs and launch that
kernel on CUDA tensors; on CPU tensors the kernel's wrapper runs its plain
version.  The XLA walk (`_traverse_wide`, `_run_phase`, the rescue seeds)
is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mc_path_tracer_tpu_torch.ops.intersect import (
    BVHArrays,
    Hit,
    TriangleSoA,
    _host,
    _trace,
    finish_closest,
    pack_bvh,
)

# the JAX module's TPU row layout, kept as names that document it: N_COMP
# component rows of LANES lanes, BRANCHING children per inner row,
# LEAF_TRIS triangles inline per leaf row.  The Hopper table is 4-wide.
N_COMP = 10
LANES = 128
BRANCHING = 16
LEAF_TRIS = LANES


@dataclass(frozen=True)
class WideBVH:
    """The tree the traversal kernel walks: `bvh` (its `wide` table and
    `wide_depth`) and `geo` [T, 9] (v0, e1, e2 in leaf order)."""

    bvh: BVHArrays
    geo: torch.Tensor

    @property
    def rows(self) -> torch.Tensor:
        """The 4-wide node table [W, 32] (the JAX field's name)."""
        return self.bvh.wide

    @property
    def depth(self) -> int:
        return self.bvh.wide_depth

    @property
    def num_rows(self) -> int:
        return self.bvh.wide.shape[0]


def build_wide(bmin, bmax, first, count, skip, tri_v0, tri_e1, tri_e2,
               branching: int = BRANCHING, leaf_tris: int = LEAF_TRIS,
               device=None) -> WideBVH:
    """The JAX build_wide's inputs (a threaded binary BVH's depth-first
    arrays and the leaf-order triangles, numpy or tensors) as the port's
    tree: pack_bvh's tables and the [T, 9] geometry, on `device` (by
    default the inputs' device where they are tensors, else the card).
    `branching` and `leaf_tris` shape the TPU's rows only: JAX parity,
    no effect."""
    bvh = pack_bvh(bmin, bmax, first, count, skip, device=device)
    geo = np.concatenate([_host(x).astype(np.float32) for x in (tri_v0, tri_e1, tri_e2)],
                         axis=1)
    return WideBVH(bvh, torch.from_numpy(geo).to(bvh.wide.device))


def intersect_wide(wide: WideBVH, tris: TriangleSoA, ray_o: torch.Tensor,
                   ray_d: torch.Tensor, mask=None) -> Hit:
    """Closest hit per ray through the traversal kernel, shaded from
    `tris` (the leaf-order triangles the tree was built over)."""
    tri_id = _trace(wide.bvh, wide.geo, ray_o, ray_d, False, mask=mask)
    return finish_closest(tris, tri_id, ray_o, ray_d)


def occluded_wide(wide: WideBVH, ray_o: torch.Tensor, ray_d: torch.Tensor,
                  mask=None, t_max=None) -> torch.Tensor:
    """Any-hit [R] bool through the traversal kernel: some triangle hit
    with t <= t_max (unbounded when None); False on masked lanes."""
    return _trace(wide.bvh, wide.geo, ray_o, ray_d, True, mask=mask, t_max=t_max)
